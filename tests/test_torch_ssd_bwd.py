"""The SSD scan's backward (``kernels/mamba2_ssd``: ``ssd_backward``, the
``ssd`` autograd Function, and the algorithm of ``csrc/ssd.cu``'s
``ssd_bwd``) against ``jax.vjp`` of the JAX package's scan, on the CPU.

- ``ssd_backward``'s CPU path (autograd through the plain version)
  against ``jax.vjp`` of ``repro.kernels.mamba2_ssd.ref.ssd_ref`` in
  float32: each gradient within 1e-5 of its largest magnitude (the same
  recurrence; the sums run in another order).
- The kernel cannot run here, so a model of its chunked algorithm
  (:func:`kernel_model`: 64-token chunks, the states at chunk starts from
  the forward's recurrence, the reverse carry of the gradient G, the
  decays from sums that start at each key's 8-token tile, ``dlogd``'s
  pair term as nested sums of W (each row j's suffix over the keys k >=
  i, then each column's sum over the rows j < i, 16-row tiles in order),
  dB and dC summed over heads and state-row blocks in the kernel's order)
  is held against ``jax.vjp`` in float64 at 1e-10, and, with every
  product in float32 as the kernel's 3xTF32 (:func:`_mm_tf32`), at
  TOL_SSD_BWD under strong decay.  The JAX package's ``ssd_ref`` starts
  its scan from a float32 state, so it cannot be traced in float64;
  :func:`ssd_ref64` is its recurrence with the state in the inputs'
  dtype, held equal to it in float32.
- The plain forward's chunk-start states (``ref.ssd_ref(...,
  states=True)``, which the backward kernel reads from the forward
  kernel) against the JAX recurrence's state after each 64-token prefix.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ref import ssd_ref as jssd_ref
from repro_torch.kernels.mamba2_ssd import ops, ref
from repro_torch.obs.trace import kernel_launch_counts

TQB = 64          # the backward kernel's chunk (csrc/ssd.cu)
SSD_CU = Path(ops.__file__).resolve().parents[2] / "csrc" / "ssd.cu"
# max |model - float64 autograd| / max |autograd| of each gradient for
# the kernel's float32 arithmetic (chip_smoke.py holds the kernel to it)
TOL_SSD_BWD = 1e-4
LOG2E = 1.4426950408889634


def ssd_ref64(xdt, logd, Bv, Cv):
    """``repro.kernels.mamba2_ssd.ref.ssd_ref`` with its initial state in
    the inputs' dtype (float64 under ``jax.enable_x64``)."""
    BH, S, P = xdt.shape
    N = Bv.shape[-1]

    def step(h, inp):
        x_t, ld_t, b_t, c_t = inp
        h = h * jnp.exp(ld_t)[:, None, None] + x_t[..., None] * b_t[:, None, :]
        return h, jnp.einsum("bpn,bn->bp", h, c_t)

    hf, ys = jax.lax.scan(
        step, jnp.zeros((BH, P, N), xdt.dtype),
        (xdt.transpose(1, 0, 2), logd.transpose(1, 0),
         Bv.transpose(1, 0, 2), Cv.transpose(1, 0, 2)))
    return ys.transpose(1, 0, 2), hf


def _inputs(rng, BH, S, P, N, heads, decay, dtype, with_hf=True):
    scale, shift = {"weak": (0.01, 0.0), "moderate": (0.2, 0.0),
                    "strong": (4.0, 1.0)}[decay]
    xdt = rng.standard_normal((BH, S, P))
    logd = -(np.abs(rng.standard_normal((BH, S))) * scale + shift)
    Bv, Cv = (rng.standard_normal((BH // heads, S, N)) for _ in range(2))
    dy = rng.standard_normal((BH, S, P))
    dhf = rng.standard_normal((BH, P, N)) if with_hf else None
    cast = lambda a: None if a is None else a.astype(dtype)
    return [cast(a) for a in (dy, dhf, xdt, logd, Bv, Cv)]


def jax_vjp(dy, dhf, xdt, logd, Bv, Cv, heads, fn):
    """(dxdt, dlogd, dB, dC) by ``jax.vjp`` of ``fn`` on B and C repeated
    per head (the JAX scan takes them per row), dB and dC summed back
    over the heads."""
    rep = lambda a: jnp.repeat(jnp.asarray(a), heads, axis=0)
    (y, h), vjp = jax.vjp(fn, jnp.asarray(xdt), jnp.asarray(logd), rep(Bv),
                          rep(Cv))
    dx, dl, dB, dC = vjp((jnp.asarray(dy), jnp.zeros_like(h) if dhf is None
                          else jnp.asarray(dhf)))
    fold = lambda a: np.asarray(a).reshape((-1, heads) + a.shape[1:]).sum(1)
    return np.asarray(dx), np.asarray(dl), fold(dB), fold(dC)


def _close(got, want, rel):
    for name, g, w in zip(("dxdt", "dlogd", "dB", "dC"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        scale = float(np.abs(w).max())
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max()) / scale
        assert err <= rel, (name, err, rel)


# ---------------------------------------------------------------------------
# the CPU path: autograd through the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heads,with_hf", [(1, False), (1, True), (3, False),
                                           (3, True)])
def test_ssd_backward_cpu_matches_jax_vjp(heads, with_hf):
    rng = np.random.default_rng(heads * 2 + with_hf)
    args = _inputs(rng, 6, 77, 8, 5, heads, "moderate", np.float32, with_hf)
    want = jax_vjp(*args, heads, jssd_ref)
    t = [None if a is None else torch.tensor(a) for a in args]
    got = ops.ssd_backward(*t, heads=heads)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want, 1e-5)


def test_ssd_function_routes_by_grad_mode():
    """Under grad mode with an input that wants a gradient, ``ssd`` is
    the autograd Function (one forward, one backward launch); under
    ``inference_mode`` the forward alone, as before; a gradient reaches
    each input through the wrapper's copies."""
    rng = np.random.default_rng(0)
    dy, _, xdt, logd, Bv, Cv = _inputs(rng, 4, 40, 6, 3, 2, "moderate",
                                       np.float32, False)
    dy, xdt, logd, Bv, Cv = map(torch.tensor, (dy, xdt, logd, Bv, Cv))
    before = kernel_launch_counts()
    with torch.inference_mode():
        y, _ = ops.ssd(xdt, logd, Bv, Cv, heads=2)
    assert y.grad_fn is None
    mid = kernel_launch_counts()
    assert mid.get(ops.KERNEL, 0) - before.get(ops.KERNEL, 0) == 1
    assert mid.get(ops.BACKWARD, 0) == before.get(ops.BACKWARD, 0)
    leaves = [t.clone().requires_grad_() for t in (xdt, logd, Bv, Cv)]
    # a strided view, as the model hands the scan its permuted inputs
    xv = leaves[0].transpose(0, 1).contiguous().transpose(0, 1)
    y, h = ops.ssd(xv, *leaves[1:], heads=2)
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    after = kernel_launch_counts()
    assert after.get(ops.KERNEL, 0) - mid.get(ops.KERNEL, 0) == 1
    assert after.get(ops.BACKWARD, 0) - mid.get(ops.BACKWARD, 0) == 1
    want = ops.ssd_backward(dy, None, xdt, logd, Bv, Cv, heads=2)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the kernel's chunked algorithm
# ---------------------------------------------------------------------------
def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with 10 mantissa bits, ties away from zero, by bit operations on
    the float32 words."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b as the tensor cores compute it from TF32 operands, float32
    sums: with ``split`` the 3xTF32 form big.big + big.small + small.big
    of the backward in ``csrc/ssd.cu`` (big = tf32(v) by integer rounding;
    small = v - big, whose low 13 bits the tensor cores do not read), else
    one TF32 product."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    trunc = lambda v: (v.contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return trunc(a - ab) @ bb + ab @ trunc(b - bb) + ab @ bb


def kernel_model(dy, dhf, xdt, logd, B, C, heads, pb=64, tf32=False):
    """``ssd_bwd``'s algorithm: ``pb`` state rows a block, chunks of TQB
    tokens (the last one zero-padded), the states at chunk starts from the
    forward's recurrence.  In float64 numpy, or, with ``tf32``, in float32
    torch with every product as the kernel's 3xTF32."""
    BH, S, P = xdt.shape
    N = B.shape[-1]
    nch, npb = -(-S // TQB), -(-P // pb)
    if tf32:
        T = lambda a: None if a is None else torch.tensor(a,
                                                          dtype=torch.float32)
        dy, dhf, xdt, logd, B, C = map(T, (dy, dhf, xdt, logd, B, C))
        lib, mm = torch, (lambda a, b: _mm_tf32(a, b, True))
        exp2 = torch.exp2
        cumsum = lambda a, axis=0: torch.cumsum(a, axis)
        flip = lambda a: torch.flip(a, [0])
        zeros = lambda *shape: torch.zeros(shape)
    else:
        lib, mm, exp2 = np, np.matmul, np.exp2
        cumsum = lambda a, axis=0: np.cumsum(a, axis)
        flip = lambda a: a[::-1]
        zeros = lambda *shape: np.zeros(shape)
    pad = nch * TQB - S
    tok = lambda a: lib.concatenate(
        [a, zeros(*((a.shape[0], pad) + tuple(a.shape[2:])))], 1) \
        if tf32 else np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    x, g, ld, Bp, Cp = map(tok, (xdt, dy, logd, B, C))
    # the states before each chunk, from the forward's recurrence
    hst = zeros(BH, nch, P, N)
    for bh in range(BH):
        h = zeros(P, N)
        for t in range(nch * TQB):
            if t % TQB == 0:
                hst[bh, t // TQB] = h
            h = h * lib.exp(ld[bh, t]) + x[bh, t, :, None] * Bp[
                bh // heads, t, None, :]
    sl = lambda c: slice(c * TQB, (c + 1) * TQB)
    r = np.arange(TQB)

    def decays(l):
        """L (exponents from the first row of j's 8-key tile, log2
        units), din (prefix), e (suffix), dl."""
        R = lib.stack([cumsum(l * lib.as_tensor(r >= 8 * kt) if tf32
                              else l * (r >= 8 * kt)) for kt in range(8)],
                      1) * LOG2E
        ex = R[:, r // 8] - R[r, r // 8][None, :]          # (i, j)
        tri = np.tril(np.ones((TQB, TQB), dtype=bool))
        L = lib.where(lib.as_tensor(tri) if tf32 else tri, exp2(ex),
                      0.0 * ex)
        din = exp2(R[:, 0])
        suf = flip(cumsum(flip(l)))
        e = exp2(lib.concatenate([suf[1:], zeros(1)]) * LOG2E)
        return L, din, e, exp2(R[-1, 0])

    dx = zeros(*x.shape)
    dlp = zeros(BH, npb, nch * TQB)
    dBp = zeros(BH, npb, *Bp.shape[1:])
    dCp = zeros(BH, npb, *Bp.shape[1:])
    for bh in range(BH):
        bc = bh // heads
        dec = [decays(ld[bh, sl(c)]) for c in range(nch)]
        for q in range(npb):
            ps = slice(q * pb, min(P, (q + 1) * pb))
            G = (zeros(ps.stop - ps.start, N) if dhf is None
                 else dhf[bh, ps] + 0.0)
            for c in reversed(range(nch)):
                X, dY = x[bh, sl(c), ps], g[bh, sl(c), ps]
                Bc, Cc, H0 = Bp[bc, sl(c)], Cp[bc, sl(c)], hst[bh, c, ps]
                L, din, e, dl = dec[c]
                CB = mm(Cc, Bc.T)
                Z = mm(dY, X.T) * L
                dx[bh, sl(c), ps] = mm((CB * L).T, dY) + e[:, None] * mm(
                    Bc, G.T)
                T1, T2 = mm(dY, H0), mm(X, G)
                dCp[bh, q, sl(c)] = din[:, None] * T1 + mm(Z, Bc)
                dBp[bh, q, sl(c)] = mm(Z.T, Cc) + e[:, None] * T2
                u = din * (Cc * T1).sum(1)
                v = e * (Bc * T2).sum(1)
                w = dl * (G * H0).sum()
                # pair_i = sum_{j < i} sum_{k >= i} W[k][j]: row j's
                # suffix over the keys, then column i's sum over the rows
                # j < i of each 16-row tile, the tiles in order
                W = (Z * CB).T                             # (j, k)
                suf = flip(cumsum(flip(W.T))).T            # (j, i)
                below = np.triu(np.ones((TQB, TQB), dtype=bool), 1)
                suf = suf * (lib.as_tensor(below) if tf32 else below)
                pair = sum(suf[16 * t:16 * t + 16].sum(0) for t in range(4))
                usuf = flip(cumsum(flip(u)))
                vpre = lib.concatenate([zeros(1), cumsum(v)[:-1]])
                dlp[bh, q, sl(c)] = pair + usuf + vpre + w
                G = dl * G + mm(dY.T, din[:, None] * Cc)
    # over the p blocks, and the heads (head-major, then blocks)
    fold = lambda a: a.reshape((BH // heads, heads * npb) + tuple(
        a.shape[2:])).sum(1)
    out = (dx[:, :S], dlp.sum(1)[:, :S], fold(dBp)[:, :S], fold(dCp)[:, :S])
    return tuple(o.numpy() for o in out) if tf32 else out


def _c_params(src, sig):
    """The parameter count of the C entry point that starts with ``sig``."""
    head = src[src.index(sig):]
    return head[:head.index(")")].count(",") + 1


def test_model_constants_match_the_kernel():
    """The model's chunk and state-row blocks are the kernel's, and the
    wrappers' ctypes signatures match the C entry points."""
    src = SSD_CU.read_text()
    assert re.search(r"constexpr int TQB = (\d+);", src).group(1) == str(TQB)
    assert re.search(r"constexpr int TQ = (\d+);", src).group(1) == str(TQB)
    assert ref.STATE_TILE == TQB
    assert re.search(r"constexpr int BWD_PB = (\d+);", src).group(1) == "64"
    assert _c_params(src, 'extern "C" int ssd_fwd(') == len(ops._ARGS)
    assert _c_params(src, 'extern "C" int ssd_bwd(') == len(ops._BWD_ARGS)
    assert _c_params(src, 'extern "C" long long ssd_bwd_workspace(') == \
        len(ops._BWD_WS_ARGS)
    assert "ssd_bwd_states" not in src


@pytest.mark.parametrize("BH,S,P,N,heads,decay,with_hf,pb", [
    (2, 64, 16, 8, 1, "moderate", False, 64),     # one full chunk
    (3, 150, 32, 16, 3, "weak", True, 64),        # ragged, three chunks
    (6, 200, 16, 8, 3, "strong", True, 64),
    (2, 130, 80, 5, 1, "moderate", True, 64),     # two p blocks, ragged
    (4, 90, 64, 32, 2, "weak", False, 64),
])
def test_kernel_model_matches_jax_vjp_float64(BH, S, P, N, heads, decay,
                                              with_hf, pb):
    rng = np.random.default_rng(S + P)
    args = _inputs(rng, BH, S, P, N, heads, decay, np.float64, with_hf)
    got = kernel_model(*args, heads, pb=pb)
    with jax.enable_x64(True):
        want = jax_vjp(*args, heads, ssd_ref64)
    assert want[0].dtype == np.float64
    _close(got, want, 1e-10)


@pytest.mark.parametrize("BH,S,P,N,heads,with_hf,pb", [
    (2, 150, 64, 16, 2, True, 64),       # Hymba's widths, ragged
    (3, 100, 32, 8, 3, False, 64),
    (2, 90, 80, 5, 1, True, 64),         # two p blocks, N not a multiple of 8
])
def test_kernel_model_3xtf32_matches_jax_vjp_strong_decay(BH, S, P, N, heads,
                                                          with_hf, pb):
    """The kernel's float32 arithmetic (3xTF32 products, the decays from
    tile-local sums, dlogd's nested sums) under strong decay, where dlogd
    cancels, against float64 autograd of the JAX recurrence."""
    rng = np.random.default_rng(S + 7 * P)
    args = _inputs(rng, BH, S, P, N, heads, "strong", np.float64, with_hf)
    got = kernel_model(*[None if a is None else a.astype(np.float32)
                         for a in args], heads, pb=pb, tf32=True)
    with jax.enable_x64(True):
        want = jax_vjp(*[None if a is None else a.astype(np.float32)
                         .astype(np.float64) for a in args], heads,
                       ssd_ref64)
    assert all(g.dtype == np.float32 for g in got)
    _close(got, want, TOL_SSD_BWD)


@pytest.mark.parametrize("S,heads", [(37, 1), (64, 2), (200, 3)])
def test_chunk_start_states_match_jax_prefixes(S, heads):
    """``ssd_ref(..., states=True)``: the state before each 64-token tile
    equals the JAX recurrence's final state on that prefix (float32)."""
    rng = np.random.default_rng(S)
    _, _, xdt, logd, Bv, Cv = _inputs(rng, 2 * heads, S, 8, 4, heads,
                                      "moderate", np.float32)
    t = [torch.tensor(a) for a in (xdt, logd, Bv, Cv)]
    y, hfin, hst = ref.ssd_ref(*t, heads=heads, states=True)
    assert hst.shape == (2 * heads, -(-S // TQB), 8, 4)
    assert hst.dtype == torch.float32
    rep = lambda a: np.repeat(a, heads, axis=0)
    for c in range(hst.shape[1]):
        if c == 0:
            want = np.zeros((2 * heads, 8, 4), np.float32)
        else:
            n = c * TQB
            _, want = jssd_ref(*map(jnp.asarray, (
                xdt[:, :n], logd[:, :n], rep(Bv)[:, :n], rep(Cv)[:, :n])))
        np.testing.assert_allclose(hst[:, c].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    y2, h2 = ref.ssd_ref(*t, heads=heads)
    assert torch.equal(y, y2) and torch.equal(hfin, h2)


def test_ssd_backward_takes_the_forwards_states():
    """The autograd Function hands the backward the states its forward
    saved; a direct ``ssd_backward`` call may pass them too (the CPU path
    differentiates the plain version either way)."""
    rng = np.random.default_rng(4)
    dy, _, xdt, logd, Bv, Cv = _inputs(rng, 2, 70, 8, 4, 1, "moderate",
                                       np.float32, False)
    dy, xdt, logd, Bv, Cv = map(torch.tensor, (dy, xdt, logd, Bv, Cv))
    y, h, hst = ops._forward(xdt, logd, Bv, Cv, 128, 1, states=True)
    assert hst.shape == (2, 2, 8, 4)
    a = ops.ssd_backward(dy, None, xdt, logd, Bv, Cv, states=hst)
    b = ops.ssd_backward(dy, None, xdt, logd, Bv, Cv)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_ssd_ref64_is_the_package_recurrence():
    rng = np.random.default_rng(9)
    _, _, xdt, logd, Bv, Cv = _inputs(rng, 3, 70, 8, 4, 1, "moderate",
                                      np.float32)
    a = [jnp.asarray(t) for t in (xdt, logd, Bv, Cv)]
    for got, want in zip(ssd_ref64(*a), jssd_ref(*a)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
