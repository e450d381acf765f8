"""The SSD scan's backward (``kernels/mamba2_ssd``: ``ssd_backward``, the
``ssd`` autograd Function, and the algorithm of ``csrc/ssd.cu``'s
``ssd_bwd``) against ``jax.vjp`` of the JAX package's scan, on the CPU.

- ``ssd_backward``'s CPU path (autograd through the plain version)
  against ``jax.vjp`` of ``repro.kernels.mamba2_ssd.ref.ssd_ref`` in
  float32: each gradient within 1e-5 of its largest magnitude (the same
  recurrence; the sums run in another order).
- The kernel cannot run here, so a float64 numpy model of its chunked
  algorithm (:func:`kernel_model`: 64-token chunks, the states recomputed
  at chunk starts, the reverse carry of the gradient G, the decays as
  running sums, ``dlogd`` by the nested sums of the pair term, dB and dC
  summed over heads and state-row blocks in the kernel's order) is held
  against ``jax.vjp`` in float64 at 1e-10.  The JAX package's ``ssd_ref``
  starts its scan from a float32 state, so it cannot be traced in
  float64; :func:`ssd_ref64` is its recurrence with the state in the
  inputs' dtype, held equal to it in float32.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ref import ssd_ref as jssd_ref
from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.obs.trace import kernel_launch_counts

TQB = 64          # the backward kernel's chunk (csrc/ssd.cu)
SSD_CU = Path(ops.__file__).resolve().parents[2] / "csrc" / "ssd.cu"


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
# the kernel's chunked algorithm, in float64
# ---------------------------------------------------------------------------
def kernel_model(dy, dhf, xdt, logd, B, C, heads, pb=64):
    """``ssd_bwd``'s three passes in float64 numpy: ``pb`` state rows a
    block, chunks of TQB tokens (the last one zero-padded)."""
    BH, S, P = xdt.shape
    N = B.shape[-1]
    nch, npb = -(-S // TQB), -(-P // pb)
    pad = nch * TQB - S
    tok = lambda a: np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    x, g, ld, Bp, Cp = map(tok, (xdt, dy, logd, B, C))
    sl = lambda c: slice(c * TQB, (c + 1) * TQB)

    def decays(l):
        """L (column j: running sums from key j + 1), din (prefix), e
        (suffix), dl."""
        L = np.zeros((TQB, TQB))
        for j in range(TQB):
            L[j, j] = 1.0
            L[j + 1:, j] = np.exp(np.cumsum(l[j + 1:]))
        din = np.exp(np.cumsum(l))
        suf = np.cumsum(l[::-1])[::-1]
        e = np.exp(np.append(suf[1:], 0.0))
        return L, din, e, np.exp(suf[0])

    dx = np.zeros_like(x)
    dlp = np.zeros((BH, npb) + ld.shape[1:])
    dBp = np.zeros((BH, npb) + Bp.shape[1:])
    dCp = np.zeros_like(dBp)
    for bh in range(BH):
        bc = bh // heads
        dec = [decays(ld[bh, sl(c)]) for c in range(nch)]
        for q in range(npb):
            ps = slice(q * pb, min(P, (q + 1) * pb))
            # pass 1: the state at each chunk's start
            h0, h = [], np.zeros((ps.stop - ps.start, N))
            for c in range(nch):
                h0.append(h)
                _, _, e, dl = dec[c]
                h = dl * h + x[bh, sl(c), ps].T @ (e[:, None] * Bp[bc, sl(c)])
            # pass 2: the chunks backward, carrying G
            G = (np.zeros_like(h) if dhf is None else dhf[bh, ps])
            for c in reversed(range(nch)):
                X, dY = x[bh, sl(c), ps], g[bh, sl(c), ps]
                Bc, Cc, H0 = Bp[bc, sl(c)], Cp[bc, sl(c)], h0[c]
                L, din, e, dl = dec[c]
                CB = Cc @ Bc.T
                Z = (dY @ X.T) * L
                W = np.tril(Z * CB, -1)
                dx[bh, sl(c), ps] = (CB * L).T @ dY + e[:, None] * (Bc @ G.T)
                T1, T2 = dY @ H0, X @ G
                dCp[bh, q, sl(c)] = din[:, None] * T1 + Z @ Bc
                dBp[bh, q, sl(c)] = Z.T @ Cc + e[:, None] * T2
                u = din * (Cc * T1).sum(1)
                v = e * (Bc * T2).sum(1)
                w = dl * (G * H0).sum()
                pw = np.cumsum(W, axis=1) - W        # exclusive row prefix
                pair = np.array([pw[i:, i].sum() for i in range(TQB)])
                usuf = np.cumsum(u[::-1])[::-1]
                vpre = np.cumsum(v) - v
                dlp[bh, q, sl(c)] = pair + usuf + vpre + w
                G = dl * G + dY.T @ (din[:, None] * Cc)
    # pass 3: over the p blocks, and the heads (head-major, then blocks)
    fold = lambda a: a.reshape((BH // heads, heads * npb) + a.shape[2:]
                               ).sum(1)
    return (dx[:, :S], dlp.sum(1)[:, :S], fold(dBp)[:, :S],
            fold(dCp)[:, :S])


def test_model_constants_match_the_kernel():
    src = SSD_CU.read_text()
    assert re.search(r"constexpr int TQB = (\d+);", src).group(1) == str(TQB)
    assert 'extern "C" int ssd_bwd(' in src
    assert 'extern "C" long long ssd_bwd_workspace(' in src


@pytest.mark.parametrize("BH,S,P,N,heads,decay,with_hf,pb", [
    (2, 64, 16, 8, 1, "moderate", False, 64),     # one full chunk
    (3, 150, 32, 16, 3, "weak", True, 64),        # ragged, three chunks
    (6, 200, 16, 8, 3, "strong", True, 64),
    (2, 130, 40, 5, 1, "moderate", True, 16),     # three p blocks, ragged
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


def test_ssd_ref64_is_the_package_recurrence():
    rng = np.random.default_rng(9)
    _, _, xdt, logd, Bv, Cv = _inputs(rng, 3, 70, 8, 4, 1, "moderate",
                                      np.float32)
    a = [jnp.asarray(t) for t in (xdt, logd, Bv, Cv)]
    for got, want in zip(ssd_ref64(*a), jssd_ref(*a)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
