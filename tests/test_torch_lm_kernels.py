"""Parity of the LM kernels' wrappers in the PyTorch port with the JAX
package's Pallas kernels (run in interpret mode, as tests/test_kernels.py
runs them).  On the CPU each wrapper runs its plain version; the CUDA
kernels are held against those plain versions on the card by
chip_smoke.py.  Inputs are made with numpy from a seed.

Tolerances (float32) follow tests/test_kernels.py: rmsnorm 1e-6, flash
attention 1e-5, SSD 1e-4 — both sides compute in float32 and differ only
in the order of their sums.  The gradients of the two differentiable
wrappers (rmsnorm, flash prefill) are held to ``jax.grad`` of the JAX
model's functions at 1e-5; their backward kernels are held to the plain
versions on the card by chip_smoke.py (phase 11).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention.ref import flash_attention_ref as jfa_ref
from repro.kernels.mamba2_ssd.ops import ssd as jssd
from repro.kernels.mamba2_ssd.ref import ssd_ref as jssd_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.models import layers as jlayers
from repro.models.attention import _attend as jattend
from repro.models.attention import expand_kv as jexpand_kv
from repro_torch.configs.base import get_arch
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (expand_kv,
                                                     flash_attention_ref,
                                                     visible)
from repro_torch.kernels.mamba2_ssd.ops import ssd as tssd
from repro_torch.kernels.rmsnorm.ops import rmsnorm as trmsnorm
from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward
from repro_torch.models import layers as tlayers

F32 = np.float32


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, F32), np.asarray(want, F32), atol=tol,
        rtol=tol)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_residual", [True, False])
# the last four: the decode shapes (8 requests of one token, or one) at
# Hymba's widths (d_model 1,600; gate_norm over d_inner 3,200)
@pytest.mark.parametrize("T,D", [(64, 128), (32, 200), (1, 1600), (8, 1600),
                                 (1, 3200), (8, 3200)])
def test_rmsnorm_matches_pallas(T, D, with_residual):
    rng = np.random.default_rng(T + D)
    x = rng.standard_normal((T, D)).astype(F32)
    w = rng.standard_normal(D).astype(F32)
    r = rng.standard_normal((T, D)).astype(F32) if with_residual else None
    jy, jr = jrmsnorm(jnp.asarray(x), jnp.asarray(w),
                      None if r is None else jnp.asarray(r))
    ty, tr = trmsnorm(torch.tensor(x), torch.tensor(w),
                      None if r is None else torch.tensor(r))
    _close(ty, jy, 1e-6)
    _close(tr, jr, 1e-6)
    if r is None:
        assert np.array_equal(tr.numpy(), x)


def test_rmsnorm_bf16_sums_in_float32():
    """The plain version copies the Pallas kernel: x + r in float32, not
    rounded to bf16 before the norm.  Held to the Pallas kernel at the
    bf16 tolerance of tests/test_kernels.py (2e-2)."""
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal((16, 64)).astype(F32) for _ in range(2))
    w = rng.standard_normal(64).astype(F32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, r)]
    jy, jr = jrmsnorm(*bf)
    tb = [torch.tensor(a).to(torch.bfloat16) for a in (x, w, r)]
    ty, tr = trmsnorm(*tb)
    assert ty.dtype == tr.dtype == torch.bfloat16
    _close(ty, np.asarray(jy, F32), 2e-2)
    _close(tr, np.asarray(jr, F32), 0)
    want = (tb[0].float() + tb[2].float())
    want = want * torch.rsqrt(want.square().mean(-1, keepdim=True) + 1e-5)
    assert torch.equal(ty, (want * tb[1].float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 1), (2, 2)])
def test_mha_matches_pallas(causal, window, H, Hkv):
    """Causal, windowed and bidirectional; GQA groups 2, 4 and 1."""
    rng = np.random.default_rng(H * 10 + Hkv)
    B, S, D = 2, 64, 16
    q = rng.standard_normal((B, S, H, D)).astype(F32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(F32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(F32)
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, block_q=32, block_k=32)
    got = tfa.mha(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                  causal=causal, window=window)
    assert got.shape == (B, S, H, D)
    _close(got, want, 1e-5)


def test_decode_wrapped_ring_matches_pallas():
    """Slot-cache decode on a ring that has wrapped (pos > S_alloc)."""
    rng = np.random.default_rng(1)
    B, S_alloc, H, Hkv, D = 2, 128, 4, 2, 32
    pos = 200
    q = rng.standard_normal((B, 1, H, D)).astype(F32)
    k = rng.standard_normal((B, S_alloc, Hkv, D)).astype(F32)
    v = rng.standard_normal((B, S_alloc, Hkv, D)).astype(F32)
    slot_pos = np.full(S_alloc, -1, np.int32)
    for p in range(pos - S_alloc, pos):
        slot_pos[p % S_alloc] = p
    want = jfa.decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(slot_pos), pos, window=100, block_k=64)
    got = tfa.decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                     torch.tensor(slot_pos), pos, window=100)
    _close(got, want, 1e-5)


def test_fully_masked_rows_match_the_reference_and_never_occur_when_serving():
    """A query that sees no key gives the mean of v over all keys in the
    port's plain version, as in the JAX oracle (a softmax over a row of
    -1e30) and the Pallas kernel (p = 1 for every key, l = Sk); the CUDA
    kernel is held to the plain version on such rows by chip_smoke.py.
    On the serve path no row is fully masked: prefill queries see their own
    position and decode writes the token's slot before attending."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 4, 8)).astype(F32) for _ in range(3))
    q_pos = np.array([0, 1, 2, 3], np.int32)
    k_pos = np.array([2, 3, -1, -1], np.int32)          # rows 0, 1 see none
    got = flash_attention_ref(*map(torch.tensor, (q, k, v, q_pos, k_pos)))
    want = jfa_ref(*map(jnp.asarray, (q, k, v, q_pos, k_pos)))
    np.testing.assert_allclose(np.asarray(want)[0, :2],
                               np.broadcast_to(v[0].mean(0), (2, 8)),
                               atol=1e-6)
    _close(got, want, 1e-5)
    # the serve path's masks: causal prefill with a window, and a decode
    # step at every position of a wrapped 32-slot ring
    S = 96
    pos = torch.arange(S, dtype=torch.int32)
    assert visible(pos, pos, causal=True, window=32).any(-1).all()
    slot_pos = torch.full((32,), -1, dtype=torch.int32)
    for p in range(S):
        slot_pos[p % 32] = p
        assert visible(torch.tensor([p], dtype=torch.int32), slot_pos,
                       causal=True, window=32).any()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_head_map_on_unexpanded_kv_matches_jax(mode):
    """``ops.attention`` with Hymba's padded head map (32 query heads over
    7 kv heads, irregular) on unexpanded K/V, against the JAX path that
    expands the kv heads first (``expand_kv``), then runs the oracle and
    the Pallas kernel in interpret mode.  Prefill: causal with a window;
    decode: a ring with empty slots."""
    idx = get_arch("hymba-1.5b").kv_index_map()
    H, Hkv, B, D = len(idx), max(idx) + 1, 2, 16
    rng = np.random.default_rng(7 if mode == "prefill" else 8)
    if mode == "prefill":
        Sq = Sk = 32
        q_pos = k_pos = np.arange(Sq, dtype=np.int32)
        window = 12
    else:
        Sq, Sk, pos, window = 1, 32, 20, 16
        q_pos = np.array([pos], np.int32)
        k_pos = np.where(np.arange(Sk) <= pos, np.arange(Sk), -1).astype(
            np.int32)                            # slots 21.. are empty
    q = rng.standard_normal((B, Sq, H, D)).astype(F32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(F32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(F32)
    got = tfa.attention(*map(torch.tensor, (q, k, v, q_pos, k_pos)),
                        causal=True, window=window, kv_head=idx)
    assert got.shape == (B, Sq, H, D)
    ke, ve = (jexpand_kv(jnp.asarray(t), 1, idx) for t in (k, v))
    flat = [t.transpose(0, 2, 1, 3).reshape(B * H, -1, D)
            for t in (jnp.asarray(q), ke, ve)]
    want = jfa_ref(*flat, jnp.asarray(q_pos), jnp.asarray(k_pos),
                   causal=True, window=window)
    _close(got, np.asarray(want).reshape(B, H, Sq, D).transpose(0, 2, 1, 3),
           1e-5)
    if mode == "prefill":
        pallas = jfa.mha(jnp.asarray(q), ke, ve, causal=True, window=window,
                         block_q=16, block_k=16)
    else:
        pallas = jfa.decode(jnp.asarray(q), ke, ve, jnp.asarray(k_pos), pos,
                            window=window, block_k=16)
    _close(got, pallas, 1e-5)


def test_padded_head_expansion_matches_jax():
    """Hymba's padded heads (25 -> 32 query, 5 -> 7 kv) use the irregular
    kv_index_map; the expansion gathers the same heads as the JAX model."""
    cfg = get_arch("hymba-1.5b")
    idx = cfg.kv_index_map()
    assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (32, 7)
    assert len(set(idx)) == 7 and max(idx) == 6
    k = np.random.default_rng(4).standard_normal((2, 5, 7, 4)).astype(F32)
    want = jexpand_kv(jnp.asarray(k), 1, idx)
    got = expand_kv(torch.tensor(k), 1, idx)
    assert got.shape == (2, 5, 32, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    small = get_arch("granite-8b", smoke=True)
    g = small.n_heads // small.n_kv_heads
    assert np.array_equal(expand_kv(torch.tensor(k), g).numpy(),
                          np.asarray(jexpand_kv(jnp.asarray(k), g)))


# ---------------------------------------------------------------------------
# mamba2 SSD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("heads", [1, 3])
def test_ssd_matches_pallas(chunk, heads):
    """Two chunk sizes; B and C either per row or shared by 3 heads (the
    model's ngroups = 1 layout, expanded for the JAX kernel)."""
    rng = np.random.default_rng(chunk + heads)
    BH, S, P, N = 6, 64, 8, 16
    xdt = rng.standard_normal((BH, S, P)).astype(F32)
    logd = (-np.abs(rng.standard_normal((BH, S))) * 0.2).astype(F32)
    Bv = rng.standard_normal((BH // heads, S, N)).astype(F32)
    Cv = rng.standard_normal((BH // heads, S, N)).astype(F32)
    jy, jh = jssd(jnp.asarray(xdt), jnp.asarray(logd),
                  jnp.asarray(np.repeat(Bv, heads, 0)),
                  jnp.asarray(np.repeat(Cv, heads, 0)), chunk=chunk)
    ty, th = tssd(*map(torch.tensor, (xdt, logd, Bv, Cv)), chunk=chunk,
                  heads=heads)
    _close(ty, jy, 1e-4)
    _close(th, jh, 1e-4)


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with 10 mantissa bits, ties away from zero, by bit operations on
    the float32 words."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b as the tensor cores compute it from TF32 operands, float32
    sums: with ``split`` the 3xTF32 form big.big + big.small + small.big
    of ``csrc/ssd.cu`` (big = tf32(v), small = tf32(v - big)), else one
    TF32 product."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _ssd_kernel_arith(xdt, logd, Bv, Cv, chunk, split=True):
    """The arithmetic of ``csrc/ssd.cu`` in plain PyTorch: chunks of at
    most 64 tokens; the decay of pair (i, j) as exp2(R_i - R_j), R the sum
    of logd (log2 units) from the first row of j's 8-key tile; the state's
    weights from a suffix sum; every product (C B^T, (C B^T * L) X,
    C h^T, (X * dec)^T B) on TF32 operands."""
    BH, S, P = xdt.shape
    Q = min(chunk, 64)
    log2e = 1.4426950408889634
    h = torch.zeros((BH, P, Bv.shape[-1]))
    ys = []
    for s0 in range(0, S, Q):
        x, B, C = (t[:, s0:s0 + Q] for t in (xdt, Bv, Cv))
        ld = logd[:, s0:s0 + Q]
        n = x.shape[1]
        r = torch.arange(n)
        R = torch.stack([torch.cumsum(ld * (r >= 8 * kt), 1)
                         for kt in range(-(-n // 8))], 2) * log2e
        Ri = R[:, :, r // 8]                         # (BH, i, j)
        Rj = R[:, r, r // 8]                         # (BH, j)
        L = torch.where(torch.tril(torch.ones(n, n, dtype=torch.bool)),
                        torch.exp2(Ri - Rj[:, None, :]), 0.0)
        y = _mm_tf32(_mm_tf32(C, B.transpose(1, 2), split) * L, x, split)
        y = y + _mm_tf32(C, h.transpose(1, 2), split) * torch.exp2(
            R[:, :, 0])[:, :, None]
        suf = torch.flip(torch.cumsum(torch.flip(ld, [1]), 1), [1])
        suf = torch.cat([suf[:, 1:], torch.zeros((BH, 1))], 1)
        dec = torch.exp2(suf * log2e)
        h = h * torch.exp2(R[:, -1, 0])[:, None, None] + _mm_tf32(
            (x * dec[:, :, None]).transpose(1, 2), B, split)
        ys.append(y)
    return torch.cat(ys, 1), h


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("heads", [1, 3])
def test_ssd_3xtf32_arithmetic_matches_jax(chunk, heads):
    """The CUDA kernel's numerical design, emulated on the CPU on the
    shapes of ``test_ssd_matches_pallas``: 3xTF32 products hold the JAX
    oracle ``ssd_ref`` at 1e-4 (tests/test_kernels.py's bound), where one
    TF32 product each does not."""
    rng = np.random.default_rng(chunk + heads)
    BH, S, P, N = 6, 64, 8, 16
    xdt = rng.standard_normal((BH, S, P)).astype(F32)
    logd = (-np.abs(rng.standard_normal((BH, S))) * 0.2).astype(F32)
    Bv = rng.standard_normal((BH // heads, S, N)).astype(F32)
    Cv = rng.standard_normal((BH // heads, S, N)).astype(F32)
    Be, Ce = (np.repeat(v, heads, 0) for v in (Bv, Cv))
    jy, jh = jssd_ref(*map(jnp.asarray, (xdt, logd, Be, Ce)))
    args = [torch.tensor(a) for a in (xdt, logd, Be, Ce)]
    ty, th = _ssd_kernel_arith(*args, chunk)
    _close(ty, jy, 1e-4)
    _close(th, jh, 1e-4)
    one_y, _ = _ssd_kernel_arith(*args, chunk, split=False)
    assert np.abs(one_y.numpy() - np.asarray(jy)).max() > 1e-3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """``_tf32`` rounds to nearest, ties away from zero, on both signs."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3], dtype=torch.float32)
    got = _tf32(x)
    assert got.tolist()[:5] == [one, one + ulp, -(one + ulp), one,
                                one + ulp]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


# ---------------------------------------------------------------------------
# gradients: the autograd Functions against jax.grad of the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_residual", [True, False])
def test_rms_norm_gradient_matches_jax(with_residual):
    """``layers.rms_norm`` through the rmsnorm Function (on the CPU its
    backward differentiates the plain version) against ``jax.grad`` of the
    JAX ``layers.rms_norm`` (of ``x + r`` in the residual form, whose sum
    the loss also reads, as the next block does): dx, d(residual), dw
    within 1e-5 (float32, sums in another order)."""
    rng = np.random.default_rng(11)
    x, r, c1, c2 = (rng.standard_normal((3, 7, 48)).astype(F32)
                    for _ in range(4))
    w = rng.standard_normal(48).astype(F32)

    def jloss(x, r, w):
        s = x + r if with_residual else x
        y = jlayers.rms_norm(s, w)
        return jnp.sum(y * c1) + (jnp.sum(s * c2) if with_residual else 0.0)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, r, w)))
    xt, rt, wt = (torch.tensor(a, requires_grad=True) for a in (x, r, w))
    if with_residual:
        y, s = tlayers.rms_norm(xt, wt, residual=rt)
        loss = (y * torch.tensor(c1)).sum() + (s * torch.tensor(c2)).sum()
    else:
        loss = (tlayers.rms_norm(xt, wt) * torch.tensor(c1)).sum()
    loss.backward()
    _close(xt.grad, want[0], 1e-5)
    _close(wt.grad, want[2], 1e-5)
    if with_residual:
        _close(rt.grad, want[1], 1e-5)
    else:
        assert rt.grad is None


_GRAD_CASES = [pytest.param(True, None, False, 16, id="True-None-False"),
               pytest.param(True, 12, False, 16, id="True-12-False"),
               pytest.param(False, None, False, 16, id="False-None-False"),
               pytest.param(True, 12, True, 16, id="True-12-True")]
_GRAD_CASES += [pytest.param(True, w, pad, D, id=f"True-{w}-{pad}-D{D}")
                for D in tfa.HEAD_DIMS[1:]
                for w, pad in ((None, False), (12, True))]


@pytest.mark.parametrize("causal,window,pad,D", _GRAD_CASES)
def test_mha_gradient_matches_jax(causal, window, pad, D):
    """``ops.mha`` through the flash Function (on the CPU its backward
    differentiates the plain version) against ``jax.grad`` of the JAX
    model's ``_attend`` on K/V expanded by ``expand_kv``: causal, windowed,
    bidirectional, and Hymba's padded head map (32 query heads over 7 kv
    heads), where dK and dV sum over the irregular group of each kv head;
    at every head dim the kernel takes.  dq, dk, dv within 1e-5 (float32,
    sums in another order)."""
    rng = np.random.default_rng(13)
    if pad:
        idx = get_arch("hymba-1.5b").kv_index_map()
        H, Hkv = len(idx), max(idx) + 1
    else:
        idx, H, Hkv = None, 4, 2
    B, S = 2, 24
    q, c = (rng.standard_normal((B, S, H, D)).astype(F32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(F32)
            for _ in range(2))
    pos = jnp.arange(S, dtype=jnp.int32)
    g = H // Hkv if idx is None else 1

    def jloss(q, k, v):
        out = jattend(q, jexpand_kv(k, g, idx), jexpand_kv(v, g, idx), pos,
                      pos, causal=causal, window=window, scale=D ** -0.5)
        return jnp.sum(out * c)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.mha(qt, kt, vt, causal=causal, window=window, kv_head=idx)
    (out * torch.tensor(c)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        _close(got, w, 1e-5)


def test_serving_takes_no_gradient_path():
    """Under ``inference_mode`` (serving) or with no input wanting a
    gradient, ``mha`` and ``rmsnorm`` call the forward wrappers as before:
    no autograd node, no backward dispatch."""
    from repro_torch.obs.trace import kernel_launch_counts
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    before = kernel_launch_counts()
    with torch.inference_mode():
        out = tfa.mha(q, q, q)
        y, _ = trmsnorm(q, torch.ones(16, requires_grad=True))
    assert out.grad_fn is None and y.grad_fn is None
    after = kernel_launch_counts()
    assert after.get("flash_attention.backward", 0) == before.get(
        "flash_attention.backward", 0)
    assert after.get("flash_attention.prefill", 0) == before.get(
        "flash_attention.prefill", 0) + 1


# ---------------------------------------------------------------------------
# the card-only path: no CPU fallback for a non-CPU tensor
# ---------------------------------------------------------------------------
def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses anything but a CUDA tensor: no wrapper drops to its plain
    version there."""
    m = torch.device("meta")
    x = torch.empty((4, 64), device=m)
    with pytest.raises(ValueError, match="kernel needs"):
        trmsnorm(x, torch.empty(64, device=m))
    q = torch.empty((1, 8, 2, 16), device=m)
    with pytest.raises(ValueError, match="kernel needs"):
        tfa.attention(q, q, q, torch.arange(8, dtype=torch.int32,
                                            device=m),
                      torch.arange(8, dtype=torch.int32, device=m))
    with pytest.raises(ValueError, match="kernel needs"):
        tssd(torch.empty((2, 8, 4), device=m), torch.empty((2, 8), device=m),
             torch.empty((2, 8, 4), device=m),
             torch.empty((2, 8, 4), device=m))


def test_backward_wrappers_do_not_fall_back_off_the_cpu():
    """The same for the two backward wrappers and for the Functions'
    forward (``mha`` and ``rmsnorm`` with a gradient wanted)."""
    m = torch.device("meta")
    x = torch.empty((4, 64), device=m)
    w = torch.empty(64, device=m)
    with pytest.raises(ValueError, match="kernel needs"):
        rmsnorm_backward(x, x, x, w, x)
    with pytest.raises(ValueError, match="kernel needs"):
        trmsnorm(x.requires_grad_(), w)
    q = torch.empty((1, 8, 2, 16), device=m)
    pos = torch.arange(8, dtype=torch.int32, device=m)
    lse = torch.empty((1, 2, 8), device=m)
    with pytest.raises(ValueError, match="kernel needs"):
        tfa.attention_backward(q, q, q, q, q, lse, pos, pos)
    with pytest.raises(ValueError, match="kernel needs"):
        tfa.mha(q.requires_grad_(), q, q)
