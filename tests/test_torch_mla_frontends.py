"""Parity of the port's MLA (MiniCPM3-4B) and modality frontends (HuBERT-
XLarge's audio stub, InternVL2-26B's vision stub) with the JAX package, on
the SMOKE configs in float32 on the CPU, where the flash-attention wrapper
runs its plain version (the kernel is held to it on the card by
chip_smoke.py: the sweeps at head dims (80, 80) and (96, 64), and phase 14).
Inputs are made with numpy from a seed; the JAX parameters are carried
across by ``convert.params_from_jax``.

Tolerances, each with its reason: 1e-5 for the attention modules and the
plain flash version (float32, sums in another order), as
tests/test_torch_lm.py holds GQA; 1e-4 on whole-model logits, as it holds
GLM-4's, with greedy tokens equal; 0 for the data (numpy draws, the same
bf16 rounding) and the shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget_arch
from repro.data.pipeline import input_specs as jinput_specs
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs.base import ALL_ARCHS, SHAPES, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import input_specs, make_batch
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

F32 = np.float32
MLA, AUDIO, VISION = "minicpm3-4b", "hubert-xlarge", "internvl2-26b"


def _cfgs(name, **kw):
    """The same SMOKE config on both sides, float32 unless kw says."""
    kw = {"dtype": "float32", **kw}
    j = dataclasses.replace(jget_arch(name, smoke=True), **kw)
    t = dataclasses.replace(get_arch(name, smoke=True), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, F32), atol=tol, rtol=tol)


def _model(name):
    jcfg, tcfg = _cfgs(name)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    model = ttf.LM(tcfg, seed=1, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jp), tcfg, device="cpu"))
    return jcfg, tcfg, jp, model


def _bf16_bits(a):
    """A bf16 array of either side as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [0, 6])
def test_mla_matches_jax(pad):
    """``mla_forward`` (expanded form, through ``ops.mha`` at head dims
    (24, 16)) on 40 tokens, the latent cache it leaves, then three
    absorbed-form ``mla_decode`` steps against the JAX ones; ``pad=6``
    pads MiniCPM3's 4 SMOKE heads to 6, the two extra heads masked inert,
    as the full config pads 40 to 48."""
    jcfg, tcfg = _cfgs(MLA, pad_heads_to=pad)
    assert tcfg.n_heads_padded == (pad or tcfg.n_heads)
    p = jattn.init_mla(jax.random.key(0), jcfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 40, jcfg.d_model)).astype(F32)
    pos = np.arange(40, dtype=np.int32)
    jy, (jc, jr) = jax.jit(jattn.mla_forward, static_argnums=2)(
        p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    ty, (tc, tr) = tattn.mla_forward(_tt(p), torch.tensor(x), tcfg,
                                     torch.tensor(pos))
    _close(ty, jy, 1e-5)
    _close(tc, jc, 1e-5)
    _close(tr, jr, 1e-5)
    jcache = jattn.init_mla_cache(jcfg, 2, 48, jnp.float32)
    jcache = dict(jcache, c_kv=jcache["c_kv"].at[:, :40].set(jc),
                  k_rope=jcache["k_rope"].at[:, :40].set(jr),
                  slot_pos=jcache["slot_pos"].at[:40].set(jnp.asarray(pos)))
    tcache = tattn.init_mla_cache(tcfg, 2, 48, torch.float32, "cpu")
    tcache["c_kv"][:, :40] = tc
    tcache["k_rope"][:, :40] = tr
    tcache["slot_pos"][:40] = torch.tensor(pos)
    jdec = jax.jit(lambda p, x, c: jattn.mla_decode(p, x, c, jcfg))
    for step in range(3):
        xs = np.random.default_rng(step + 1).standard_normal(
            (2, 1, jcfg.d_model)).astype(F32)
        jcache["pos"] = jnp.asarray(40 + step, jnp.int32)
        tcache["pos"] = 40 + step
        jy, jcache = jdec(p, jnp.asarray(xs), jcache)
        ty, tcache = tattn.mla_decode(_tt(p), torch.tensor(xs), tcache, tcfg)
        _close(ty, jy, 1e-5)
        _close(tcache["c_kv"], jcache["c_kv"], 1e-5)
        assert np.array_equal(tcache["slot_pos"].numpy(),
                              np.asarray(jcache["slot_pos"]))


@pytest.mark.parametrize("dk,dv,causal", [(24, 16, True), (80, 80, False)])
def test_flash_plain_version_at_mla_and_hubert_dims_matches_jax(dk, dv,
                                                                causal):
    """The flash wrapper's plain version (what the CPU runs, and what the
    kernel is held to on the card) at MiniCPM3 SMOKE's q/k 24 and v 16,
    causal, and at HuBERT's head dim 80, bidirectional, against the JAX
    ``chunked_attention`` (70 queries in chunks of 35), with its
    gradients through ``mha``; a scale other than dk ** -0.5, as MLA
    passes."""
    rng = np.random.default_rng(dk + dv)
    B, S, H = 2, 70, 3
    q, k = (rng.standard_normal((B, S, H, dk)).astype(F32) for _ in range(2))
    v, c = (rng.standard_normal((B, S, H, dv)).astype(F32) for _ in range(2))
    pos = jnp.arange(S, dtype=jnp.int32)
    scale = 0.7 * dk ** -0.5

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, pos, pos, causal=causal,
                                      window=None, scale=scale, chunk=35)
        return jnp.sum(out * c), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.mha(qt, kt, vt, causal=causal, scale=scale)
    assert out.shape == (B, S, H, dv)
    _close(out, jout, 1e-5)
    (out * torch.tensor(c)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), jg):
        _close(got, want, 1e-5)


def test_decode_refuses_mla_and_hubert_head_dims():
    """The decode configuration keeps its head dims: q/k and v of one head
    dim in (16, 32, 64, 128).  MLA's (96, 64) and HuBERT's 80 are refused
    there by name (on meta tensors, which take the card's path); both are
    prefill instances, and a pair the kernel has no instance of is refused
    in prefill too."""
    m = torch.device("meta")
    kp = torch.arange(8, dtype=torch.int32, device=m)
    one = torch.zeros(1, dtype=torch.int32, device=m)
    for dk, dv in ((96, 64), (80, 80)):
        q = torch.empty((1, 1, 2, dk), device=m)
        k = torch.empty((1, 8, 2, dk), device=m)
        v = torch.empty((1, 8, 2, dv), device=m)
        with pytest.raises(ValueError, match="absorbed form"):
            tfa.attention(q, k, v, one, kp)
        assert (dk, dv) in tfa.HEAD_DIM_PAIRS
    q = torch.empty((1, 8, 2, 96), device=m)
    with pytest.raises(ValueError, match="head dims"):
        tfa.attention(q, q, q, kp, kp)


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------
def test_internvl2_prefill_with_patches_then_decode_matches_jax():
    """InternVL2 SMOKE: ``prefill`` on 8 patch embeddings before 24 tokens
    (the cache starts after all 32 positions), then 5 greedy
    ``decode_step`` calls, each side fed its own argmax: tokens equal and
    logits within 1e-4 at every step.  The serving engines take tokens
    only, so this drives the model functions, as the JAX package's
    would."""
    jcfg, tcfg, jp, model = _model(VISION)
    b = jmake_batch(jcfg, "prefill", 32, 2, seed=4)
    tb = make_batch(tcfg, "prefill", 32, 2, seed=4)
    assert b["patch_embeds"].shape == (2, 8, jcfg.frontend_dim)
    jl, jc = jax.jit(lambda p, b: jtf.prefill(p, b, jcfg, alloc_len=40))(
        jp, b)
    jdec = jax.jit(lambda p, c, t: jtf.decode_step(p, c, t, jcfg))
    with torch.inference_mode():
        tl, tc = ttf.prefill(model, tb, tcfg, alloc_len=40)
        assert tc["pos"] == int(jc["pos"]) == 32
        _close(tl, jl, 1e-4)
        for _ in range(5):
            jt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            tt = tl[:, -1].argmax(-1)[:, None].to(torch.int32)
            assert np.array_equal(tt.numpy(), jt)
            jl, jc = jdec(jp, jc, jnp.asarray(jt))
            tl, tc = ttf.decode_step(model, tc, tt, tcfg)
            _close(tl, jl, 1e-4)
        assert tc["pos"] == int(jc["pos"]) == 37


def test_hubert_encoder_logits_match_jax():
    """HuBERT SMOKE's encoder (bidirectional attention over 48 projected
    frames, its 64 targets padded to 512 and masked) against the JAX
    ``forward``: logits within 1e-4, no loss mask."""
    jcfg, tcfg, jp, model = _model(AUDIO)
    b = jmake_batch(jcfg, "prefill", 48, 2, seed=5)
    tb = make_batch(tcfg, "prefill", 48, 2, seed=5)
    jl, _, _, jmask = jax.jit(lambda p, b: jtf.forward(p, b, jcfg))(jp, b)
    with torch.inference_mode():
        tl, _, _, tmask = ttf.forward(model, tb, tcfg)
    assert jmask is None and tmask is None
    assert tl.shape == (2, 48, tcfg.padded_vocab)
    valid = slice(0, tcfg.vocab_size)
    _close(tl[..., valid], jl[..., valid], 1e-4)
    assert bool((tl[..., tcfg.vocab_size:] == -1e30).all())


@pytest.mark.parametrize("name", [AUDIO, VISION])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_frontends_bit_equal(name, kind):
    """Frames, patch embeddings (bf16, compared bit for bit), tokens and
    labels equal to the JAX ``make_batch`` at three seeds."""
    jcfg, tcfg = _cfgs(name)
    for seed in (0, 7, 1_000_003 * 2 + 5):
        j = jmake_batch(jcfg, kind, 48, 3, seed=seed)
        t = make_batch(tcfg, kind, 48, 3, seed=seed)
        assert set(j) == set(t)
        for k in j:
            assert t[k].device.type == "cpu"
            if t[k].dtype == torch.bfloat16:
                assert np.asarray(j[k]).dtype.name == "bfloat16"
                assert np.array_equal(_bf16_bits(t[k]), _bf16_bits(j[k]))
            else:
                assert t[k].dtype == torch.int32
                assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_input_specs_match_jax(name):
    """``input_specs`` of each config x each of the four shape cells has
    the JAX ``input_specs``' names, shapes and dtypes, on the meta
    device."""
    cfg, jcfg = get_arch(name), jget_arch(name)
    assert set(SHAPES) == set(JSHAPES)
    for cell in SHAPES:
        want = jinput_specs(jcfg, JSHAPES[cell])
        got = input_specs(cfg, SHAPES[cell])
        assert set(got) == set(want), cell
        for k, spec in want.items():
            assert tuple(got[k].shape) == spec.shape, (cell, k)
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype)
            assert got[k].device.type == "meta"


def test_serve_launcher_refuses_the_encoder():
    """``python -m repro_torch.launch.serve --arch hubert-xlarge`` stops
    with the config's name: an encoder has no decode path."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only"):
        serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("name,leaf", [
    (MLA, "w_uk"), (MLA, "kv_norm"), (AUDIO, "proj"), (VISION, "proj")])
def test_params_from_jax_checks_mla_and_frontend_leaves(name, leaf):
    """The MLA parameters and ``frontend.proj`` cross unchanged; a missing
    or misshapen one raises ValueError naming it, as the other leaves
    do (tests/test_torch_lm.py)."""
    jcfg, tcfg = _cfgs(name)
    jp = _np_tree(jtf.init_params(jcfg, jax.random.key(0)))
    st = params_from_jax(jp, tcfg, device="cpu")
    if leaf == "proj":
        assert np.array_equal(st["frontend.proj"].numpy(),
                              jp["frontend"]["proj"])
        bad = dict(jp, frontend={"proj": jp["frontend"]["proj"][:, :-1]})
        gone = {k: v for k, v in jp.items() if k != "frontend"}
    else:
        assert np.array_equal(st[f"layers.1.attn.{leaf}"].numpy(),
                              jp["layers"]["attn"][leaf][1])
        attn = jp["layers"]["attn"]
        bad = dict(jp, layers=dict(jp["layers"], attn=dict(
            attn, **{leaf: attn[leaf][..., :-1]})))
        gone = dict(jp, layers=dict(jp["layers"], attn={
            k: v for k, v in attn.items() if k != leaf}))
    with pytest.raises(ValueError, match=leaf):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match=f"missing.*{leaf}"):
        params_from_jax(gone, tcfg, device="cpu")
