"""Parity of the PyTorch port's LM serving slice with the JAX package:
layers, the GQA and Mamba-2 mixers, and ``ServeEngine.generate`` on the
SMOKE configs of Hymba-1.5B, Granite-8B, Mamba2-130M, GLM-4-9B (partial
RoPE), StarCoder2-7B (a 32-token window under 40-token prompts: the ring
cache; an un-gated gelu MLP), DBRX-132B (MoE, 4 experts top-2),
MiniCPM3-4B (MLA) and InternVL2-26B (on tokens; its patches are in
tests/test_torch_mla_frontends.py) in float32, with the JAX parameters
carried across by ``convert.params_from_jax``.  HuBERT-XLarge, an
encoder, has no decode cache and no generate.

The port computes attention, the SSD scan and RMSNorm through its kernel
wrappers (their plain versions on the CPU) where the JAX model computes
them in XLA.  Module tolerances: 1e-5 for layers and attention (float32,
sums in another order), 1e-4 for the SSD mixer (as tests/test_kernels.py
allows the SSD kernel: a sequential scan against the chunked algorithm).
Whole model: logits within 1e-4 at every step; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba2 as jm2
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine

F32 = np.float32
ARCHS = ("hymba-1.5b", "granite-8b", "mamba2-130m", "glm4-9b",
         "starcoder2-7b", "dbrx-132b", "minicpm3-4b", "internvl2-26b")
ALL = ARCHS + ("hubert-xlarge",)


def _cfgs(name, **kw):
    """The same reduced config on both sides, float32."""
    kw = dict(dtype="float32", **kw)
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
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_configs_match_jax(name):
    for smoke in (False, True):
        j, t = jget_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.n_params() == t.n_params()


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_matches_jax(name):
    """An empty decode cache has the JAX cache's per-layer shapes, types
    and empty slots."""
    jcfg, tcfg = _cfgs(name)
    jc = jtf.init_cache(jcfg, 3, 40)
    tc = ttf.init_cache(tcfg, 3, 40, device="cpu")
    assert tc["pos"] == int(jc["pos"]) == 0
    assert len(tc["layers"]) == tcfg.n_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc["layers"])[0]:
        t = tc["layers"][1]
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape[1:], path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        assert np.array_equal(t.numpy(), np.asarray(leaf[1])), path


def test_unported_blocks_raise():
    """Every block and frontend of the JAX package builds now: MLA
    (``mla_mlp``, minicpm3-4b), the MoE block, the audio and vision stubs.
    What is left is refused by name: a config name that does not exist,
    a block or a frontend the package does not have."""
    from repro_torch.configs.base import ALL_ARCHS, ArchConfig
    cfg = ArchConfig(name="x", family="dense", source="-", block="mla_mlp",
                     q_lora_rank=8, kv_lora_rank=8, qk_nope_head_dim=8,
                     qk_rope_head_dim=8, v_head_dim=8)
    assert set(ttf.LM(cfg, device="cpu").layers[0].attn) >= {
        "w_dq", "w_uk", "w_uv", "w_kr"}
    assert get_arch("minicpm3-4b").block == "mla_mlp"
    for name in ALL_ARCHS:
        ttf.LM(get_arch(name, smoke=True), device="cpu")
    assert "proj" in ttf.LM(get_arch("hubert-xlarge", smoke=True),
                            device="cpu").frontend
    moe = ArchConfig(name="x", family="moe", source="-", block="attn_moe",
                     n_experts=4, top_k=2)
    assert len(ttf.LM(moe, device="cpu").layers[0].moe) == 4
    with pytest.raises(ValueError, match="no-such-arch"):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="'x_block'"):
        ttf.LM(dataclasses.replace(cfg, block="x_block"), device="cpu")
    with pytest.raises(ValueError, match="'x_stub'"):
        ttf.LM(dataclasses.replace(cfg, frontend="x_stub"), device="cpu")


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_rope_and_mlp_match_jax(frac):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(F32)
    pos = np.arange(5, 12, dtype=np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None],
                              10_000.0, frac)
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos)[None],
                             10_000.0, frac)
    _close(got, want, 1e-5)
    for act, gated in (("silu", True), ("gelu", False)):
        p = jlayers.init_mlp(jax.random.key(1), 16, 32, gated, jnp.float32)
        h = rng.standard_normal((2, 5, 16)).astype(F32)
        _close(tlayers.mlp_forward(_tt(p), torch.tensor(h), act),
               jlayers.mlp_forward(p, jnp.asarray(h), act), 1e-5)


def test_rms_norm_layer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(F32)
    r = rng.standard_normal((2, 5, 24)).astype(F32)
    w = rng.standard_normal(24).astype(F32)
    _close(tlayers.rms_norm(torch.tensor(x), torch.tensor(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    y, s = tlayers.rms_norm(torch.tensor(x), torch.tensor(w),
                            residual=torch.tensor(r))
    _close(s, x + r, 0)
    _close(y, jlayers.rms_norm(jnp.asarray(x + r), jnp.asarray(w)), 1e-6)


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [0, 8])
def test_attention_matches_jax(pad):
    """Prefill and three decode steps; ``pad=8`` gives an irregular
    padded-head layout (5 query heads over 1 kv head padded to 8 over 2,
    kv_index_map [0,0,0,0,0,1,1,1]), the shape of Hymba's 25 -> 32."""
    kw = dict(n_heads=5, n_kv_heads=1, pad_heads_to=8) if pad else {}
    jcfg, tcfg = _cfgs("hymba-1.5b", **kw)
    p = jattn.init_attention(jax.random.key(0), jcfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 40, jcfg.d_model)).astype(F32)
    pos = np.arange(40, dtype=np.int32)
    (jy, (jk, jv)) = jax.jit(jattn.attention_forward, static_argnums=2)(
        p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    (ty, (tk, tv)) = tattn.attention_forward(_tt(p), torch.tensor(x), tcfg,
                                             torch.tensor(pos))
    _close(ty, jy, 1e-5)
    _close(tk, jk, 1e-5)
    jc = jattn.init_attn_cache(jcfg, 2, 48, jnp.float32)
    jdec = jax.jit(lambda p, x, c: jattn.attention_decode(p, x, c, jcfg))
    tc = tattn.init_attn_cache(tcfg, 2, 48, torch.float32, "cpu")
    for step in range(3):
        xs = np.random.default_rng(step + 1).standard_normal(
            (2, 1, jcfg.d_model)).astype(F32)
        jc["pos"] = jnp.asarray(40 + step, jnp.int32)
        tc["pos"] = 40 + step
        jy, jc = jdec(p, jnp.asarray(xs), jc)
        ty, tc = tattn.attention_decode(_tt(p), torch.tensor(xs), tc, tcfg)
        _close(ty, jy, 1e-5)
        assert np.array_equal(tc["slot_pos"].numpy(),
                              np.asarray(jc["slot_pos"]))


@pytest.mark.parametrize("name,S", [("mamba2-130m", 48), ("hymba-1.5b", 40)])
def test_mamba2_matches_jax(name, S):
    """Chunked prefill through the SSD kernel's wrapper (S=40 with
    ssm_chunk 16 runs chunks of 10, the largest divisor), the decode state
    it leaves, and three recurrent decode steps."""
    jcfg, tcfg = _cfgs(name)
    p = jm2.init_mamba2(jax.random.key(0), jcfg, jnp.float32)
    p = dict(p, A_log=jnp.linspace(-1.0, 1.0, jcfg.n_ssm_heads),
             dt_bias=jnp.linspace(-0.5, 0.5, jcfg.n_ssm_heads))
    x = np.random.default_rng(0).standard_normal(
        (2, S, jcfg.d_model)).astype(F32)
    assert tm2.ssm_chunk(tcfg, S) == (16 if S == 48 else 10)
    jy, jst = jax.jit(lambda p, x: jm2.mamba2_forward(
        p, x, jcfg, return_state=True))(p, jnp.asarray(x))
    jdec = jax.jit(lambda p, x, c: jm2.mamba2_decode(p, x, c, jcfg))
    ty, tst = tm2.mamba2_forward(_tt(p), torch.tensor(x), tcfg,
                                 return_state=True)
    _close(ty, jy, 1e-4)
    _close(tst["h"], jst["h"], 1e-4)
    _close(tst["conv"], jst["conv"], 1e-5)
    for step in range(3):
        xs = np.random.default_rng(step + 1).standard_normal(
            (2, 1, jcfg.d_model)).astype(F32)
        jy, jst = jdec(p, jnp.asarray(xs), jst)
        ty, tst = tm2.mamba2_decode(_tt(p), torch.tensor(xs), tst, tcfg)
        _close(ty, jy, 1e-4)
        _close(tst["h"], jst["h"], 1e-4)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_jax(name):
    """JAX and port ``ServeEngine.generate``, greedy, on 2 prompts of 40
    tokens (past Hymba's 32-token window, so its ring cache wraps) and 6
    new tokens: the tokens are equal.  Then prefill and each decode step
    with the same token fed to both sides: the logits agree within 1e-4."""
    jcfg, tcfg = _cfgs(name)
    jp = jtf.init_params(jcfg, jax.random.key(0))
    model = ttf.LM(tcfg, seed=1, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jp), tcfg, device="cpu"))
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    n, max_len = 6, 46
    jeng = JServeEngine(jcfg, jp, max_len=max_len)
    teng = ServeEngine(tcfg, model, device="cpu", max_len=max_len)
    jtok = np.asarray(jeng.generate(jnp.asarray(prompts), n))
    ttok = teng.generate(torch.tensor(prompts), n)
    assert ttok.dtype == torch.int32 and ttok.shape == (2, n)
    assert np.array_equal(ttok.numpy(), jtok)
    assert teng.stats.prefill_tokens == 80 and teng.stats.decoded_tokens == 12

    jl, jc = jeng._prefill(jp, {"tokens": jnp.asarray(prompts)})
    with torch.inference_mode():
        tl, tc = ttf.prefill(model, {"tokens": torch.tensor(prompts)}, tcfg,
                             alloc_len=max_len)
        _close(tl, jl, 1e-4)
        for step in range(n):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            jl, jc = jeng._decode(jp, jc, jnp.asarray(tok))
            tl, tc = ttf.decode_step(model, tc, torch.tensor(tok), tcfg)
            _close(tl, jl, 1e-4)
        assert tc["pos"] == int(jc["pos"]) == 40 + n


def test_sampling_uses_the_given_generator():
    _, cfg = _cfgs("granite-8b")
    eng = ServeEngine(cfg, ttf.LM(cfg, device="cpu"), device="cpu",
                      max_len=24)
    prompts = torch.randint(0, cfg.vocab_size, (3, 16))
    outs = [eng.generate(prompts, 5, greedy=False,
                         generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (3, 5) and (outs[0] < cfg.vocab_size).all()


def test_load_params_thomas_rule():
    """A newer TID swaps the weights in; an older or equal one is
    refused and leaves them as they are."""
    _, cfg = _cfgs("hymba-1.5b")
    eng = ServeEngine(cfg, ttf.LM(cfg, seed=0, device="cpu"), device="cpu")
    new = ttf.LM(cfg, seed=1, device="cpu").state_dict()
    old = ttf.LM(cfg, seed=2, device="cpu").state_dict()
    assert eng.load_params(new, tid=5)
    assert torch.equal(eng.model.embed, new["embed"])
    assert not eng.load_params(old, tid=4)
    assert not eng.load_params(old, tid=5)
    assert torch.equal(eng.model.embed, new["embed"])
    assert eng.params_tid == 5 and eng.stats.param_swaps == 1


def test_params_from_jax_checks_shapes():
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jp = _np_tree(jtf.init_params(jcfg, jax.random.key(0)))
    st = params_from_jax(jp, tcfg, device="cpu")
    assert st["layers.1.attn.wq"].shape == (tcfg.d_model, tcfg.n_heads,
                                            tcfg.d_head)
    assert st["layers.0.ssm.conv_w"].shape[0] == tcfg.ssm_conv_width
    assert np.array_equal(st["layers.1.ssm.in_proj"].numpy(),
                          jp["layers"]["ssm"]["in_proj"][1])
    bad = dict(jp, embed=jp["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tcfg, device="cpu")
    bad = dict(jp, layers=dict(jp["layers"], extra=np.zeros((2, 3))))
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(bad, tcfg, device="cpu")
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    st = params_from_jax(bf, tcfg, device="cpu")
    assert st["embed"].dtype == torch.bfloat16
    assert torch.equal(st["embed"].float(),
                       torch.tensor(np.asarray(bf["embed"], F32)))


def test_serve_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.launch import serve
    _, cfg = _cfgs("mamba2-130m")
    with pytest.raises(RuntimeError, match="cuda"):
        ttf.LM(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ttf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, ttf.LM(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "mamba2-130m", "--smoke"])
    out = serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert out.shape == (2, 3)
