"""Parity of the port's MoE FFN (``repro_torch.models.moe``) and the
``attn_moe`` block with the JAX package, on Granite-3.0-1B-A400M's SMOKE
config in float32, the JAX parameters carried across by
``convert.params_from_jax``.

Routing: ``torch.topk`` and ``lax.top_k`` may order equal gates otherwise,
so the routing ids are compared first, and a token routed otherwise must
show a tie (its k-th and (k+1)-th gates within 1e-5).  Tolerances: 1e-5
for the router's weights and the aux loss, 1e-5 for the MoE output and a
block (float32, sums in another order: the combine's scatter-add and the
expert products), logits 1e-4 and greedy tokens equal for ``generate``,
as tests/test_torch_lm.py holds the other configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine

ARCH = "granite-moe-1b-a400m"
F32 = np.float32


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    j = dataclasses.replace(jget_arch(ARCH, smoke=True), **kw)
    t = dataclasses.replace(get_arch(ARCH, smoke=True), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _same_routes(tids, jids, gates, k):
    """The ids are equal, or every token routed otherwise has a tie."""
    tids, jids = np.asarray(tids), np.asarray(jids)
    bad = (tids != jids).any(-1)
    if bad.any():
        top = -np.sort(-np.asarray(gates), axis=-1)[:, :k + 1]
        gap = top[bad, k - 1] - top[bad, k]
        print(f"{int(bad.sum())} tokens routed otherwise, gate gaps {gap}")
        assert (gap <= 1e-5).all(), gap


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    j, t = jget_arch(ARCH, smoke=smoke), get_arch(ARCH, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.n_params() == t.n_params()
    assert j.n_active_params() == t.n_active_params()


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
def test_route_and_moe_apply_match_jax(capacity_factor):
    """``route`` and ``moe_apply`` on 96 tokens: at capacity factor 1.0
    some experts overflow and drop tokens (the sorted order decides which),
    at 8.0 none does."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    p = jmoe.init_moe(jax.random.key(3), jcfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal((96, jcfg.d_model)).astype(F32)
    jw, jids, jaux = jmoe.route(p["router"], jnp.asarray(x), jcfg)
    tw, tids, taux = tmoe.route(_tt(p)["router"], torch.tensor(x), tcfg)
    gates = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _same_routes(tids, jids, gates, jcfg.top_k)
    _close(tw, jw, 1e-5)
    _close(taux, jaux, 1e-5)
    C = tmoe.moe_capacity(96, tcfg)
    assert C == jmoe.moe_capacity(96, jcfg)
    counts = np.bincount(np.asarray(jids).reshape(-1), minlength=jcfg.n_experts)
    assert (counts.max() > C) == (capacity_factor == 1.0)   # drops at 1.0
    jy, jaux2 = jmoe.moe_apply(p, jnp.asarray(x), jcfg, 0, jcfg.n_experts)
    ty, taux2 = tmoe.moe_apply(_tt(p), torch.tensor(x), tcfg, 0,
                               tcfg.n_experts)
    _close(ty, jy, 1e-5)
    _close(taux2, jaux2, 1e-5)
    # a slice of the experts (the expert-parallel body's view): half of them
    half = tcfg.n_experts // 2
    loc = {k: (v if k == "router" else v[half:]) for k, v in p.items()}
    jy, _ = jmoe.moe_apply(loc, jnp.asarray(x), jcfg, half, half)
    ty, _ = tmoe.moe_apply(_tt(loc), torch.tensor(x), tcfg, half, half)
    _close(ty, jy, 1e-5)


def test_attn_moe_block_matches_jax():
    """One ``attn_moe`` block (norm, GQA, the fused residual norm, the MoE
    FFN) on 2 x 40 tokens: output and aux loss."""
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jcfg, jax.random.key(0))
    lp = jax.tree.map(lambda a: a[1], jp["layers"])
    x = np.random.default_rng(5).standard_normal(
        (2, 40, jcfg.d_model)).astype(F32)
    pos = np.arange(40, dtype=np.int32)
    jy, _, jaux = jax.jit(lambda p, x: jtf.block_forward(
        p, x, jcfg, jnp.asarray(pos)))(lp, jnp.asarray(x))
    model = ttf.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu"))
    with torch.no_grad():
        ty, cache, taux = ttf.block_forward(model.layers[1], torch.tensor(x),
                                            tcfg, torch.tensor(pos))
    assert cache is None
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-5)


def test_generate_matches_jax():
    """JAX and port ``ServeEngine.generate``, greedy, 2 prompts of 40
    tokens and 6 new ones: tokens equal; then prefill and each decode step
    with the same token on both sides: logits within 1e-4."""
    jcfg, tcfg = _cfgs()
    jp = jtf.init_params(jcfg, jax.random.key(0))
    model = ttf.LM(tcfg, seed=1, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu"))
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    n, max_len = 6, 46
    jeng = JServeEngine(jcfg, jp, max_len=max_len)
    teng = ServeEngine(tcfg, model, device="cpu", max_len=max_len)
    jtok = np.asarray(jeng.generate(jnp.asarray(prompts), n))
    ttok = teng.generate(torch.tensor(prompts), n)
    assert np.array_equal(ttok.numpy(), jtok)
    jl, jc = jeng._prefill(jp, {"tokens": jnp.asarray(prompts)})
    with torch.inference_mode():
        tl, tc = ttf.prefill(model, {"tokens": torch.tensor(prompts)}, tcfg,
                             alloc_len=max_len)
        _close(tl, jl, 1e-4)
        for _ in range(n):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            jl, jc = jeng._decode(jp, jc, jnp.asarray(tok))
            tl, tc = ttf.decode_step(model, tc, torch.tensor(tok), tcfg)
            _close(tl, jl, 1e-4)
