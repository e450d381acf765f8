"""The port's placement rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), with no process group.

For every config of ``repro.configs.ALL_ARCHS`` at full width, the four
spec functions run on ``jax.sharding.AbstractMesh`` (no devices) and on
the port's ``launch.mesh.AbstractMesh`` at the six mesh shapes below; the
JAX trees come from ``jax.eval_shape`` (nothing allocated), the port's
from meta tensors.  The JAX package stacks the layers on a leading L axis
and the port keeps one tensor a layer, so a layer tensor's JAX spec is
compared with its L entry dropped.  Tolerance: none (the specs are
names).

``place`` is held on every position of a mesh: the shards of a tensor
tile it exactly.  ``gather`` needs ranks; ``tests/test_torch_dist_lm.py``
round-trips it over gloo.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import ALL_ARCHS
from repro.configs import get_arch as jget_arch
from repro.launch import sharding as jshd
from repro.models import transformer as jtf
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch.configs.base import get_arch
from repro_torch.convert import jax_key
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.models import transformer as tf

SHAPES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((2, 4), ("data", "model"))]
BATCHES = (1, 2, 6, 8, 32, 512)
CACHE_BATCH, CACHE_LEN = 8, 96


def _jmesh(shape, names):
    try:
        return JMesh(shape, names)
    except TypeError:                  # older jax: ((name, size), ...)
        return JMesh(tuple(zip(names, shape)))


def _jpath(path):
    return jshd._path_str(path)


def _jflat(tree):
    """{"/"-joined path: tuple spec} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_jpath(p): tuple(s) for p, s in leaves}


def _want(jflat, name):
    """The JAX spec of the port's ``name``, its L entry dropped."""
    jname, layer = jax_key(name)
    sp = jflat[jname]
    return sp[1:] if layer is not None else sp


@pytest.fixture(scope="module")
def trees():
    """{arch: (JAX param shapes, JAX opt shapes, JAX cache shapes, port
    param shapes, port cache)} at full width."""
    out = {}
    for name in ALL_ARCHS:
        jcfg = jget_arch(name)
        jp = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
        jo = jax.eval_shape(jinit_opt, jp)
        jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, CACHE_BATCH,
                                                   CACHE_LEN))
        cfg = get_arch(name)
        pshapes = {k: s for k, (s, _) in tf.param_shapes(cfg).items()}
        cache = tf.init_cache(cfg, CACHE_BATCH, CACHE_LEN, device="meta")
        out[name] = (jcfg, jp, jo, jc, cfg, pshapes, cache)
    return out


@pytest.mark.parametrize("shape,names", SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in SHAPES])
def test_specs_equal_jax(trees, shape, names):
    """param_specs, opt_specs, data_specs and cache_specs equal the JAX
    package's for all 10 configs on this mesh shape."""
    jm, m = _jmesh(shape, names), AbstractMesh(shape, names)
    assert jshd.batch_axes(jm) == shd.batch_axes(m)
    for arch, (jcfg, jp, jo, jc, cfg, pshapes, cache) in trees.items():
        jps = jshd.param_specs(jcfg, jp, jm)
        ps = shd.param_specs(cfg, pshapes, m)
        jf = _jflat(jps)
        assert len(ps) == len(pshapes)
        for n in pshapes:
            assert ps[n] == _want(jf, n), (arch, shape, n, ps[n])
        jos = _jflat(jshd.opt_specs(jcfg, jo, jps, jm))
        os_ = shd.opt_specs(cfg, {s: pshapes for s in ("master", "m", "v")},
                            ps, m)
        assert os_["step"] == jos["step"] == ()
        for s in ("master", "m", "v"):
            for n in pshapes:
                want = _want({k[len(s) + 1:]: v for k, v in jos.items()
                              if k.startswith(s + "/")}, n)
                assert os_[s][n] == want, (arch, shape, s, n, os_[s][n])
        for kind in ("train", "prefill", "decode"):
            for B in BATCHES:
                batch = {"tokens": (B, 64), "labels": (B, 64),
                         "frames": (B, 64, 32)}
                jb = {k: jax.ShapeDtypeStruct(v, jnp.int32)
                      for k, v in batch.items()}
                jds = _jflat(jshd.data_specs(jb, jm, jcfg, kind))
                ds = shd.data_specs(batch, m, cfg, kind)
                assert ds == jds, (arch, shape, kind, B, ds, jds)
        jcs = _jflat(jshd.cache_specs(jcfg, jc, jm))
        cs = shd.cache_specs(cfg, cache, m)
        for n, sp in cs.items():
            assert sp == _want(jcs, n), (arch, shape, n, sp)
        assert {jax_key(n)[0] for n in cs} == set(jcs), arch


@pytest.mark.parametrize("shape,names", SHAPES[2:],
                         ids=["x".join(map(str, s)) for s, _ in SHAPES[2:]])
def test_place_shards_tile_the_tensor(shape, names):
    """On every position of the mesh, ``place`` cuts the shard the spec
    names: the positions' shards put back by their indices rebuild the
    tensor bit for bit, and positions that differ only on an axis the
    spec does not use hold equal shards."""
    g = np.random.default_rng(0)
    t = torch.tensor(g.integers(-2**31, 2**31 - 1, (8, 12, 4)),
                     dtype=torch.int32)
    specs = [(None, "model", None), ("data", None, "model"),
             (("data", "model"), None, None), (None, None, None),
             ("model", "data", None)]
    sizes = [range(s) for s in shape]
    for spec in specs:
        got = torch.full_like(t, -1)
        for c in itertools.product(*sizes):
            m = AbstractMesh(shape, names, coords=dict(zip(names, c)))
            sl = shd.shard_slices(tuple(t.shape), spec, m)
            piece = shd.place(t, spec, m)
            assert torch.equal(piece, t[sl])
            got[sl] = piece
        assert torch.equal(got, t), spec


def test_one_rank_mesh_needs_no_group():
    """(1, 1) is local: ``place`` and ``gather`` hand back the tensor
    whole, with no process group."""
    m = make_host_mesh(1, 1)
    assert not m.distributed and m.coords == {"data": 0, "model": 0}
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    p = shd.place(t, ("data", "model"), m)
    assert torch.equal(p, t) and p.data_ptr() != t.data_ptr()
    assert torch.equal(shd.gather(p, ("data", "model"), m), t)


def test_production_mesh_refuses_too_few_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match=r"needs 256 devices, found 1"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match=r"needs 512 devices, found 1"):
        make_production_mesh(multi_pod=True)


def test_multi_rank_entry_points_ask_for_cuda():
    """``spawn`` and the cluster with one process a node run on cuda unless
    given ``device="cpu"``: without a card they raise before any rank
    starts; the engine also needs a process group."""
    from repro_torch.core.cluster import DistClusterStarEngine
    from repro_torch.launch.mesh import choose_backend, spawn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            spawn(print, 2)
    with pytest.raises(RuntimeError, match="process group"):
        DistClusterStarEngine(8, 128, device="cpu")
    assert choose_backend("cpu", 4) == "gloo"
    assert choose_backend("cuda", 10 ** 6) == "gloo"  # ranks share a card
