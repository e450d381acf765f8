"""The port's dry run (``repro_torch.launch.dryrun``, the bundles of
``launch/steps.py`` and ``launch/roofline.py``) against the JAX package,
on the CPU with no process group and no allocation.

For every config x ``SHAPES`` cell x production mesh ((16, 16) and (2,
16, 16)): the skip decision equals the JAX ``cell_applicable``; one
rank's parameter and optimizer-state bytes equal those of the shard
shapes the JAX ``param_specs`` / ``opt_specs`` give on
``jax.sharding.AbstractMesh`` (the JAX trees by ``jax.eval_shape``);
``model_flops_for`` equals the JAX one.  At SMOKE size on a (1, 1) mesh
the dry run's bytes equal those of the trees ``LM(cfg, device="cpu")``,
``init_opt_state``, ``init_cache`` and ``make_batch`` really build.
Tolerance: none (byte counts).
"""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import ALL_ARCHS, SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_arch as jget_arch
from repro.launch import roofline as jroofline
from repro.launch import sharding as jshd
from repro.models import transformer as jtf
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch.configs.base import SHAPES, ShapeCell, get_arch
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import init_opt_state

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(shape, names):
    try:
        return JMesh(shape, names)
    except TypeError:                  # older jax: ((name, size), ...)
        return JMesh(tuple(zip(names, shape)))


def _jbytes(tree, specs, mesh) -> int:
    """One rank's bytes of a JAX tree of ShapeDtypeStructs under its spec
    tree: each dimension divided by the sizes of the axes it is split
    over."""
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(sp)
    total = 0
    for leaf, spec in zip(leaves, sp):
        n = leaf.dtype.itemsize
        for d, s in enumerate(leaf.shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            k = math.prod(mesh.shape[a] for a in axes)
            assert s % k == 0
            n *= s // k
        total += n
    return total


@pytest.fixture(scope="module")
def jax_bytes():
    """{(arch, multi_pod): (param bytes, opt bytes)} a rank, from the JAX
    specs."""
    out = {}
    for name in ALL_ARCHS:
        jcfg = jget_arch(name)
        jp = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0)))
        jo = jax.eval_shape(jinit_opt, jp)
        for multi_pod, (shape, names) in MESHES.items():
            jm = _jmesh(shape, names)
            jps = jshd.param_specs(jcfg, jp, jm)
            jos = jshd.opt_specs(jcfg, jo, jps, jm)
            out[(name, multi_pod)] = (_jbytes(jp, jps, jm),
                                      _jbytes(jo, jos, jm))
    return out


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_cells_equal_jax(jax_bytes, multi_pod):
    """The 40 cells of one mesh: skip decisions, per-rank parameter and
    optimizer-state bytes, model FLOPs; the records say what they cannot
    know (temporaries) and that the roofline has no collective term."""
    recs = dryrun.run_all(meshes=(multi_pod,), out_dir=None,
                          echo=lambda s: None)
    assert len(recs) == len(ALL_ARCHS) * len(SHAPES) == 40
    for rec in recs:
        arch, shape = rec["arch"], rec["shape"]
        jcfg, jcell = jget_arch(arch), JSHAPES[shape]
        ok, why = jcell_applicable(jcfg, jcell)
        assert (rec["status"] == "ok") == ok, (arch, shape)
        if not ok:
            assert rec["reason"] == why
            continue
        m = rec["mem"]
        want_p, want_o = jax_bytes[(arch, multi_pod)]
        assert m["bytes_per_rank"]["params"] == want_p, (arch, shape)
        if jcell.kind == "train":
            assert m["bytes_per_rank"]["opt_state"] == want_o, (arch, shape)
        assert rec["n_chips"] == math.prod(MESHES[multi_pod][0])
        assert m["temp_bytes"] is None and m["temp_note"]
        assert m["limit_bytes"] == dryrun.FIT_LIMIT_BYTES
        r = rec["roofline"]
        assert r["collective_s"] is None
        assert r["model_flops"] == jroofline.model_flops_for(jcfg, jcell)
        assert r["compute_s"] == r["model_flops"] / (
            rec["n_chips"] * roofline.PEAK_FLOPS)
        assert r["memory_s"] == m["argument_bytes"] / roofline.HBM_BW


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_bytes_equal_real_trees(arch):
    """On a (1, 1) mesh at SMOKE size, each tree's bytes equal those of
    the tensors the port really builds for that step."""
    cfg = get_arch(arch, smoke=True)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    model = tf.LM(cfg, device="cpu")
    state = model.state_dict()
    params = {k: state[k] for k in state}
    want = {"params": _nbytes(params),
            "opt_state": _nbytes(init_opt_state(params))}
    seq = 32 + (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    for kind in ("train", "prefill", "decode"):
        cell = ShapeCell(f"smoke_{kind}", kind, seq, 2)
        if cfg.is_encoder and kind == "decode":
            continue
        rec = dryrun.cell_record(cfg, cell, mesh)
        got = rec["mem"]["bytes_per_rank"]
        assert got["params"] == want["params"], (arch, kind)
        assert got["batch"] == _nbytes(make_batch(cfg, kind, seq, 2)), \
            (arch, kind)
        if kind == "train":
            assert got["opt_state"] == want["opt_state"], arch
            assert set(got) == {"params", "opt_state", "batch"}
        else:
            cache = tf.init_cache(cfg, 2, seq, device="cpu")
            assert got["cache"] == _nbytes(cache), (arch, kind)
        assert rec["mem"]["held_bytes"] == sum(got.values())
        # training, the whole gradients: in the parameters' dtypes beside
        # their float32 copy, or that copy beside the flat float32 buffer
        n = sum(t.numel() for t in params.values())
        grads = (max(want["params"] + 4 * n, 8 * n) if kind == "train"
                 else 0)
        assert rec["mem"]["grad_bytes_whole"] == grads, (arch, kind)
        assert rec["mem"]["held_bytes_whole_params"] == \
            rec["mem"]["held_bytes"] + grads    # (1, 1): nothing split


def test_cli_writes_one_record_per_cell(tmp_path, monkeypatch, capsys):
    """``--all --both-meshes``: 80 records, each a JSON file."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--all", "--both-meshes"]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 80
    assert "dryrun summary: ok=64 skipped=16" in capsys.readouterr().out
