"""The port's model side over several processes (``torch.distributed``,
gloo, on the CPU): MoE's expert-parallel branch, ``generate`` with experts
over ``model``, the trainer on a mesh, and ``reshard``.

Each spawn is bounded (``launch.mesh.spawn``: a ``FileStore`` in
``tmp_path``, one intra-op thread a rank, a 60 s group timeout, a parent
deadline that kills the children); the rank bodies are
``tests/_torch_dist_ranks.py``.  Several checks share one spawn.

Tolerances, each with its reason:
- the expert-parallel branch: 2e-4 absolute, the bound
  ``tests/test_multidevice.py`` holds the JAX branch to, against the port
  on one device and against the JAX branch on 8 forced CPU devices, mesh
  (2, 4), run in one subprocess (the partial outputs are summed in
  another order);
- ``generate``: token-equal;
- trainer steps on a mesh against one device, Granite-MoE SMOKE in
  float32, the one-device batch run as one microbatch a data shard (the
  mesh averages the shards' losses, and MoE's aux loss is a statistic of
  a shard's tokens, as the JAX branch's average over the batch axes makes
  it): losses and gradient norms within 1e-5 relative (the gradient
  is summed over ranks in another order); parameters within 2 x the sum
  of the steps' learning rates, and leaf by leaf 99.9 % of them within
  1e-6, for the reason ``tests/test_torch_train.py`` gives (Adam's
  normalised step moves a coordinate whose gradient is at the noise level
  by up to lr either way);
- ``reshard``, the state on the new mesh and the next step against a
  trainer built on that mesh from the same state, and a disk checkpoint
  restored on the mesh: bit-equal (placement moves bytes; the same mesh
  runs the same arithmetic).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import _torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parents[1]
TOL_EP = 2e-4
TOL_LOSS = 1e-5
TOL_Q = 1e-6

_JAX_EP = """
import contextlib, dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.launch.mesh import make_host_mesh
from repro.models.moe import moe_forward
z = np.load(sys.argv[1])
cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m", smoke=True),
                          capacity_factor=8.0)
p = {k: jnp.asarray(z["p_" + k]) for k in %(keys)r}
x = jnp.asarray(z["x"])
mesh = make_host_mesh(data=2, model=4)
ctx = jax.set_mesh(mesh) if hasattr(jax, "set_mesh") \\
    else contextlib.nullcontext()
with ctx:
    y, aux = jax.jit(lambda p, x: moe_forward(p, x, cfg, mesh=mesh))(p, x)
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
"""


def _inputs(path):
    """Granite-MoE SMOKE expert weights and a (4, 16, d) input from numpy
    (seed 0), float32."""
    cfg = ranks.moe_cfg()
    g = np.random.default_rng(0)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    z = {"p_router": g.normal(0, d ** -0.5, (d, E)),
         "p_w_up": g.normal(0, d ** -0.5, (E, d, ff)),
         "p_w_gate": g.normal(0, d ** -0.5, (E, d, ff)),
         "p_w_down": g.normal(0, ff ** -0.5, (E, ff, d)),
         "x": g.normal(0, 1, (4, 16, d))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in z.items()})
    return {k: v.astype(np.float32) for k, v in z.items()}


def _one_device(z):
    import torch
    from repro_torch.models.moe import moe_forward
    p = {k: torch.tensor(z[f"p_{k}"]) for k in ranks.MOE_KEYS}
    y, aux = moe_forward(p, torch.tensor(z["x"]), ranks.moe_cfg())
    return y.numpy(), float(aux)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX 8-device branch (a subprocess) and the 4- and 2-rank port
    runs, made while it works."""
    tmp = tmp_path_factory.mktemp("dist_lm")
    z = _inputs(tmp / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_EP % {
            "keys": ranks.MOE_KEYS}), str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        four = spawn(ranks.lm_four, 4, args=(str(tmp / "in.npz"),),
                     device="cpu", timeout_s=240, workdir=tmp / "four")
        two = spawn(ranks.lm_two, 2, args=(str(tmp / "ckpt"),),
                    device="cpu", timeout_s=120, workdir=tmp / "two")
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(tmp / "jax.npz") as j:
        jax_out = {k: j[k] for k in j.files}
    return z, jax_out, four, two


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_expert_parallel_matches_one_device_and_jax(runs, shape):
    """Each rank's rows of the branch's output over ``shape`` within 2e-4
    of the port on one device and of the JAX branch on 8 devices; ranks
    that differ only on ``model`` agree exactly; aux is the mean of the
    data shards' single-device aux."""
    z, jax_out, four, _ = runs
    y1, _ = _one_device(z)
    auxes = []
    for r in four:
        rows, y, aux, coords = r[f"ep{shape}"]
        assert np.abs(y - y1[rows]).max() < TOL_EP, (shape, coords)
        assert np.abs(y - jax_out["y"][rows]).max() < TOL_EP, (shape, coords)
        auxes.append(aux)
        peer = [q for q in four if q[f"ep{shape}"][3]["data"]
                == coords["data"]]
        assert all(np.array_equal(q[f"ep{shape}"][1], y) for q in peer)
    nd = shape[0]
    import torch
    from repro_torch.models.moe import moe_forward
    p = {k: torch.tensor(z[f"p_{k}"]) for k in ranks.MOE_KEYS}
    x = torch.tensor(z["x"])
    want = np.mean([float(moe_forward(p, s, ranks.moe_cfg())[1])
                    for s in x.chunk(nd)])
    assert np.allclose(auxes, want, rtol=1e-6, atol=0)
    if shape == (2, 2):      # the JAX branch's aux over its (2, 4) mesh
        assert abs(want - float(jax_out["aux"])) < 1e-5


def test_place_gather_round_trip_and_generate(runs):
    """``gather(place(t))`` bit-equal on (1, 4) and (2, 2); ``generate``
    on Granite-MoE SMOKE with its 8 experts over ``model`` = 4 (2 a rank)
    token-equal to the run without a mesh, on every rank."""
    _, _, four, _ = runs
    for r in four:
        assert r["round_trip(1, 4)"] and r["round_trip(2, 2)"]
        one, ep, e_loc = r["generate"]
        assert e_loc == 2 and one.shape == (2, 8)
        assert np.array_equal(one, ep)


def _close_to_one_device(one_h, tr_h, one, tr, n_steps):
    assert len(one_h) == len(tr_h) == n_steps
    for (l1, g1), (l2, g2) in zip(one_h, tr_h):
        assert abs(l1 - l2) <= TOL_LOSS * abs(l1), (l1, l2)
        assert abs(g1 - g2) <= TOL_LOSS * abs(g1), (g1, g2)
    assert one.keys() == tr.keys() and one["step"] == tr["step"] == n_steps
    lr_sum = sum(3e-4 * min(s / 100, 1.0) for s in range(1, n_steps + 1))
    for k in one:
        if k == "step":
            continue
        d = np.abs(one[k] - tr[k])
        assert d.max() <= 2 * lr_sum + 1e-6, (k, d.max())
        if k.startswith(("p/", "master/")):
            assert np.quantile(d, 0.999) <= TOL_Q, (k, np.quantile(d, 0.999))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_trainer_steps_on_a_mesh_match_one_device(runs, shape):
    """3 steps of Granite-MoE SMOKE on the mesh beside 3 on one device (the
    same batches); every rank holds the same whole state."""
    _, _, four, two = runs
    res = four if shape == (2, 2) else two
    key = f"train{shape}" if shape != (2, 2) else "train(2, 2)"
    for r in res:
        one_h, tr_h, one, tr = r[key]
        _close_to_one_device(one_h, tr_h, one, tr, 3)
    whole = [r[key][3] for r in res]
    assert all(ranks._same(whole[0], w) for w in whole[1:])
    if shape == (2, 2):
        assert all(r["stored_shards"] for r in four)


def test_disk_checkpoint_on_a_mesh_restores_the_fence(runs):
    """On (2, 1) the fence's disk checkpoint holds the whole state (written
    by rank 0); a new trainer on the mesh restores it bit-equal to the
    committed epoch, as its shards."""
    _, _, _, two = runs
    for r in two:
        assert r["restore"] == (2, True, True)


def test_reshard_keeps_state_bit_equal(runs):
    """``reshard`` (2, 2) -> (4, 1) -> (1, 1): the state and the committed
    epoch bit-equal across each, the next step bit-equal to a step of a
    trainer built on the new mesh from the same state, and the revert on
    the last mesh back to the committed epoch."""
    _, _, four, _ = runs
    for r in four:
        assert r["reshard"] == [(True, True, True, True)] * 2, r["reshard"]
        assert r["revert"] == (4, True)
