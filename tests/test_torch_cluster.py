"""PyTorch port vs JAX reference: ``core.cluster.ClusterStarEngine``.

The JAX cluster engine runs over a 4-device CPU mesh in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) with
``secondary=False``: its physical secondary copies fail to trace at every
mesh size (``jnp.roll`` over the sharded axis), so the reference holds
them nowhere.  Its ``scribble_node`` does not trace on the mesh either;
the script writes the same junk words through the host.  The subprocess
drives ``_torch_cluster_drive.drive`` — the same steps the port takes
here on the CPU — on YCSB (P = 8 x 128) and on the full TPC-C mix with its three indexes (P = 4, the configuration of
tests/test_cluster_streaming.py), and saves every epoch's metrics, every
copy and index segment after every step, to an ``.npz``.  The port's
``ClusterStarEngine(4, ..., secondary=False, device="cpu")`` must be
bit-equal on all of it (tolerance 0: every value is an integer; TID words
compared by value).  The carried-state test starts the port from the JAX
engine's state after 2 epochs (``convert.cluster_state_from_jax``).

The secondary copies are held against the port's own partial copy rolled
home-major at every fence, against the JAX single-host ``StarEngine`` for
the full copy, and against the same port run with ``secondary=False``.
"""
import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cluster_drive as drv
from repro.core.engine import StarEngine as JEngine
from repro.db import tpcc as jtpcc
from repro.db import ycsb as jycsb
from repro_torch.convert import cluster_state_from_jax
from repro_torch.core.cluster import ClusterStarEngine
from repro_torch.db import tpcc as ttpcc
from repro_torch.db import ycsb as tycsb

ROOT = Path(__file__).resolve().parents[1]
TPCC = dict(n_partitions=4, n_items=400, cust_per_district=40, order_ring=64,
            mix="full", delivery_gen_lag=256)
YCSB_P, YCSB_R, YCSB_TXNS, TPCC_TXNS = 8, 128, 128, 192
N_EPOCHS = 4
# the JAX subprocess: 4 CPU devices, each on one thread
XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers at once, whose thread pools would otherwise contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_JAX_SCRIPT = """
import sys
import jax
import numpy as np
import _torch_cluster_drive as drv
from repro.core.cluster import ClusterStarEngine
from repro.db import tpcc, ycsb

mesh = jax.make_mesh((4,), ("part",), devices=jax.devices()[:4])


class Adapter:
    def copies(self, eng):
        out = {}
        for c in ("part", "full"):
            out[f"{c}_val"] = np.asarray(getattr(eng, f"{c}_val"))
            out[f"{c}_tid"] = np.asarray(getattr(eng, f"{c}_tid"))
            for i, ix in enumerate(getattr(eng, f"{c}_idx")):
                for k in ("key", "prow", "tid"):
                    out[f"{c}_idx/{i}/{k}"] = np.asarray(ix[k])
        return out

    def load(self, eng, val, tid, idx):
        eng.load_committed(val, tid.astype(np.uint32), indexes=idx)

    def scribble_node(self, eng, node):
        # ClusterStarEngine.scribble_node's junk words, written through
        # the host: its .at[slice].set does not trace on the mesh (the
        # junk's broadcast to a block of ppn rows meets the 4-way
        # sharding of the partition axis)
        sl = eng.node_slice(node)

        def scrib(a):
            h = np.array(a)
            h[sl] = (np.uint32(0xDEAD) if h.dtype == np.uint32
                     else np.int32(-0x5A5A5A5))
            return jax.device_put(h, a.sharding)
        snap = dict(eng._snap)
        for name in ("part_val", "part_tid", "part_idx"):
            setattr(eng, name, jax.tree.map(scrib, getattr(eng, name)))
            snap[name] = jax.tree.map(scrib, snap[name])
        eng._snap = snap


out = {}
for name in ("ycsb", "tpcc"):
    if name == "ycsb":
        cfg, init, make, fb = drv.ycsb_batches(ycsb, %(YP)d, %(YR)d, %(YT)d)
        eng = ClusterStarEngine(mesh, %(YP)d, %(YR)d, secondary=False)
    else:
        cfg, init, make, fb = drv.tpcc_batches(tpcc, %(TC)r, %(TT)d)
        eng = ClusterStarEngine(mesh, cfg.n_partitions,
                                cfg.rows_per_partition, init_val=init,
                                indexes=tpcc.index_specs(cfg),
                                secondary=False)
    got = drv.drive(eng, make, fb, Adapter(), n_epochs=%(NE)d)
    out.update({f"{name}:{k}": v for k, v in got.items()})
np.savez(sys.argv[1], **out)
"""


class _PortAdapter:
    def copies(self, eng):
        out = {}
        for c in ("part", "full"):
            out[f"{c}_val"] = getattr(eng, f"{c}_val").numpy().copy()
            out[f"{c}_tid"] = getattr(eng, f"{c}_tid").numpy().copy()
            for i, ix in enumerate(getattr(eng, f"{c}_idx")):
                for k in ("key", "prow", "tid"):
                    out[f"{c}_idx/{i}/{k}"] = ix[k].numpy().copy()
        return out

    def load(self, eng, val, tid, idx):
        eng.load_committed(
            torch.tensor(val), torch.tensor(tid),
            indexes=None if idx is None else
            [{k: torch.tensor(v) for k, v in ix.items()} for ix in idx])

    def scribble_node(self, eng, node):
        eng.scribble_node(node)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX cluster engine's scripted run, both workloads; the port's
    runs are made while the subprocess works."""
    path = tmp_path_factory.mktemp("jax_cluster") / "ref.npz"
    script = _JAX_SCRIPT % dict(YP=YCSB_P, YR=YCSB_R, YT=YCSB_TXNS,
                                TC=TPCC, TT=TPCC_TXNS, NE=N_EPOCHS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_FLAGS,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(script),
                             str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        for name in ("ycsb", "tpcc"):
            _port_run(name)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port_engine(name, secondary=False, n_nodes=4):
    if name == "ycsb":
        cfg, init, make, fb = drv.ycsb_batches(tycsb, YCSB_P, YCSB_R,
                                               YCSB_TXNS)
        eng = ClusterStarEngine(n_nodes, YCSB_P, YCSB_R, secondary=secondary,
                                device="cpu")
    else:
        cfg, init, make, fb = drv.tpcc_batches(ttpcc, TPCC, TPCC_TXNS)
        eng = ClusterStarEngine(n_nodes, cfg.n_partitions,
                                cfg.rows_per_partition, init_val=init,
                                indexes=ttpcc.index_specs(cfg),
                                secondary=secondary, device="cpu")
    return eng, make, fb


_PORT = {}


def _port_run(name):
    """The port's scripted run (computed once a module) and the batches
    it ran."""
    if name not in _PORT:
        eng, make, fb = _port_engine(name)
        batches = []
        got = drv.drive(eng, make, fb, _PortAdapter(), n_epochs=N_EPOCHS,
                        batches=batches)
        _PORT[name] = (got, batches)
    return _PORT[name]


def _compare(ref, got, name, labels):
    keys = [k for k in ref if k.startswith(f"{name}:")
            and k.split(":", 1)[1].split("/")[0] in labels]
    assert keys, (name, labels)
    for k in keys:
        kk = k.split(":", 1)[1]
        assert kk in got, kk
        a, b = ref[k], got[kk]
        if a.dtype != np.bool_:
            a, b = a.astype(np.int64), b.astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype, (kk, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b), (kk, np.argwhere(a != b)[:5])
    got_labels = {k.split("/")[0] for k in got}
    ref_labels = {k.split(":", 1)[1].split("/")[0] for k in ref
                  if k.startswith(f"{name}:")}
    assert got_labels == ref_labels


STEPS = {
    "epochs": [f"ep{i}" for i in range(N_EPOCHS)],
    "commit_false_revert": ["doomed", "reverted", "redo"],
    "midstream_abort": ["abort", "abort_reverted", "after_abort"],
    "scribble_restore_full": ["scribbled", "restored_full"],
    "scribble_full_rebuild": ["scribbled_full", "rebuilt"],
    "load_committed": ["loaded", "after_load", "final"],
}


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("name", ["ycsb", "tpcc"])
def test_cluster_engine_bit_equal_to_jax(jax_run, name, step):
    """Every metric, copy and index segment of the step equal to the JAX
    cluster engine's (secondary=False, 4 nodes)."""
    got, _ = _port_run(name)
    _compare(jax_run, got, name, STEPS[step])
    # the engine-level surgery keeps its own invariants too
    if step == "midstream_abort":
        assert int(got["abort/aborted_at_slab"]) == 1
        assert int(got["abort/slabs_consumed"]) == 1
        assert int(got["abort_reverted/slabs_discarded"]) \
            == int(got["reverted/slabs_discarded"]) + 1
        ledger = [tuple(r) for r in got["after_abort/ledger"]]
        assert len(ledger) == len(set(ledger))            # exactly once
    if step == "scribble_restore_full":
        assert not bool(got["scribbled/consistent"])
        assert bool(got["restored_full/consistent"])
        assert np.array_equal(got["restored_full/part_val"],
                              got["after_abort/part_val"])
    if step == "load_committed":
        assert int(got["loaded/committed_epoch"]) \
            == int(got["loaded/epoch"]) - 1


@pytest.mark.parametrize("name", ["ycsb", "tpcc"])
def test_carried_state_from_jax(jax_run, name):
    """Start the port from the JAX cluster's committed state after 2
    epochs (``convert.cluster_state_from_jax``, uint32 TIDs), run the next
    2 epochs' batches on it, and hold it bit-equal to the JAX engine."""
    _, batches = _port_run(name)
    eng, _, _ = _port_engine(name)
    pre = f"{name}:ep1/"
    state = {}
    for c in ("part", "full"):
        state[f"{c}_val"] = jax_run[f"{pre}{c}_val"]
        state[f"{c}_tid"] = jax_run[f"{pre}{c}_tid"]
        assert state[f"{c}_tid"].dtype == np.uint32
        n_idx = sum(1 for k in jax_run if k.startswith(f"{pre}{c}_idx/")
                    and k.endswith("/key"))
        state[f"{c}_idx"] = [{k: jax_run[f"{pre}{c}_idx/{i}/{k}"]
                              for k in ("key", "prow", "tid")}
                             for i in range(n_idx)]
    cluster_state_from_jax(eng, state, epoch=int(jax_run[f"{pre}epoch"]))
    assert eng.epoch == 3 and eng.committed_epoch == 2 and eng.consistent()
    for ep in (2, 3):
        m = eng.run_epoch(copy.deepcopy(batches[ep]))
        for k in ("committed_single", "committed_cross", "p_committed",
                  "c_committed", "node_committed"):
            assert np.array_equal(np.asarray(m[k]),
                                  jax_run[f"{name}:ep{ep}/{k}"]), (ep, k)
        got = _PortAdapter().copies(eng)
        for k, v in got.items():
            want = jax_run[f"{name}:ep{ep}/{k}"].astype(np.int64)
            assert np.array_equal(v.astype(np.int64), want), (ep, k)
        assert eng.consistent()


def _roll(a, ppn):
    return torch.roll(a, ppn, dims=0)


@pytest.mark.parametrize("name", ["ycsb", "tpcc"])
def test_secondary_copies_against_primary_jax_star_and_secondary_off(name):
    """With physical secondary copies (the JAX path that does not run
    here): at every fence each secondary copy equals the port's partial
    copy rolled home-major, the full copy equals the JAX single-host
    ``StarEngine`` fed the same batches, and the partial and full copies
    equal the same port run with ``secondary=False`` (the scripted run's
    first epochs, on the same batches)."""
    eng, make, fb = _port_engine(name, secondary=True)
    off, _ = _port_run(name)
    assert eng.secondary
    if name == "ycsb":
        jcfg = jycsb.YCSBConfig(n_partitions=YCSB_P,
                                records_per_partition=YCSB_R)
        jeng = JEngine(YCSB_P, YCSB_R)
        jmake = lambda i: jycsb.make_batch(jcfg, YCSB_TXNS, seed=i)  # noqa
        jfb = lambda b, m: None                                     # noqa
    else:
        jcfg, jinit, jmake, jfb = drv.tpcc_batches(jtpcc, TPCC, TPCC_TXNS)
        jeng = JEngine(jcfg.n_partitions, jcfg.rows_per_partition,
                       init_val=jinit, indexes=jtpcc.index_specs(jcfg))
    for ep in range(3):
        b = make(ep)
        m = eng.run_epoch(b)
        fb(b, m)
        jb = jmake(ep)
        jm = jeng.run_epoch(jb)
        jfb(jb, jm)
        assert m["committed_single"] == jm["committed_single"]
        assert m["committed_cross"] == jm["committed_cross"]
        assert eng.consistent() and bool(off[f"ep{ep}/consistent"])
        ppn = eng.ppn
        assert torch.equal(eng.sec_val, _roll(eng.part_val, ppn))
        assert torch.equal(eng.sec_tid, _roll(eng.part_tid, ppn))
        for si, pi in zip(eng.sec_idx, eng.part_idx):
            for k in ("key", "prow", "tid"):
                assert torch.equal(si[k], _roll(pi[k], ppn))
        assert np.array_equal(eng.full_val.numpy(),
                              np.asarray(jeng.master["val"]))
        assert np.array_equal(eng.full_tid.numpy(),
                              np.asarray(jeng.master["tid"]).astype(np.int64))
        for fi, ji in zip(eng.full_idx, jeng.store.indexes):
            for k in ("key", "prow", "tid"):
                assert np.array_equal(fi[k].numpy(),
                                      np.asarray(ji[k]).astype(np.int64))
        for k, v in _PortAdapter().copies(eng).items():
            assert np.array_equal(v, off[f"ep{ep}/{k}"]), (ep, k)
        for k in ("p_committed", "c_committed", "node_committed",
                  "op_bytes_overlapped", "op_bytes_fence"):
            assert np.array_equal(np.asarray(m[k]), off[f"ep{ep}/{k}"]), k


def test_restore_blocks_from_secondary_reads_the_secondary_copy():
    """Node 0's block and the secondary copy it hosted are scribbled in the
    working state AND the snapshot; ``restore_blocks_from_secondary``
    must rebuild the block from node 1's physical secondary copy (the
    only surviving source), bit-equal to the block before the kill.  Read
    from the scribbled primary snapshot, or an alias of it, the block
    would hold junk."""
    eng, make, fb = _port_engine("tpcc", secondary=True)
    for ep in range(2):
        b = make(ep)
        fb(b, eng.run_epoch(b))
    before = _PortAdapter().copies(eng)
    sec_before = eng.sec_val.clone()
    eng.scribble_node(0)
    sl = eng.node_slice(0)
    for st in (eng._snap, eng._state()):
        assert bool((st["part_val"][sl] == -0x5A5A5A5).all())
        assert bool((st["part_tid"][sl] == 0xDEAD).all())
        assert bool((st["part_idx"][0]["key"][sl] == -0x5A5A5A5).all())
        # node 0 hosted node 3's secondary block: dead too
        assert bool((st["sec_val"][sl] == -0x5A5A5A5).all())
    # node 1 hosts node 0's secondary block: alive
    home = eng.node_slice(eng.sec_home(0))
    assert torch.equal(eng._snap["sec_val"][home], sec_before[home])
    eng.restore_blocks_from_secondary([0])
    after = _PortAdapter().copies(eng)
    for k, v in before.items():
        assert np.array_equal(after[k], v), k
    assert eng.consistent()
    # and the restored engine runs on, bit-equal to the scripted run,
    # which no kill touched, after the same 3 epochs
    ref, _ = _port_run("tpcc")
    b = make(2)
    fb(b, eng.run_epoch(b))
    for k, v in _PortAdapter().copies(eng).items():
        assert np.array_equal(v, ref[f"ep2/{k}"]), k
    assert eng.consistent()


def test_cluster_engine_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterStarEngine(2, 4, 16)
