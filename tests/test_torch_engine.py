"""PyTorch port vs JAX reference: the TPC-C generator and one STAR epoch
end to end on the full five-transaction mix (bit-exact), plus the port's
import hygiene and device default.

Engine parity uses the setup of tests/test_tpcc_full.py: P=2, 400 items,
40 customers a district, order ring 64, batches of 192, against the JAX
``StarEngine(kernel="jnp")``; master, replica and the three indexes must be
bit-equal after every epoch and after a failure revert.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_util import as_numpy

from repro.core.engine import StarEngine as JEngine
from repro.db import tpcc as jtpcc
from repro_torch.convert import from_jax_state, to_numpy_state
from repro_torch.core.engine import StarEngine as TEngine
from repro_torch.db import tpcc as ttpcc
from repro_torch.storage.engine import StorageEngine

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(n_partitions=2, n_items=400, cust_per_district=40, order_ring=64,
           mix="full", delivery_gen_lag=256)
METRICS = ("committed_single", "committed_cross", "index_overflow",
           "starved")
MASKS = ("p_committed", "c_committed", "p_cskip", "c_cskip")


def _setup(mod, seed=7):
    cfg = mod.TPCCConfig(**CFG)
    state = mod.TPCCState(cfg)
    init = mod.init_values(cfg, np.random.default_rng(seed), state=state)
    return cfg, state, init


def _assert_tree(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_parity(seed):
    (jc, js, ji), (tc, ts, ti) = _setup(jtpcc, seed), _setup(ttpcc, seed)
    assert ji.dtype == ti.dtype and np.array_equal(ji, ti)
    for ep in range(2):
        jb = jtpcc.make_batch(jc, js, 96, seed=seed * 10 + ep)
        tb = ttpcc.make_batch(tc, ts, 96, seed=seed * 10 + ep)
        _assert_tree(jb, tb, f"batch{ep}")
    assert [s.capacity for s in jtpcc.index_specs(jc)] == \
        [s.capacity for s in ttpcc.index_specs(tc)]


def _assert_store_equal(jstore, tstore, tag):
    got = to_numpy_state(tstore)
    assert got["tid"].dtype == np.uint32
    assert np.array_equal(np.asarray(jstore.val), got["val"]), tag
    assert np.array_equal(np.asarray(jstore.tid), got["tid"]), tag
    for i, (a, b) in enumerate(zip(jstore.indexes, got["indexes"])):
        for f in ("key", "prow", "tid"):
            assert np.array_equal(np.asarray(a[f]), b[f]), (tag, i, f)


def test_engine_parity_full_mix_with_failure_revert():
    (jc, js, ji), (tc, ts, ti) = _setup(jtpcc), _setup(ttpcc)
    je = JEngine(jc.n_partitions, jc.rows_per_partition, init_val=ji,
                 indexes=jtpcc.index_specs(jc), kernel="jnp")
    te = TEngine(tc.n_partitions, tc.rows_per_partition, init_val=ti,
                 indexes=ttpcc.index_specs(tc), device="cpu")
    fences = []

    def run(ep, seed):
        jb = jtpcc.make_batch(jc, js, 192, seed=seed)
        tb = ttpcc.make_batch(tc, ts, 192, seed=seed)
        jm, tm = je.run_epoch(jb), te.run_epoch(tb)
        fences.append(te.replica_consistent())
        for k in METRICS:
            assert jm[k] == tm[k], (ep, k)
        for k in MASKS:
            assert np.array_equal(np.asarray(jm[k]), np.asarray(tm[k])), \
                (ep, k)
        _assert_store_equal(je.store, te.store, f"master@{ep}")
        _assert_store_equal(je.replica_store, te.replica_store,
                            f"replica@{ep}")

    for ep in range(4):
        run(ep, seed=ep)
    assert te.stats.committed_cross > 0
    for f in ("consume_skips", "user_aborts", "retries", "fences",
              "committed_single", "committed_cross", "index_overflow"):
        assert getattr(je.stats, f) == getattr(te.stats, f), f
    # a failure mid-epoch: scribble + revert to the last committed epoch
    jplan = je.inject_failure({1})
    tplan = te.inject_failure({1})
    assert (tplan.case.name, tplan.remaster, tplan.run_mode) == \
        (jplan.case.name, jplan.remaster, jplan.run_mode)
    _assert_store_equal(je.store, te.store, "master@revert")
    assert te.replica_consistent()
    assert te.recover_node(tplan) and te.replica_consistent()
    run(4, seed=400)
    assert all(fences)


def test_convert_round_trip_and_range_check():
    rng = np.random.default_rng(1)
    val = rng.integers(-2**31, 2**31, (2, 5, 3)).astype(np.int32)
    tid = rng.integers(0, 2**32, (2, 5), dtype=np.uint64).astype(np.uint32)
    ix = [{"key": np.sort(rng.integers(0, 99, (2, 4)), 1).astype(np.int32),
           "prow": rng.integers(0, 5, (2, 4)).astype(np.int32),
           "tid": rng.integers(0, 2**32, (2, 4),
                               dtype=np.uint64).astype(np.uint32)}]
    st = from_jax_state(val, tid, ix, device="cpu")
    assert st["tid"].dtype == torch.int64
    store = StorageEngine(2, 5, 3, index_specs=[], device="cpu")
    store.load_state(st)
    back = to_numpy_state(store)
    assert np.array_equal(back["val"], val)
    assert back["tid"].dtype == np.uint32
    assert np.array_equal(back["tid"], tid)
    out = to_numpy_state(st)
    for f in ("key", "prow", "tid"):
        assert np.array_equal(out["indexes"][0][f], ix[0][f])
    bad = dict(st, tid=st["tid"] + (1 << 32))
    with pytest.raises(ValueError):
        to_numpy_state(bad)
    with pytest.raises(TypeError):
        from_jax_state(val, tid.astype(np.int64), ix, device="cpu")


def test_import_hygiene():
    """Every port module and chip_smoke import without JAX or repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro') or m.startswith('jax')]\n"
        "assert not bad, bad\n"
        "assert len(mods) > 20, mods\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(1, 8, indexes=None)
    with pytest.raises(RuntimeError, match="cuda"):
        StorageEngine(1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_state(np.zeros((1, 2, 3), np.int32),
                       np.zeros((1, 2), np.uint32), [])
    eng = TEngine(1, 8, device="cpu")
    assert eng.store.val.device.type == "cpu"
    assert as_numpy(eng.store.tid).sum() == 0


def test_reference_faults_the_port_reproduces_or_fixes():
    """Two faults of the reference the port met (ROADMAP Queue 3).

    1. TPC-C NewOrder draws its items with replacement, so one transaction
       can write one stock row twice, against the executors' "one op per
       row per txn" invariant: the reference's sequential scatter keeps
       the last post-image and the port reproduces that (engine parity).
    2. The reference returns perf_counter timestamps as ``t_fence1_s`` /
       ``t_fence2_s``; the port returns the fence durations.
    """
    (jc, js, ji), (tc, ts, ti) = _setup(jtpcc), _setup(ttpcc)
    batch = jtpcc.make_batch(jc, js, 192, seed=0)
    rows, kinds = batch["ptxn"]["row"], batch["ptxn"]["kind"]
    dup = 0
    for p in range(rows.shape[0]):
        for t in range(rows.shape[1]):
            w = rows[p, t][kinds[p, t] == jtpcc.STOCK_DECR]
            dup += len(w) - len(np.unique(w))
    assert dup > 0, "some NewOrder writes one stock row twice"
    je = JEngine(jc.n_partitions, jc.rows_per_partition, init_val=ji,
                 indexes=jtpcc.index_specs(jc), kernel="jnp")
    te = TEngine(tc.n_partitions, tc.rows_per_partition, init_val=ti,
                 indexes=ttpcc.index_specs(tc), device="cpu")
    t_before = time.perf_counter()
    jm = je.run_epoch(batch)
    tm = te.run_epoch(ttpcc.make_batch(tc, ts, 192, seed=0))
    t_all = time.perf_counter() - t_before
    assert jm["t_fence1_s"] >= t_before          # a timestamp
    assert 0 <= tm["t_fence1_s"] <= t_all        # a duration
    assert 0 <= tm["t_fence2_s"] <= t_all
