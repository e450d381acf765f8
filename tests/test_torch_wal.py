"""PyTorch port vs JAX reference: durability (WAL + fuzzy checkpoint +
recovery) and the hash index.

The reference's tests (tests/test_wal_hashtable.py) run on the port; two
parity tests hold the port to the reference's on-disk format: the JAX and
the port's engines, fed the same 6 epochs with durability on, write
byte-equal WAL directories, and the JAX ``recover_full`` and the port's
restore the same state from them, indexes included.  Every port object is
built with ``device="cpu"``; tolerance 0.
"""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import as_numpy

from repro.core.engine import StarEngine as JEngine
from repro.db import hashtable as jht
from repro.db import tpcc as jtpcc
from repro.db import ycsb as jycsb
from repro.db import wal as jwal
from repro_torch.convert import to_numpy_state
from repro_torch.core.engine import StarEngine
from repro_torch.db import hashtable as ht
from repro_torch.db import tpcc, ycsb
from repro_torch.db.wal import (MAGIC, Durability, WriteAheadLog, recover,
                                recover_full, write_checkpoint)


def test_wal_checkpoint_recover_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    N, C = 64, 4
    val = rng.integers(0, 100, (N, C)).astype(np.int32)
    tid = (rng.integers(1, 50, N).astype(np.uint32)) * 2
    write_checkpoint(tmp_path, val, tid, epoch=3)
    wal = WriteAheadLog(tmp_path, worker_id=0)
    cur_val, cur_tid = val.copy(), tid.copy()
    for epoch in (3, 4, 5):
        rows = rng.choice(N, 10, replace=False)
        vals = rng.integers(0, 100, (10, C)).astype(np.int32)
        tids = (np.full(10, 1000 * epoch, np.uint32)
                + np.arange(10).astype(np.uint32)) * 2
        cur_val[rows] = vals
        cur_tid[rows] = tids
        # the port's callers hand tensors with int64 TID words
        wal.append(torch.as_tensor(rows), torch.as_tensor(vals),
                   torch.as_tensor(tids.astype(np.int64)),
                   torch.ones(10, dtype=torch.bool))
        wal.flush(epoch)
    wal.close()
    rec_val, rec_tid, e_c = recover(tmp_path, device="cpu")
    assert e_c == 3
    assert rec_tid.dtype == torch.int64
    assert np.array_equal(rec_val.numpy(), cur_val)
    assert np.array_equal(rec_tid.numpy(), cur_tid)
    # the reference reads the port's files
    jv, jt, je = jwal.recover(tmp_path)
    assert je == 3 and np.array_equal(np.asarray(jv), cur_val)
    assert np.asarray(jt).dtype == np.uint32
    assert np.array_equal(np.asarray(jt), cur_tid)


def test_recovery_replay_any_order(tmp_path):
    N, C = 16, 3
    write_checkpoint(tmp_path, np.zeros((N, C), np.int32),
                     np.zeros(N, np.uint32), epoch=1)
    w0 = WriteAheadLog(tmp_path, worker_id=0)
    w1 = WriteAheadLog(tmp_path, worker_id=1)
    w0.append([0], np.full((1, C), 7, np.int32), np.asarray([4], np.uint32),
              [True])
    w1.append([0], np.full((1, C), 9, np.int32), np.asarray([8], np.uint32),
              [True])
    w0.flush(1); w1.flush(1); w0.close(); w1.close()
    for seed in (None, 0, 1, 2):
        rec_val, rec_tid, _ = recover(tmp_path, shuffle_seed=seed,
                                      device="cpu")
        assert int(rec_val[0, 0]) == 9 and int(rec_tid[0]) == 8
    # a log from before the record-kind format is refused
    (tmp_path / "wal_007.log").write_bytes(b"OLD!" + bytes(8))
    with pytest.raises(ValueError, match="WAL2"):
        WriteAheadLog(tmp_path, worker_id=7)
    assert (tmp_path / "wal_000.log").read_bytes()[:4] == MAGIC


@pytest.mark.parametrize("seed", range(8))
def test_hash_index_roundtrip(seed):
    """The reference's property test on the port's index, on its fallback's
    8 seeded examples."""
    rng = np.random.default_rng(seed)
    n_keys = int(rng.integers(1, 201))
    keys = rng.choice(100_000, n_keys, replace=False).astype(np.int32)
    rows = np.arange(n_keys, dtype=np.int32)
    idx = ht.insert(ht.make_index(1024, device="cpu"), keys, rows)
    assert np.array_equal(ht.lookup(idx, torch.as_tensor(keys)).numpy(),
                          rows)
    absent = (keys + 100_000).astype(np.int32)
    assert (ht.lookup(idx, torch.as_tensor(absent)).numpy() == -1).all()


@pytest.mark.parametrize("n_slots,probes", [(1024, 32), (256, 4)])
def test_hash_index_parity(n_slots, probes):
    """Slot arrays and lookups equal to the reference's; the small table
    makes keys collide and run past ``max_probes``."""
    rng = np.random.default_rng(n_slots)
    keys = rng.choice(100_000, 200, replace=False).astype(np.int32)
    rows = np.arange(200, dtype=np.int32)
    jidx = jht.insert(jht.make_index(n_slots), jnp.asarray(keys),
                      jnp.asarray(rows), max_probes=probes)
    tidx = ht.insert(ht.make_index(n_slots, device="cpu"), keys, rows,
                     max_probes=probes)
    for f in ("key", "row"):
        assert np.array_equal(np.asarray(jidx[f]), tidx[f].numpy()), f
    q = np.concatenate([keys, keys + 100_000])
    got = ht.lookup(tidx, torch.as_tensor(q), max_probes=probes).numpy()
    assert np.array_equal(
        np.asarray(jht.lookup(jidx, jnp.asarray(q), max_probes=probes)), got)
    if probes == 4:
        assert (got[:200] != rows).any()     # collisions past the probes


# ---------------------------------------------------------------------------
# live-execution durability: engine -> WAL -> recover, end to end
# ---------------------------------------------------------------------------
def _replica(eng):
    return to_numpy_state(eng.replica_store)


def test_engine_durability_recover_bit_identical_every_fence(tmp_path):
    cfg = ycsb.YCSBConfig(n_partitions=4, records_per_partition=64)
    dur = Durability(tmp_path, n_workers=4, checkpoint_every=3)
    eng = StarEngine(4, 64, durability=dur, device="cpu")
    for ep in range(7):
        eng.run_epoch(ycsb.make_batch(cfg, 96, seed=ep))
        assert eng.replica_consistent()
        rv, rt, e_c = recover(tmp_path, shuffle_seed=1000 + ep,
                              device="cpu")
        want = _replica(eng)
        assert np.array_equal(rv.numpy(), want["val"]), ep
        assert np.array_equal(rt.numpy(), want["tid"]), ep
    assert dur.checkpoints >= 1, "cadence checkpoint never fired"
    assert dur.entries_logged > 0
    dur.close()


def test_engine_durability_crash_recover_resume(tmp_path):
    cfg = ycsb.YCSBConfig(n_partitions=2, records_per_partition=48)
    dur = Durability(tmp_path, n_workers=2, checkpoint_every=2)
    eng = StarEngine(2, 48, durability=dur, device="cpu")
    for ep in range(4):
        eng.run_epoch(ycsb.make_batch(cfg, 64, seed=ep))
    committed_val = eng.snapshot["val"].clone()
    committed_tid = eng.snapshot["tid"].clone()
    dur.close()                                     # crash: process gone

    rv, rt, e_c = recover(tmp_path, shuffle_seed=7, device="cpu")
    assert torch.equal(rv, committed_val) and torch.equal(rt, committed_tid)

    dur2 = Durability(tmp_path, n_workers=2, checkpoint_every=2)
    eng2 = StarEngine(2, 48, durability=dur2, device="cpu")
    eng2.store.val, eng2.store.tid = rv, rt
    eng2.store.snapshot_commit()
    eng2.replica_store.load_state(eng2.store.snapshot)
    eng2.epoch = 5                                  # past the crash epoch
    for ep in range(4, 7):
        eng2.run_epoch(ycsb.make_batch(cfg, 64, seed=ep))
        assert eng2.replica_consistent()
        rv2, rt2, _ = recover(tmp_path, shuffle_seed=ep, device="cpu")
        assert torch.equal(rv2, eng2.replica_store.val), ep
        assert torch.equal(rt2, eng2.replica_store.tid), ep
    dur2.close()


def _tpcc_cfg(mod):
    return mod.TPCCConfig(n_partitions=2, n_items=400, cust_per_district=40,
                          order_ring=64, mix="full", delivery_gen_lag=256)


def test_engine_index_durability_recover_full_every_fence(tmp_path):
    cfg = _tpcc_cfg(tpcc)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(11), state=state)
    dur = Durability(tmp_path, n_workers=2, checkpoint_every=3)
    eng = StarEngine(cfg.n_partitions, cfg.rows_per_partition, init_val=init,
                     indexes=tpcc.index_specs(cfg), durability=dur,
                     device="cpu")
    for ep in range(5):
        eng.run_epoch(tpcc.make_batch(cfg, state, 128, seed=ep))
        assert eng.replica_consistent()
        rv, rt, ridx, e_c = recover_full(tmp_path, shuffle_seed=50 + ep,
                                         device="cpu")
        want = _replica(eng)
        assert np.array_equal(rv.numpy(), want["val"]), ep
        assert np.array_equal(rt.numpy(), want["tid"]), ep
        assert ridx is not None and len(ridx) == 3
        for i in range(3):
            for k in ("key", "prow", "tid"):
                assert np.array_equal(as_numpy(ridx[i][k]),
                                      as_numpy(eng.replica_store
                                               .indexes[i][k])), (ep, i, k)
    assert dur.checkpoints >= 1, "cadence checkpoint never fired"
    dur.close()


# ---------------------------------------------------------------------------
# the on-disk format against the reference
# ---------------------------------------------------------------------------
def _run_both(workload, jdir, tdir, epochs=6):
    """The JAX and the port's engines, durability on, fed the same
    batches; returns the port's engine."""
    if workload == "ycsb":
        cfg = jycsb.YCSBConfig(n_partitions=4, records_per_partition=64)
        engines = (JEngine(4, 64, durability=jwal.Durability(
                       jdir, n_workers=3, checkpoint_every=4)),
                   StarEngine(4, 64, device="cpu", durability=Durability(
                       tdir, n_workers=3, checkpoint_every=4)))
        batches = [jycsb.make_batch(cfg, 96, seed=ep) for ep in range(epochs)]
        for b in batches:
            for e in engines:
                e.run_epoch(b)
        return engines
    sides = []
    for mod, eng_cls, wal_mod, d, kw in (
            (jtpcc, JEngine, jwal, jdir, {}),
            (tpcc, StarEngine, None, tdir, {"device": "cpu"})):
        cfg = _tpcc_cfg(mod)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(3), state=state)
        dur = (wal_mod.Durability if wal_mod else Durability)(
            d, n_workers=2, checkpoint_every=5)
        sides.append((mod, cfg, state, eng_cls(
            cfg.n_partitions, cfg.rows_per_partition, init_val=init,
            indexes=mod.index_specs(cfg), durability=dur, **kw)))
    for ep in range(epochs):
        # the epoch after the last checkpoint is small: the reference
        # replays its index chunks op group by op group, eagerly
        n = 96 if ep < epochs - 1 else 24
        for mod, cfg, state, eng in sides:
            b = mod.make_batch(cfg, state, n, seed=ep)
            mod.apply_consume_feedback(state, b, eng.run_epoch(b))
    return tuple(s[3] for s in sides)


@pytest.fixture(scope="module", params=["ycsb", "tpcc_full"])
def wal_dirs(request, tmp_path_factory):
    jdir = tmp_path_factory.mktemp(f"jax_{request.param}")
    tdir = tmp_path_factory.mktemp(f"port_{request.param}")
    je, te = _run_both(request.param, jdir, tdir)
    for e in (je, te):
        e.durability.close()
    return request.param, jdir, tdir, je, te


def test_wal_directories_byte_equal(wal_dirs):
    """6 epochs with durability on: the two engines' directories hold the
    same files, byte for byte (checkpoints, index checkpoints, logs)."""
    workload, jdir, tdir, je, te = wal_dirs
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "ckpt_meta.json" in names and "wal_000.log" in names
    if workload == "tpcc_full":
        assert "ckpt_idx2_tid.npy" in names
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert te.durability.entries_logged == je.durability.entries_logged > 0
    assert te.durability.checkpoints == je.durability.checkpoints >= 1


def test_recover_full_parity(wal_dirs):
    """The port's and the JAX ``recover_full`` on the port's directory, and
    the JAX one on its own: the same state as the engines committed,
    indexes included."""
    workload, jdir, tdir, je, te = wal_dirs
    tv, tt, tix, te_c = recover_full(tdir, shuffle_seed=5, device="cpu")
    want = to_numpy_state(te.store)
    assert np.array_equal(tv.numpy(), want["val"])
    assert np.array_equal(tt.numpy(), want["tid"])
    for d in (tdir, jdir):
        jv, jt, jix, je_c = jwal.recover_full(d, shuffle_seed=9)
        assert je_c == te_c
        assert np.array_equal(np.asarray(jv), want["val"])
        assert np.array_equal(np.asarray(jt), want["tid"])
        assert (jix is None) == (tix is None) == (workload == "ycsb")
        for a, b, w in zip(jix or [], tix or [], want["indexes"]):
            for f in ("key", "prow", "tid"):
                assert np.array_equal(np.asarray(a[f]), w[f]), f
                assert np.array_equal(as_numpy(b[f]), w[f].astype(np.int64))
