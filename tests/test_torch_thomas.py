"""PyTorch port vs JAX reference: the Thomas-write-rule merge (bit-exact),
against thomas_merge_ref and replication.thomas_apply."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import as_numpy, to_torch

from repro.core.replication import thomas_apply as jthomas_apply
from repro.kernels.thomas_merge.ref import thomas_merge_ref
from repro_torch.core.replication import thomas_apply_batch
from repro_torch.kernels.thomas_merge.ops import thomas_merge


def _stream(seed, N=48, K=96, C=6):
    rng = np.random.default_rng(seed)
    val = rng.integers(-2**31, 2**31, (N, C)).astype(np.int32)
    tid = rng.integers(0, 40, N).astype(np.uint32)
    rows = rng.integers(-1, N, K).astype(np.int32)      # -1 = skip
    rows[: K // 4] = rng.integers(0, 6, K // 4)          # duplicate rows
    wtids = rng.integers(0, 60, K).astype(np.uint32)     # distinct + ties
    wtids[:4] = 2**32 - 1 - np.arange(4)                 # near the top word
    wvals = rng.integers(-2**31, 2**31, (K, C)).astype(np.int32)
    # ties on one row carry equal values (one TID per transaction)
    for r in np.unique(rows[rows >= 0]):
        for t in np.unique(wtids[rows == r]):
            sel = (rows == r) & (wtids == t)
            wvals[sel] = wvals[sel][0]
    return val, tid, rows, wvals, wtids


@pytest.mark.parametrize("seed", range(6))
def test_thomas_merge_matches_ref_and_thomas_apply(seed):
    val, tid, rows, wvals, wtids = _stream(seed)
    args = tuple(map(jnp.asarray, (val, tid, rows, wvals, wtids)))
    rv, rt = thomas_merge_ref(*args)
    av, at, _ = jthomas_apply(*args)
    tv, tt = thomas_merge(*map(to_torch, (val, tid, rows, wvals, wtids)))
    for ref_v, ref_t in ((rv, rt), (av, at)):
        assert np.array_equal(np.asarray(ref_v), tv.numpy())
        assert np.array_equal(as_numpy(ref_t), as_numpy(tt))
    assert tt.dtype == torch.int64


def test_thomas_merge_updates_in_place_and_skips_stale():
    val = torch.zeros((4, 2), dtype=torch.int32)
    tid = torch.tensor([5, 5, 5, 5])
    rows = torch.tensor([0, 0, 1, -1, 2], dtype=torch.int32)
    wvals = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    wtids = torch.tensor([7, 6, 5, 9, 8])
    v, t = thomas_merge(val, tid, rows, wvals, wtids)
    assert v is val and t is tid
    assert val.tolist() == [[0, 1], [0, 0], [8, 9], [0, 0]]
    assert tid.tolist() == [7, 5, 8, 5]


def test_thomas_apply_batch_flattens_round_log():
    rng = np.random.default_rng(9)
    R, B, M, N, C = 3, 4, 5, 40, 3
    write = rng.random((R, B, M)) < 0.5
    # as the executor writes it: row -1 where the write did not commit
    log = {"row": np.where(write, rng.integers(0, N, (R, B, M)), -1
                           ).astype(np.int32),
           "val": rng.integers(0, 99, (R, B, M, C)).astype(np.int32),
           "write": write}
    log["tid"] = np.broadcast_to(
        (np.arange(R * B, dtype=np.uint32).reshape(R, B, 1) + 1) * 2,
        (R, B, M)).copy()
    val = np.zeros((N, C), np.int32)
    tid = np.zeros(N, np.uint32)
    from repro.core.replication import thomas_apply_batch as jbatch
    jv, jt, _ = jbatch(jnp.asarray(val), jnp.asarray(tid),
                       {k: jnp.asarray(v) for k, v in log.items()})
    tv, tt = thomas_apply_batch(to_torch(val), to_torch(tid),
                                {k: to_torch(v) for k, v in log.items()})
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(as_numpy(jt), as_numpy(tt))


# ---------------------------------------------------------------------------
# a numpy model of csrc/thomas_merge.cu
# ---------------------------------------------------------------------------
def kernel_model(val, tid, wrows, wvals, wtids, seed=0):
    """The kernel's three steps on numpy copies of ``val`` / ``tid``, for
    a flat stream (K,) in stream order: clear ``best`` (scratch left with
    garbage) at the live rows, atomicMax of (tid << 32) | (i + 1), apply
    the write whose index is in best[row] iff its TID exceeds the row's."""
    val, tid = val.numpy().copy(), tid.numpy().copy()
    N, C = val.shape
    row = wrows.numpy().astype(np.int64)
    wt = wtids.numpy().astype(np.uint64)
    K = row.shape[0]
    assert wvals.shape == (K, C)
    i = np.arange(K, dtype=np.int64)
    live = row >= 0
    best = np.random.default_rng(seed).integers(
        0, 2**63, N, dtype=np.int64).astype(np.uint64)
    best[row[live]] = 0
    packed = (wt << np.uint64(32)) | (i + 1).astype(np.uint64)
    np.maximum.at(best, row[live], packed[live])
    win = live.copy()
    win[live] = (best[row[live]] & np.uint64(0xffffffff)) \
        == (i[live] + 1).astype(np.uint64)
    win[win] = wt[win].astype(np.int64) > tid[row[win]]
    assert len(np.unique(row[win])) == win.sum()       # one writer a row
    val[row[win]] = wvals.numpy()[win]
    tid[row[win]] = wt[win].astype(np.int64)
    return val, tid


def _log(seed, R=3, B=8, M=6, N=40, C=4, ties_differ=True):
    """A (rounds, B, M) log as the executor writes it (row -1 where the
    write did not commit): heavy row duplication, equal TIDs on one row
    (with different values unless ``ties_differ`` is False), stale TIDs,
    TIDs at 2^32 - 1."""
    rng = np.random.default_rng(seed)
    row = rng.integers(-1, N, (R, B, M)).astype(np.int32)
    hot = rng.random((R, B, M)) < 0.5
    row[hot] = rng.integers(0, 4, int(hot.sum()))            # hot rows
    t = rng.integers(10, 30, (R, B, M)).astype(np.int64)
    t[rng.random((R, B, M)) < 0.1] = 2**32 - 1
    vals = rng.integers(-2**31, 2**31, (R, B, M, C)).astype(np.int32)
    if not ties_differ:
        for r in np.unique(row[row >= 0]):
            for tt in np.unique(t[row == r]):
                sel = (row == r) & (t == tt)
                vals[sel] = vals[sel][0]
    write = rng.random((R, B, M)) < 0.8
    row = np.where(write, row, -1).astype(np.int32)
    val = rng.integers(-9, 9, (N, C)).astype(np.int32)
    tid = rng.integers(0, 25, N).astype(np.int64)          # some stale writes
    tid[:2] = 2**32 - 1
    return val, tid, row, vals, t, write


def _jax_flat(val, tid, row, vals, t, write):
    """The JAX oracles: thomas_merge_ref and thomas_apply on the flattened
    stream, and thomas_apply_batch on the log."""
    from repro.core.replication import thomas_apply_batch as jbatch
    C = val.shape[1]
    args = (jnp.asarray(val), jnp.asarray(tid.astype(np.uint32)),
            jnp.asarray(row.reshape(-1)), jnp.asarray(vals.reshape(-1, C)),
            jnp.asarray(t.reshape(-1).astype(np.uint32)))
    rv, rt = thomas_merge_ref(*args)
    av, at, _ = jthomas_apply(*args)
    bv, bt, _ = jbatch(args[0], args[1], {
        "row": jnp.asarray(row), "val": jnp.asarray(vals),
        "tid": jnp.asarray(t.astype(np.uint32)), "write": jnp.asarray(write)})
    for v, tt in ((av, at), (bv, bt)):
        assert np.array_equal(np.asarray(rv), np.asarray(v))
        assert np.array_equal(np.asarray(rt), np.asarray(tt))
    return np.asarray(rv), as_numpy(rt)


def _views(row, vals, t):
    """The log as the executor stacks it (contiguous: its flattened view is
    the stream, no copy) and as non-contiguous views of wider arrays (a
    strided slice, a transposed view) holding the same writes in the same
    logical order, which flatten to a copy in stream order."""
    R, B, M = row.shape
    yield "contiguous", tuple(map(torch.tensor, (row, vals, t)))

    def wide(x):
        """x inside a (R, 2B, M + 3) array, at [:, ::2, 1:M+1]"""
        big = np.zeros((R, 2 * B, M + 3) + x.shape[3:], x.dtype)
        big[:, ::2, 1:M + 1] = x
        return torch.tensor(big)[:, ::2, 1:M + 1]
    yield "slice", tuple(map(wide, (row, vals, t)))

    def trans(x):
        """x stored as (M, B, R, ...) and permuted back"""
        perm = (2, 1, 0) + tuple(range(3, x.ndim))
        return torch.tensor(np.ascontiguousarray(x.transpose(perm))
                            ).permute(perm)
    yield "transposed", tuple(map(trans, (row, vals, t)))


@pytest.mark.parametrize("ties_differ", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_matches_jax_through_strides(seed, ties_differ):
    """The kernel's algorithm on the flattened (round, lane, op) stream,
    bit-equal to thomas_merge_ref, thomas_apply and the JAX
    thomas_apply_batch (last of equal TIDs wins), and the port's
    thomas_apply_batch the same, on the log and on strided views of it."""
    val, tid, row, vals, t, write = _log(seed, ties_differ=ties_differ)
    want_v, want_t = _jax_flat(val, tid, row, vals, t, write)
    C = val.shape[1]
    for what, (r, v, tt) in _views(row, vals, t):
        assert (what == "contiguous") == r.is_contiguous()
        flat = (r.reshape(-1), v.reshape(-1, C), tt.reshape(-1))
        assert (what == "contiguous") == (
            flat[0].data_ptr() == r.data_ptr())     # a view, not a copy
        mv, mt = kernel_model(torch.tensor(val), torch.tensor(tid), *flat,
                              seed=seed)
        assert np.array_equal(mv, want_v), what
        assert np.array_equal(mt, want_t), what
        pv, pt = thomas_apply_batch(torch.tensor(val), torch.tensor(tid),
                                    {"row": r, "val": v, "tid": tt})
        assert np.array_equal(pv.numpy(), want_v), what
        assert np.array_equal(pt.numpy(), want_t), what


def test_kernel_model_crafted_streams():
    """Every write to one row under one TID (the last wins), TIDs at or
    below the row's (none wins), 2^32 - 1 against 2^32 - 2, every row -1,
    an empty stream, one TID for every write, and two calls back to back
    (the second must not see the first's scratch)."""
    N, C, K = 6, 3, 9
    val = torch.zeros((N, C), dtype=torch.int32)
    tid = torch.tensor([5, 5, 5, 5, 2**32 - 2, 0])
    vals = torch.arange(K * C, dtype=torch.int32).reshape(K, C)
    cases = {
        "one row, one TID": (torch.full((K,), 2, dtype=torch.int32),
                             torch.full((K,), 7)),
        "stale": (torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, -1],
                               dtype=torch.int32),
                  torch.tensor([5, 4, 0, 5, 1, 5, 3, 2, 9])),
        "top TID": (torch.tensor([4, 4, 4, 5, 5, -1, 0, 4, 5],
                                 dtype=torch.int32),
                    torch.tensor([2**32 - 1, 2**32 - 2, 2**32 - 1, 2**32 - 1,
                                  3, 2**32 - 1, 6, 2**32 - 3, 2**32 - 1])),
        "all skipped": (torch.full((K,), -1, dtype=torch.int32),
                        torch.arange(K) + 100),
        "empty": (torch.zeros((0,), dtype=torch.int32),
                  torch.zeros((0,), dtype=torch.int64)),
        "one TID": (torch.tensor([1, 3, 1, 0, 3, 2, 1, 0, 0],
                                 dtype=torch.int32),
                    torch.full((K,), 8)),
    }
    for what, (rows, tids) in cases.items():
        v = vals[: rows.shape[0]]
        args = tuple(map(jnp.asarray, (val.numpy(), tid.numpy().astype(
            np.uint32), rows.numpy(), v.numpy(), tids.numpy().astype(
                np.uint32))))
        want_v, want_t = thomas_merge_ref(*args)
        mv, mt = kernel_model(val, tid, rows, v, tids)
        assert np.array_equal(mv, np.asarray(want_v)), what
        assert np.array_equal(mt, as_numpy(want_t)), what
        pv, pt = thomas_merge(val.clone(), tid.clone(), rows, v, tids)
        assert np.array_equal(pv.numpy(), mv), what
        assert np.array_equal(pt.numpy(), mt), what
    # one row, one TID: the last write's values
    rows, tids = cases["one row, one TID"]
    mv, mt = kernel_model(val, tid, rows, vals, tids)
    assert mv[2].tolist() == vals[-1].tolist() and mt[2] == 7
    # two calls back to back: the second starts from the first's table,
    # with other garbage in its scratch
    (r1, t1), (r2, t2) = cases["top TID"], cases["stale"]
    m1 = kernel_model(val, tid, r1, vals, t1, seed=1)
    m2 = kernel_model(torch.tensor(m1[0]), torch.tensor(m1[1]), r2, vals,
                      t2 + 3, seed=2)
    p = thomas_merge(val.clone(), tid.clone(), r1, vals, t1)
    p = thomas_merge(*p, r2, vals, t2 + 3)
    assert np.array_equal(m2[0], p[0].numpy())
    assert np.array_equal(m2[1], p[1].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_thomas_apply_batch_on_a_single_master_log(seed):
    """A log the port's single-master executor wrote, merged into a replica
    table by the port's thomas_apply_batch and by the JAX one, and by the
    kernel's model on the log's flattened views (which copy nothing)."""
    from test_torch_occ import _case

    from repro.core.replication import thomas_apply_batch as jbatch
    from repro_torch.core.single_master import run_single_master as tsm
    from _torch_util import tree_to_torch
    rng, txns, index, val0, tid0, n_rows = _case(seed)
    _, _, out, _ = tsm(to_torch(val0), to_torch(tid0), tree_to_torch(txns),
                       2, max_rounds=4, index=tree_to_torch(index))
    log = {k: out["log"][k] for k in ("row", "val", "tid", "write")}
    assert log["row"].dim() == 3 and bool(log["write"].any())
    # the executor's log is what the kernel reads in place: contiguous,
    # int32 rows and int64 TIDs, row -1 wherever the write flag is off
    assert all(log[k].is_contiguous() for k in ("row", "val", "tid"))
    assert log["row"].dtype == torch.int32 and log["tid"].dtype == torch.int64
    assert bool((log["row"][~log["write"]] == -1).all())
    C = val0.shape[1]
    flat = (log["row"].reshape(-1), log["val"].reshape(-1, C),
            log["tid"].reshape(-1))
    # the replica as it stood (the master's start) and one with newer TIDs
    for tid in (tid0, rng.integers(0, 2**32, n_rows).astype(np.uint32)):
        jv, jt, _ = jbatch(jnp.asarray(val0), jnp.asarray(tid),
                           {k: jnp.asarray(v.numpy().astype(np.uint32)
                                           if k == "tid" else v.numpy())
                            for k, v in log.items()})
        tv, tt = thomas_apply_batch(to_torch(val0), to_torch(tid), log)
        mv, mt = kernel_model(to_torch(val0), to_torch(tid), *flat)
        for v, t in ((tv.numpy(), as_numpy(tt)), (mv, mt)):
            assert np.array_equal(np.asarray(jv), v)
            assert np.array_equal(as_numpy(jt), as_numpy(t))
