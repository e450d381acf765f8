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
    log = {"row": rng.integers(0, N, (R, B, M)).astype(np.int32),
           "val": rng.integers(0, 99, (R, B, M, C)).astype(np.int32),
           "write": rng.random((R, B, M)) < 0.5}
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
