"""PyTorch port vs JAX reference: ordered-index maintenance and scans
(bit-exact).  The port's CPU path runs the plain versions of the
index_merge and scan_window kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import as_numpy, assert_tree_equal, to_torch, tree_to_torch

from repro.core import ops as jops
from repro.kernels.index_merge.ref import segment_merge_ref
from repro.storage import IndexSpec as JSpec
from repro.storage import StorageEngine as JStore
from repro.storage.index import apply_index_ops as japply
from repro.storage.index import segment_scan as jscan
from repro_torch.kernels.index_merge.ops import index_merge
from repro_torch.storage.engine import StorageEngine as TStore
from repro_torch.storage.index import IndexSpec as TSpec
from repro_torch.storage.index import SENTINEL, make_index
from repro_torch.storage.index import apply_index_ops as tapply
from repro_torch.storage.index import segment_scan as tscan

S = SENTINEL
_jit_merge = jax.jit(jax.vmap(segment_merge_ref))


def _segments(rng, P, cap, key_space=60, full=False):
    key = np.full((P, cap), S, np.int32)
    prow = np.zeros((P, cap), np.int32)
    tid = np.zeros((P, cap), np.uint32)
    for p in range(P):
        n = cap if full else int(rng.integers(0, cap + 1))
        ks = np.sort(rng.choice(key_space, n, replace=False)).astype(np.int32)
        key[p, :n] = ks
        prow[p, :n] = rng.integers(0, 1000, n)
        tid[p, :n] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return key, prow, tid


def _merge_case(seed, kind):
    rng = np.random.default_rng(seed)
    # fixed shapes per kind: the JAX reference compiles once per shape
    P, cap = 3, 16
    Kd = 0 if kind == "empty_del" else 10
    Ki = 0 if kind == "empty_ins" else 10
    key, prow, tid = _segments(rng, P, cap, full=(kind == "full"))
    live = key[key != S]
    # deletes: present keys (duplicated), absent keys, masked slots
    dk = rng.integers(0, 60, (P, Kd)).astype(np.int32)
    if live.size and Kd:
        dk[:, : Kd // 2] = rng.choice(live, (P, Kd // 2))
    if Kd > 1:
        dk[:, -1] = dk[:, 0]                         # duplicate delete
    dk = np.where(rng.random((P, Kd)) < 0.2, S, dk).astype(np.int32)
    if kind == "full":
        dk[:] = S                                    # no holes to fill
    ik = np.where(rng.random((P, Ki)) < 0.7,
                  rng.integers(0, 60, (P, Ki)), S).astype(np.int32)
    ip = np.where(ik != S, rng.integers(0, 1000, (P, Ki)), 0).astype(np.int32)
    if kind == "ties":        # 3 keys, several of them existing, unsorted,
        ik = np.where(ik != S, rng.choice(live[:3] if live.size >= 3
                                          else [1, 2, 3], (P, Ki)),
                      S).astype(np.int32)
        ip = np.where(ik != S, np.arange(P * Ki).reshape(P, Ki) + 1000,
                      0).astype(np.int32)  # its own payload, above prow
    it = np.where(ik != S, rng.integers(0, 1 << 32, (P, Ki), dtype=np.uint64),
                  0).astype(np.uint32)
    return key, prow, tid, dk, ik, ip, it


@pytest.mark.parametrize("kind", ["mixed", "full", "empty_del",
                                  "empty_ins", "ties"])
@pytest.mark.parametrize("seed", range(6))
def test_index_merge_plain_matches_segment_merge_ref(seed, kind):
    key, prow, tid, dk, ik, ip, it = _merge_case(seed, kind)
    P = key.shape[0]
    # the reference pads an empty insert batch itself; an empty delete
    # batch is a SENTINEL column there (as the JAX wrapper pads it)
    jdk = dk if dk.shape[1] else np.full((P, 1), S, np.int32)
    ref = _jit_merge(*map(jnp.asarray, (key, prow, tid, jdk, ik, ip, it)))
    got = index_merge(*map(to_torch, (key, prow, tid, dk, ik, ip, it)))
    assert_tree_equal(tuple(ref), got)
    if kind == "full":        # every live insert overflows a full segment
        assert int(got[3].sum()) == int((ik != S).sum()) > 0
    if kind == "ties":        # tied inserts keep their column order
        k2, p2 = got[0].numpy(), got[1].numpy()
        for p in range(P):
            for k in np.unique(ik[p][ik[p] != S]):
                placed = p2[p][(k2[p] == k) & (p2[p] >= 1000)]
                assert list(placed) == list(ip[p][ik[p] == k][:len(placed)])


def _index_op_batch(rng, P, B, K, C=10):
    kinds = rng.choice([jops.INSERT_IDX, jops.DELETE_IDX,
                        jops.SCAN_CONSUME, jops.SCAN_READ, jops.READ],
                       (B, K)).astype(np.int32)
    delta = np.zeros((B, K, C), np.int32)
    part = rng.integers(0, P, (B, K))
    delta[..., jops.IX_KEY] = (part << 24) | rng.integers(0, 60, (B, K))
    delta[..., jops.IX_PROW] = rng.integers(0, 1000, (B, K))
    delta[..., jops.IX_EXPECT] = (part << 24) | rng.integers(0, 60, (B, K))
    delta[..., jops.IX_ID] = rng.integers(0, 2, (B, K))
    win = rng.random((B, K)) < 0.6
    tids = rng.integers(0, 1 << 32, (B, K), dtype=np.uint64).astype(np.uint32)
    return kinds, delta, win, tids


@pytest.mark.parametrize("seed", range(5))
def test_apply_index_ops_matches_jax(seed):
    rng = np.random.default_rng(seed)
    P, caps = 3, [20, 12]
    idx = []
    for c in caps:
        k, p, t = _segments(rng, P, c)
        k = np.where(k != S, k | (np.arange(P)[:, None] << 24), S)
        idx.append({"key": k.astype(np.int32), "prow": p, "tid": t})
    kinds, delta, win, tids = _index_op_batch(rng, P, 6, 4)
    jout, jov = japply([{f: jnp.asarray(v) for f, v in ix.items()}
                        for ix in idx], *map(jnp.asarray,
                                             (kinds, delta, win, tids)),
                       use_pallas=False)
    tout, tov = tapply(tree_to_torch(idx),
                       *map(to_torch, (kinds, delta, win, tids)))
    assert_tree_equal(jout, tout)
    assert int(jov) == int(tov)


@pytest.mark.parametrize("seed", range(4))
def test_segment_scan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    key, _, _ = _segments(rng, 1, 24)
    for _ in range(12):
        lo = int(rng.integers(-5, 70))
        hi = lo + int(rng.integers(0, 30))
        for n_slots in (1, 9):
            a = jscan(jnp.asarray(key[0]), jnp.int32(lo), jnp.int32(hi),
                      n_slots)
            b = tscan(to_torch(key[0]), lo, hi, n_slots)
            assert_tree_equal(tuple(a), b)


def test_make_index_defaults_to_cuda():
    """``make_index`` without a device asks for ``cuda``, as every entry
    point of the port does: here, with no card, it raises."""
    spec = TSpec("a", 8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_index(spec, 2)
    ix = make_index(spec, 2, device="cpu")
    assert ix["key"].device.type == "cpu"
    assert (ix["key"] == S).all() and not ix["prow"].any() \
        and not ix["tid"].any()
    assert ix["tid"].dtype == torch.int64


def test_storage_engine_range_scan_and_snapshots():
    rng = np.random.default_rng(3)
    P, R, C = 2, 16, 10
    specs_j = [JSpec("a", 16), JSpec("b", 8)]
    specs_t = [TSpec("a", 16), TSpec("b", 8)]
    init = rng.integers(0, 100, (P, R, C)).astype(np.int32)
    js = JStore(P, R, C, init_val=init, index_specs=specs_j)
    ts = TStore(P, R, C, init_val=init, index_specs=specs_t, device="cpu")
    for _ in range(3):
        kinds, delta, win, tids = _index_op_batch(rng, P, 4, 3)
        delta[..., jops.IX_ID] = rng.integers(0, 2, delta.shape[:2])
        js.apply_index_batch(*map(jnp.asarray, (kinds, delta, win, tids)))
        ts.apply_index_batch(*map(to_torch, (kinds, delta, win, tids)))
    for name in ("a", "b"):
        for p in range(P):
            lo = (p << 24) + int(rng.integers(0, 30))
            a = js.range_scan(name, p, lo, lo + 25)
            b = ts.range_scan(name, p, lo, lo + 25)
            assert_tree_equal(tuple(a), b)
    # two-version state: the snapshot is a copy, a revert restores it
    ts.snapshot_commit()
    before = {f: ts.indexes[0][f].clone() for f in ("key", "prow", "tid")}
    ts.val[0, 0, 0] += 1
    ts.indexes[0]["key"][0, 0] = -7
    assert not torch.equal(ts.val, ts.snapshot["val"])
    ts.revert_to_snapshot()
    assert torch.equal(ts.val, ts.snapshot["val"])
    assert np.array_equal(as_numpy(ts.val), init)
    for f, v in before.items():
        assert torch.equal(ts.indexes[0][f], v)
    assert ts.val.data_ptr() != ts.snapshot["val"].data_ptr()
