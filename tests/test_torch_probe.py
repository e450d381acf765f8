"""The redesigned index probe and OCC round of the PyTorch port, on the CPU.

* A numpy model of ``csrc/scan_window.cu``'s warp-cooperative k-ary lower
  bound (its pivot rule, lane count and step bound, read from the source)
  against ``np.searchsorted(side="left")`` on ragged caps, SENTINEL-padded
  tails, duplicate keys and queries below or above every key.
* TPC-C-shaped parity (three indexes, P = 16, cap 2,880, B = 256, K = 12)
  of ``locate_index_ops`` and ``step_index_ops`` against the JAX
  reference's ``ref.py`` oracles.
* ``occ_round`` on caller-held lock arrays, Silo and Calvin, against the
  JAX ``occ_round_ref``; the arrays are all the sentinel lane after it.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import assert_tree_equal, to_torch, tree_to_torch
from test_occ_kernels import C, M, _random_index_workload

from repro.core.ops import (DELETE_IDX, IDX_OPS, INSERT_IDX, IX_EXPECT,
                            IX_HI, IX_ID, IX_LO, SCAN_CONSUME, SCAN_READ,
                            is_index_kind, writes_primary)
from repro.kernels.occ import ref as jref
from repro_torch.kernels.occ import ops as tocc
from repro_torch.kernels.occ import ref as tocc_ref
from repro_torch.storage.index import SENTINEL

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "scan_window.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


LANES, PARTS, STEPS = (_define("PROBE_LANES"), _define("PROBE_PARTS"),
                       _define("PROBE_STEPS"))


def kary_lower_bound(key, q):
    """The kernel's search for one query, lane by lane: pivots
    lo + (j + 1) * n // PARTS for lanes j, the ballot's popcount, then one
    key a lane once at most LANES slots remain.  Returns (lower bound,
    dependent load rounds)."""
    lo, hi = 0, len(key)
    rounds = 0
    for _ in range(STEPS):
        n = hi - lo
        if n <= LANES:
            break
        piv = lo + (np.arange(LANES) + 1) * n // PARTS
        c = int((key[piv] < q).sum())
        new_lo = lo if c == 0 else lo + c * n // PARTS + 1
        if c < LANES:
            hi = lo + (c + 1) * n // PARTS
        lo = new_lo
        rounds += 1
    assert hi - lo <= LANES, "the step bound left more than a warp's slots"
    lanes = np.arange(LANES)
    below = (lanes < hi - lo) & (key[np.minimum(lo + lanes, len(key) - 1)]
                                 < q)
    return lo + int(below.sum()), rounds + 1


def test_model_constants_are_the_kernels():
    assert (LANES, PARTS) == (32, 33)
    # PARTS ** STEPS parts cover any cap below 2^31 down to a warp
    n = 2 ** 31 - 1
    for _ in range(STEPS):
        n = -(-n // PARTS)
    assert n <= LANES


def _segment(rng, cap, fill, dups):
    live = rng.integers(-(1 << 20), 1 << 20, fill)
    if dups and fill:
        live = rng.choice(live[: max(1, fill // 4)], fill)
    key = np.full(cap, SENTINEL, np.int64)
    key[:fill] = np.sort(live)
    return key


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("fill", ["empty", "one", "half", "full"])
@pytest.mark.parametrize("cap", [1, 2, 31, 32, 33, 2880])
def test_kary_lower_bound_matches_searchsorted(cap, fill, dups):
    rng = np.random.default_rng(cap * 10 + len(fill) + dups)
    n = {"empty": 0, "one": 1, "half": cap // 2, "full": cap}[fill]
    key = _segment(rng, cap, n, dups)
    live = key[:n]
    qs = [SENTINEL, SENTINEL - 1, -(1 << 31), 0, (1 << 21)]
    if n:
        qs += [int(live.min()) - 1, int(live.max()) + 1]
        qs += [int(x) for x in rng.choice(live, min(n, 40))]
        qs += [int(x) + d for x in rng.choice(live, 10) for d in (-1, 1)]
    qs += [int(x) for x in rng.integers(-(1 << 21), 1 << 21, 40)]
    worst = 0
    for q in qs:
        got, rounds = kary_lower_bound(key, q)
        assert got == int(np.searchsorted(key, q, side="left")), (q, got)
        worst = max(worst, rounds)
    # 2,880 slots: 2,880 -> 88 -> 3 -> answer
    assert worst <= {2880: 3}.get(cap, 2 if cap > LANES else 1)


# ---------------------------------------------------------------------------
# TPC-C-shaped probes: three indexes, P = 16, cap 2,880, B = 256, K = 12
# ---------------------------------------------------------------------------
P_T, CAP_T, B_T, K_T, C_T = 16, 2880, 256, IDX_OPS, 10


def _tpcc_shaped(seed):
    """Three ordered indexes of 16 partitions x 2,880 slots (keys
    partition << 24 | local, distinct and sorted, SENTINEL tails; one
    table full, one nearly empty) and a round of 256 x 12 ops: scans,
    consumes, inserts and deletes aimed at live keys, gaps and past every
    key, primary ops, and IX_ID values outside [0, 3)."""
    rng = np.random.default_rng(seed)
    index = []
    for i, fill in enumerate(((0, 2880), (2880, 2881), (0, 40))):
        key = np.full((P_T, CAP_T), SENTINEL, np.int32)
        tid = np.zeros((P_T, CAP_T), np.uint32)
        prow = np.zeros((P_T, CAP_T), np.int32)
        for p in range(P_T):
            n = int(rng.integers(*fill))
            local = np.sort(rng.choice(1 << 16, n, replace=False))
            key[p, :n] = (p << 24) | local
            tid[p, :n] = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
            prow[p, :n] = rng.integers(0, 1 << 20, n)
        index.append({"key": key, "prow": prow, "tid": tid})
    kinds = rng.integers(0, 10, (B_T, K_T)).astype(np.int32)
    delta = rng.integers(-50, 50, (B_T, K_T, C_T)).astype(np.int32)
    iid = rng.choice([0, 1, 2, 0, 1, 2, -1, 3, 7], (B_T, K_T))
    part = rng.integers(-1, P_T + 2, (B_T, K_T))
    for b in range(B_T):
        for k in range(K_T):
            i = int(iid[b, k])
            p = int(np.clip(part[b, k], 0, P_T - 1))
            seg = index[i if 0 <= i < 3 else 0]["key"][p]
            live = seg[seg != SENTINEL]
            r = rng.random()
            if r < 0.4 and live.size:
                lo = int(rng.choice(live))
            elif r < 0.7:
                lo = int(part[b, k] << 24) + int(rng.integers(0, 1 << 16))
            elif r < 0.8:
                lo = SENTINEL
            else:
                lo = int(rng.integers(-(1 << 30), 1 << 30))
            delta[b, k, IX_LO] = lo
            delta[b, k, IX_HI] = min(lo + int(rng.integers(-2, 1 << 12)),
                                     SENTINEL)
            nxt = seg[np.searchsorted(seg, lo):][:1]
            delta[b, k, IX_EXPECT] = (int(nxt[0]) if nxt.size
                                      and rng.random() < 0.7 else lo)
            delta[b, k, IX_ID] = i
    return index, kinds, delta


@pytest.mark.parametrize("seed", range(2))
def test_locate_index_ops_tpcc_shaped_matches_ref(seed):
    index, kinds, delta = _tpcc_shaped(seed)
    n_rows = 4_376_496
    jix = [{k: jnp.asarray(v) for k, v in ix.items()} for ix in index]
    a = jref.locate_index_ops_ref(jix, jnp.asarray(kinds),
                                  jnp.asarray(delta), n_rows)
    b = tocc.locate_index_ops(tree_to_torch(index), to_torch(kinds),
                              to_torch(delta), n_rows)
    assert a["no_addr"] == b["no_addr"] == n_rows + P_T * CAP_T * 3
    assert_tree_equal({k: v for k, v in a.items() if k != "no_addr"},
                      {k: v for k, v in b.items() if k != "no_addr"})
    # the case reaches every output: claims, scans, consumes that pass
    assert int(b["scan_valid"].sum()) > 1000
    assert int((b["claim_addr"] < b["no_addr"]).sum()) > 500
    assert int(b["consume_ok"].sum()) > 20


@pytest.mark.parametrize("seed", range(2))
def test_step_index_ops_tpcc_shaped_matches_ref(seed):
    index, kinds, delta = _tpcc_shaped(100 + seed)
    jix = [{k: jnp.asarray(v) for k, v in ix.items()} for ix in index]
    for rows in (slice(0, P_T), slice(P_T, 2 * P_T)):
        a = jref.step_index_ops_ref(jix, jnp.asarray(kinds[rows]),
                                    jnp.asarray(delta[rows]))
        b = tocc.step_index_ops(tree_to_torch(index), to_torch(kinds[rows]),
                                to_torch(delta[rows]))
        assert_tree_equal(tuple(a), b)


def test_probe_reads_strided_op_slices():
    """The executors hand the probe kind[:, :K] and delta[:, :K] of the
    whole (rows, M, C) op arrays, views with a row stride of M ops."""
    index, kinds, delta = _tpcc_shaped(7)
    wide_k = np.concatenate([kinds, kinds[:, :5]], 1)
    wide_d = np.concatenate([delta, delta[:, :5]], 1)
    ti = tree_to_torch(index)
    tk, td = to_torch(wide_k)[:, :K_T], to_torch(wide_d)[:, :K_T]
    assert not tk.is_contiguous() and not td.is_contiguous()
    a = tocc.locate_index_ops(ti, to_torch(kinds), to_torch(delta), 99)
    b = tocc.locate_index_ops(ti, tk, td, 99)
    assert_tree_equal(a, b)
    assert_tree_equal(tocc.step_index_ops(ti, to_torch(kinds[:P_T]),
                                          to_torch(delta[:P_T])),
                      tocc.step_index_ops(ti, tk[:P_T], td[:P_T]))


# ---------------------------------------------------------------------------
# occ_round on caller-held lock arrays
# ---------------------------------------------------------------------------
K = min(IDX_OPS, M)


@pytest.mark.parametrize("with_ix", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_occ_round_on_held_lock_arrays_matches_ref(seed, deterministic,
                                                   with_ix):
    rng = np.random.default_rng(300 + seed)
    B, P, caps = 8, 2, (12, 16)
    n_rows = 64 * P
    txns, index = _random_index_workload(rng, B, P, n_rows, list(caps),
                                         conflict_rows=n_rows // 4)
    val0 = rng.integers(0, 50, (n_rows, C)).astype(np.int32)
    tid0 = rng.integers(0, 5, n_rows).astype(np.uint32) * 2
    kind, delta = txns["kind"], txns["delta"]
    active = txns["valid"] & ~txns["user_abort"]
    delta_v = delta.at[..., -1].set(0)
    wmask = writes_primary(kind) & active[:, None]
    amask = active[:, None] & (kind >= 0) & ~is_index_kind(kind)
    last = jnp.asarray(rng.integers(0, 2**32, B, dtype=np.uint64)
                       .astype(np.uint32))
    ix = has_claim = tix = thc = None
    NT = n_rows
    if with_ix:
        ix = jref.locate_index_ops_ref(index, kind[:, :K], delta[:, :K],
                                       n_rows)
        has_claim = (ix["claim_addr"] < ix["no_addr"]) & active[:, None]
        tix = {k: (v if k == "no_addr" else to_torch(v))
               for k, v in ix.items()}
        thc = to_torch(has_claim)
        NT = ix["no_addr"]
    a = jref.occ_round_ref(jnp.asarray(val0), jnp.asarray(tid0),
                           txns["row"], kind, delta_v, wmask, amask, active,
                           jnp.uint32(3), last, ix=ix, has_claim=has_claim,
                           deterministic=deterministic)
    lock, rlock = tocc.lock_arrays(NT + 1, B, deterministic, "cpu")
    assert (rlock is not None) == deterministic
    args = (to_torch(txns["row"]), to_torch(kind), to_torch(delta_v),
            to_torch(wmask), to_torch(amask), to_torch(active), 3,
            to_torch(last))
    b = tocc.occ_round(to_torch(val0), to_torch(tid0), *args, ix=tix,
                       has_claim=thc, deterministic=deterministic,
                       lock=lock, rlock=rlock)
    assert_tree_equal(tuple(a), b)
    for arr in (lock, rlock):
        assert arr is None or bool((arr == B).all())
    # the held arrays serve the next round as they are
    c = tocc.occ_round(to_torch(val0), to_torch(tid0), *args, ix=tix,
                       has_claim=thc, deterministic=deterministic,
                       lock=lock, rlock=rlock)
    assert_tree_equal(b, c)
    assert bool(b[2].any()), "no lane committed: the case tests nothing"


def test_occ_round_without_claims_leaves_everything():
    rng = np.random.default_rng(5)
    B, n_rows = 8, 128
    txns, _ = _random_index_workload(rng, B, 2, n_rows, [12],
                                     conflict_rows=32)
    val0 = torch.tensor(rng.integers(0, 50, (n_rows, C)).astype(np.int32))
    tid0 = torch.zeros(n_rows, dtype=torch.int64)
    none = torch.zeros((B, M), dtype=torch.bool)
    lock, rlock = tocc.lock_arrays(n_rows + 1, B, True, "cpu")
    val, tidw, commit, _, _, w = tocc.occ_round(
        val0.clone(), tid0.clone(), to_torch(txns["row"]),
        to_torch(txns["kind"]), to_torch(txns["delta"]), none, none,
        torch.zeros(B, dtype=torch.bool), 1, torch.zeros(B, dtype=torch.int64),
        deterministic=True, lock=lock, rlock=rlock)
    assert torch.equal(val, val0) and torch.equal(tidw, tid0)
    assert not commit.any() and not w.any()
    assert bool((lock == B).all()) and bool((rlock == B).all())


def test_locate_marks_kinds_outside_the_index_ops():
    """Ops that are not index ops, or name no index, resolve to the dump
    slot and fail consume, whatever their key; scans claim nothing."""
    index, kinds, delta = _tpcc_shaped(11)
    kinds[:] = np.where(np.arange(K_T) % 2, SCAN_READ, 0)
    kinds[:, 0] = SCAN_CONSUME
    kinds[:, 1] = INSERT_IDX
    kinds[:, 2] = DELETE_IDX
    delta[:, 3, IX_ID] = -1
    out = tocc.locate_index_ops(tree_to_torch(index), to_torch(kinds),
                                to_torch(delta), 10)
    off = out["no_addr"]
    assert bool((out["claim_addr"][:, 3:] == off).all())
    assert bool((out["scan_addr"][:, 3] == off).all())
    assert not out["scan_valid"][:, 4::2].any()
    assert not out["consume_ok"][:, 3].any()
    assert not out["consume_ok"][:, 4::2].any()


# ---------------------------------------------------------------------------
# the bare probe's halvings contract
# ---------------------------------------------------------------------------
def _bare_segments(seed, caps):
    """Concatenated sorted segments (SENTINEL-padded tails, duplicates) and
    four queries a segment: below, inside and above its keys."""
    rng = np.random.default_rng(seed)
    keys, tids, q, base, cap = [], [], [], [], []
    off = 0
    for c in caps:
        live = int(rng.integers(0, c + 1))
        seg = np.full(c, SENTINEL, np.int32)
        seg[:live] = np.sort(rng.integers(0, 50, live))
        keys.append(seg)
        tids.append(rng.integers(0, 2**32, c, dtype=np.uint64)
                    .astype(np.int64))
        for qk in (-1, int(rng.integers(0, 50)), 25, SENTINEL):
            q.append(qk)
            base.append(off)
            cap.append(c)
        off += c
    return tuple(np.concatenate(a) if i < 2 else np.asarray(a, np.int32)
                 for i, a in enumerate((keys, tids, q, base, cap)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_window_plain_matches_jax_searchsorted(seed):
    """The bare probe at the halvings it derives from ``max_cap`` (those
    of ``ref.flat_segments``, ``bit_length(cap) + 1``), and the plain
    version at the least that cover the longest segment
    (``bit_length(cap)``), equal the JAX ``ref.py``'s lower bound
    (``jnp.searchsorted`` in each segment) and its clipped window."""
    caps = [1, 2, 3, 7, 8, 33, 64, 100]
    fk, ft, q, base, cap = _bare_segments(seed, caps)
    max_cap, ns = max(caps), 5
    pos_ref, keys_ref, tids_ref = [], [], []
    for qi, b, c in zip(q, base, cap):
        seg = jnp.asarray(fk[b:b + c])
        p = int(jnp.searchsorted(seg, jnp.int32(qi)))
        slots = np.clip(p + np.arange(ns), 0, c - 1)
        pos_ref.append(p)
        keys_ref.append(fk[b + slots])
        tids_ref.append(ft[b + slots])
    args = [torch.as_tensor(a) for a in (fk, ft, q, base, cap)]
    for got in (tocc.scan_window(*args, n_slots=ns, max_cap=max_cap),
                tocc_ref.scan_window_plain(*args, n_slots=ns,
                                           n_iters=max_cap.bit_length())):
        pos, keys, tids = got
        assert np.array_equal(pos.numpy(), pos_ref)
        assert np.array_equal(keys.numpy(), np.stack(keys_ref))
        assert np.array_equal(tids.numpy(), np.stack(tids_ref))


@pytest.mark.parametrize("max_cap", [1, 2, 100, 2880])
def test_scan_window_covers_the_longest_segment(max_cap):
    """The halvings the bare probe derives from ``max_cap`` reach both ends
    of a full segment that long, as the card's kernel (which searches
    every segment to its end) does: a query below, at, between and past
    every key lands where ``np.searchsorted`` puts it."""
    fk = np.arange(0, 2 * max_cap, 2, dtype=np.int32)
    ft = np.arange(max_cap, dtype=np.int64)
    q = np.arange(-1, 2 * max_cap + 1, dtype=np.int32)
    n = q.size
    pos, _, _ = tocc.scan_window(
        *(torch.as_tensor(x) for x in (fk, ft, q, np.zeros(n, np.int32),
                                       np.full(n, max_cap, np.int32))),
        n_slots=2, max_cap=max_cap)
    assert np.array_equal(pos.numpy(), np.searchsorted(fk, q))
