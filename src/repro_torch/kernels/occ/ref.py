"""Plain PyTorch versions of the OCC kernels.

* :func:`scan_window_plain` — the ordered-index probe: per query a lower-
  bound search inside its own segment of one concatenated key array, then
  an ``n_slots`` window of keys and TIDs clipped to the segment (the
  function ``repro.kernels.occ.kernel.scan_window_pallas`` computes).
* :func:`step_index_ops_plain` and :func:`locate_index_ops_plain` — the
  probe with the glue around it in each phase (segment selection, the
  concatenated index, the window's masks and addresses): the functions of
  ``repro.kernels.occ.ref.step_index_ops_ref`` and
  ``locate_index_ops_ref``.
* :func:`occ_round_plain` — one OCC round on caller-held lock arrays:
  :func:`lock_build_plain` (scatter-min lock acquisition),
  :func:`validate_plain` (gather, apply_op, Silo validation or Calvin
  locking, TID), :func:`install_plain`, then the release of every claimed
  entry; ``repro.kernels.occ.ref.occ_round_ref``'s function.

They run for CPU tensors only (``ops`` dispatches); on the card the CUDA
kernels of ``csrc/scan_window.cu`` and ``csrc/occ_round.cu`` compute the
same functions, and ``chip_smoke.py`` holds each equal to its plain
version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tid as tidlib
from repro_torch.core.ops import (IX_EXPECT, IX_HI, IX_ID, IX_LO,
                                  SCAN_CONSUME, apply_op, is_index_kind,
                                  reads_index, writes_index)
from repro_torch.storage.index import SCAN_L, SENTINEL, key_partition


def scan_window_plain(flat_key, flat_tid, q, seg_base, seg_cap, *,
                      n_slots: int, n_iters: int):
    """flat_key (S,) int32 / flat_tid (S,) int64: concatenated sorted
    segments; q/seg_base/seg_cap (Q,) int32.  Returns (pos0 (Q,) int32 ==
    searchsorted-left within the segment, keys (Q, n_slots) int32,
    tids (Q, n_slots) int64)."""
    base = seg_base.long()
    cap = seg_cap.long()
    lo = torch.zeros_like(cap)
    hi = cap.clone()
    for _ in range(n_iters):
        live = lo < hi
        mid = (lo + hi) // 2
        kmid = flat_key[base + torch.minimum(mid, cap - 1)]
        right = live & (kmid < q)
        lo, hi = (torch.where(right, mid + 1, lo),
                  torch.where(live & ~right, mid, hi))
    window = lo[:, None] + torch.arange(n_slots, device=lo.device)
    slots = torch.minimum(window.clamp(min=0), cap[:, None] - 1)
    gidx = base[:, None] + slots
    return lo.to(torch.int32), flat_key[gidx], flat_tid[gidx]


# ---------------------------------------------------------------------------
# the probe's glue: segments in one flat key space
# ---------------------------------------------------------------------------
def flat_segments(index):
    """Static layout of the concatenated index segments: partitions, per-
    index caps and flat offsets, total slots, and the search-iteration
    bound."""
    P = index[0]["key"].shape[0]
    caps = [idx["key"].shape[1] for idx in index]
    offs = np.cumsum([0] + [P * c for c in caps])
    n_iters = int(max(caps)).bit_length() + 1
    return P, caps, [int(o) for o in offs], int(offs[-1]), n_iters


def seg_select(caps, offs, sel, iid, part):
    """Per-op segment base/length in the concatenated key space.  Ops not
    matching any index resolve against segment 0 and are masked out by the
    caller."""
    seg_base = torch.zeros(iid.shape, dtype=torch.int32, device=iid.device)
    seg_cap = torch.full(iid.shape, caps[0], dtype=torch.int32,
                         device=iid.device)
    for i, c in enumerate(caps):
        mine = sel & (iid == i)
        seg_base = torch.where(mine, offs[i] + part * c, seg_base)
        seg_cap = torch.where(mine, c, seg_cap)
    return seg_base.to(torch.int32), seg_cap


def flat_index(index):
    """(flat_key (S,), flat_tid (S,)): every index's segments, in order."""
    return (torch.cat([ix["key"].reshape(-1) for ix in index]),
            torch.cat([ix["tid"].reshape(-1) for ix in index]))


def _clip(x, hi):
    """jnp.clip(x, 0, hi) with a tensor upper bound."""
    return torch.minimum(x.clamp(min=0), hi)


def sm_probe_args(index, kinds, delta):
    """The bare probe's arguments for one single-master round's index ops:
    (flat_key, flat_tid, q, seg_base, seg_cap, sel, n_iters), q and the
    segments (B*K,)."""
    P, caps, offs, _, n_iters = flat_segments(index)
    lo, iid = delta[..., IX_LO], delta[..., IX_ID]
    p_of = key_partition(lo).clamp(0, P - 1)
    sel = is_index_kind(kinds) & (iid >= 0) & (iid < len(index))
    seg_base, seg_cap = seg_select(caps, offs, sel, iid, p_of)
    return (*flat_index(index), lo.reshape(-1), seg_base.reshape(-1),
            seg_cap.reshape(-1), sel, n_iters)


def part_probe_args(index, kinds, delta):
    """The bare probe's arguments for one partitioned queue slot's index
    ops: as :func:`sm_probe_args`, each partition probing its own
    segment."""
    Pq, K = kinds.shape
    P, caps, offs, _, n_iters = flat_segments(index)
    iid = delta[..., IX_ID]
    part = torch.arange(Pq, dtype=torch.int32,
                        device=kinds.device)[:, None].expand(Pq, K)
    sel = (iid >= 0) & (iid < len(index))
    seg_base, seg_cap = seg_select(caps, offs, sel, iid, part)
    return (*flat_index(index), delta[..., IX_LO].reshape(-1),
            seg_base.reshape(-1), seg_cap.reshape(-1), sel, n_iters)


def locate_index_ops_plain(index, kinds, delta, n_rows):
    """Resolve one round's index/scan ops against the current index state
    (``repro``'s ``locate_index_ops_ref``).  kinds (B, K) int32; delta
    (B, K, C).  Returns claim_addr/claim_tid (B, K), scan_addr/scan_tid/
    scan_valid (B, K, SCAN_L+1), consume_ok (B, K), in the flat row+index
    address space [0, n_rows + S) with ``no_addr`` = the dump slot."""
    B, K = kinds.shape
    S = flat_segments(index)[3]
    no_addr = n_rows + S
    dev = kinds.device
    hi = delta[..., IX_HI]
    fk, ft, q, seg_base, seg_cap, sel, n_iters = sm_probe_args(index, kinds,
                                                               delta)
    pos0, keys_at, tids_at = scan_window_plain(
        fk, ft, q, seg_base, seg_cap, n_slots=SCAN_L + 1, n_iters=n_iters)
    pos0 = pos0.reshape(B, K)
    seg_base, seg_cap = seg_base.reshape(B, K), seg_cap.reshape(B, K)
    keys_at = keys_at.reshape(B, K, SCAN_L + 1)
    tids_at = tids_at.reshape(B, K, SCAN_L + 1)

    window = pos0[..., None] + torch.arange(SCAN_L + 1, dtype=torch.int32,
                                            device=dev)
    slots = _clip(window, seg_cap[..., None] - 1)
    cmask = sel & writes_index(kinds)
    claim_addr = torch.where(cmask, n_rows + seg_base
                             + _clip(pos0, seg_cap - 1),
                             no_addr).to(torch.int32)
    claim_tid = torch.where(cmask, tids_at[..., 0], 0)
    smask = sel & reads_index(kinds)
    in_or_boundary = torch.cat(
        [torch.ones((B, K, 1), dtype=torch.bool, device=dev),
         keys_at[..., :-1] < hi[..., None]], dim=-1) \
        & (window < seg_cap[..., None])
    sv = smask[..., None] & in_or_boundary
    scan_addr = torch.where(sv, n_rows + seg_base[..., None] + slots,
                            no_addr).to(torch.int32)
    scan_tid = torch.where(sv, tids_at, 0)
    first_key = torch.where(sel, keys_at[..., 0], SENTINEL)
    consume_ok = (first_key == delta[..., IX_EXPECT]) & (first_key < hi) \
        & (first_key != SENTINEL)
    return {"claim_addr": claim_addr, "claim_tid": claim_tid,
            "scan_addr": scan_addr, "scan_tid": scan_tid,
            "scan_valid": sv, "consume_ok": consume_ok, "no_addr": no_addr}


def step_index_ops_plain(index, kinds, delta):
    """Resolve one partitioned queue slot's index ops (``repro``'s
    ``step_index_ops_ref``): (consume_ok (P, K), slot_tid (P, K)).  Each
    partition probes its OWN segment."""
    Pq, K = kinds.shape
    hi = delta[..., IX_HI]
    fk, ft, q, seg_base, seg_cap, sel, n_iters = part_probe_args(
        index, kinds, delta)
    _, keys_at, tids_at = scan_window_plain(
        fk, ft, q, seg_base, seg_cap, n_slots=1, n_iters=n_iters)
    first_key = keys_at.reshape(Pq, K)
    t_at = tids_at.reshape(Pq, K)
    ok = (first_key == delta[..., IX_EXPECT]) & (first_key < hi) \
        & (first_key != SENTINEL)
    consume_ok = torch.where(sel & (kinds == SCAN_CONSUME), ok, True)
    slot_tid = torch.where(sel, t_at, 0)
    return consume_ok, slot_tid


# ---------------------------------------------------------------------------
# one OCC round
# ---------------------------------------------------------------------------
def claim_streams(pairs, NT: int, B: int):
    """(addr, lane) claim streams from (addr, mask, lane) triples; masked
    claims become (NT, B), inert under a scatter-min."""
    addr = torch.cat([torch.where(m, a, NT).reshape(-1)
                      for a, m, _ in pairs]).to(torch.int32)
    lane = torch.cat([torch.where(m, ln, B).reshape(-1)
                      for _, m, ln in pairs]).to(torch.int32)
    return addr, lane


def lock_build_plain(addr, lane, lock):
    """Scatter-min the claim ``lane`` ids over their ``addr`` into ``lock``
    (NT+1,) int32, in place (lane B = inert claim)."""
    return lock.scatter_reduce_(0, addr.long(), lane, "amin")


def validate_plain(val, tidw, lock, rlock, rows, kind, delta_v, wmask,
                   amask, active, last_tid, epoch, ix=None, has_claim=None):
    """Per-lane gather, apply_op, lock ownership, Silo read validation (or,
    with a read-lock array ``rlock``, Calvin's all-locks-held rule) and
    next_tid.  Returns (commit (B,), new_tid (B,), new (B, M, C),
    w (B, M))."""
    B, M = rows.shape
    lanes = torch.arange(B, dtype=torch.int32, device=val.device)[:, None]
    rl = rows.long()
    new = apply_op(kind, val[rl], delta_v)                  # (B, M, C)
    rtids = tidw[rl]                                        # (B, M)
    holder = lock[rl]
    wins_all = torch.where(wmask, holder == lanes, True).all(1)
    if ix is not None:
        claim = ix["claim_addr"].long()
        scan = ix["scan_addr"].long()
        wins_all &= torch.where(has_claim, lock[claim] == lanes,
                                True).all(1)
    if rlock is not None:
        # Calvin: a txn runs when it holds all its locks (reads included)
        commit = active & torch.where(amask, rlock[rl] == lanes,
                                      True).all(1)
        if ix is not None:
            sv = ix["scan_valid"] & active[:, None, None]
            commit &= torch.where(sv, rlock[scan] == lanes[..., None],
                                  True).flatten(1).all(1)
            commit &= torch.where(has_claim, rlock[claim] == lanes,
                                  True).all(1)
    else:
        # Silo: abort if an earlier lane writes anything I read — rows AND
        # scanned index slots (phantom protection)
        read_ok = ~(amask & (holder < lanes)).any(1)
        if ix is not None:
            sdirty = ix["scan_valid"] & active[:, None, None] \
                & (lock[scan] < lanes[..., None])
            read_ok &= ~sdirty.flatten(1).any(1)
        commit = active & wins_all & read_ok
    obs = torch.where(amask, rtids, 0).amax(1)
    if ix is not None:
        obs = torch.maximum(obs, torch.where(
            ix["scan_valid"], ix["scan_tid"], 0).flatten(1).amax(1))
        obs = torch.maximum(obs, torch.where(
            has_claim, ix["claim_tid"], 0).amax(1))
    new_tid = tidlib.next_tid(epoch, obs, last_tid)
    return commit, new_tid, new, wmask & commit[:, None]


def install_plain(val, tidw, rows, new, w, new_tid):
    """Winners' post-images and TIDs into val/tidw, in place (winner rows
    are unique)."""
    B, M = rows.shape
    wr = rows.long()[w]
    val[wr] = new[w]
    tidw[wr] = new_tid[:, None].expand(B, M)[w]


def occ_round_plain(val, tidw, rows, kind, delta_v, wmask, amask, active,
                    epoch, last_tid, lock, rlock=None, ix=None,
                    has_claim=None):
    """One OCC round on the caller's lock arrays ``lock`` (and, for Calvin,
    ``rlock``), (NT+1,) int32 all B on entry and again on exit: claim,
    validate, install in place, release.  Returns (commit, new_tid, new,
    w)."""
    B = rows.shape[0]
    NT = lock.shape[0] - 1
    lanes = torch.arange(B, dtype=torch.int32, device=val.device)[:, None]
    wpairs = [(rows, wmask, lanes)]
    if ix is not None:
        wpairs.append((ix["claim_addr"], has_claim, lanes))
    waddr, wlane = claim_streams(wpairs, NT, B)
    lock_build_plain(waddr, wlane, lock)
    if rlock is not None:
        # Calvin: every access, reads included, claims its address
        rpairs = [(rows, amask, lanes)]
        if ix is not None:
            rpairs += [(ix["scan_addr"], ix["scan_valid"]
                        & active[:, None, None], lanes[..., None]),
                       (ix["claim_addr"], has_claim, lanes)]
        raddr, rlane = claim_streams(rpairs, NT, B)
        lock_build_plain(raddr, rlane, rlock)
    out = validate_plain(val, tidw, lock, rlock, rows, kind, delta_v, wmask,
                         amask, active, last_tid, epoch, ix=ix,
                         has_claim=has_claim)
    commit, new_tid, new, w = out
    install_plain(val, tidw, rows, new, w, new_tid)
    lock[waddr.long()] = B
    if rlock is not None:
        rlock[raddr.long()] = B
    return out
