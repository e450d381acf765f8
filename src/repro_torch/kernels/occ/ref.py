"""Plain PyTorch versions of the OCC kernels.

* :func:`scan_window_plain` — the ordered-index probe: per query a lower-
  bound search inside its own segment of one concatenated key array, then
  an ``n_slots`` window of keys and TIDs clipped to the segment (the
  function ``repro.kernels.occ.kernel.scan_window_pallas`` computes).
* :func:`lock_build_plain`, :func:`validate_plain`, :func:`install_plain`
  — the three launches of one OCC round; ``ops.occ_round`` chains them
  into ``repro.kernels.occ.ref.occ_round_ref``'s function: gather,
  scatter-min lock acquisition, Silo validation (or Calvin locking), TID,
  install.

They run for CPU tensors only (``ops`` dispatches); on the card the CUDA
kernels of ``csrc/scan_window.cu`` and ``csrc/occ_round.cu`` compute the
same functions, and ``chip_smoke.py`` holds each equal to its plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.core import tid as tidlib
from repro_torch.core.ops import apply_op


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


def lock_build_plain(addr, lane, *, NT: int, B: int):
    """Lock array (NT+1,) int32: B everywhere, then the scatter-min of the
    claim ``lane`` ids over their ``addr`` (lane B = inert claim)."""
    lock = torch.full((NT + 1,), B, dtype=torch.int32, device=addr.device)
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
