"""Ordered secondary indexes over the array-resident tables, port of
``repro.storage.index``.

Each index is a partition-major sorted-key array: ``key (P, cap) int32``
ascending with SENTINEL-padded free slots, a parallel primary-row payload
``prow (P, cap) int32`` and a per-slot ``tid (P, cap)`` TID word (int64
holding the uint32 value, see ``core.tid``).  Free slots are canonical
(key=SENTINEL, prow=0, tid=0) so master and replica arrays stay bit-equal
under replay.

Key encoding: ``full_key = partition << PART_SHIFT | local_key``, so each
partition's segment is independently sorted and the segment is selectable
from the key alone (``key >> PART_SHIFT``).

Lookups go through the ``scan_window`` kernel wrapper and maintenance
through the ``index_merge`` kernel wrapper; each runs its CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

SENTINEL = 0x7FFFFFFF
PART_SHIFT = 24                    # full key = partition << 24 | local key
SCAN_L = 8                         # result slots per scan op (+1 next-key)


@dataclass(frozen=True)
class IndexSpec:
    name: str
    capacity: int                  # slots per partition (fixed)


def make_index(spec: IndexSpec, n_partitions: int, device="cpu"):
    P, cap = n_partitions, spec.capacity
    return {"key": torch.full((P, cap), SENTINEL, dtype=torch.int32,
                              device=device),
            "prow": torch.zeros((P, cap), dtype=torch.int32, device=device),
            "tid": torch.zeros((P, cap), dtype=torch.int64, device=device)}


def full_key(partition, local_key):
    return (partition << PART_SHIFT) | local_key


def key_partition(key):
    return key >> PART_SHIFT


def segment_scan(key, lo, hi, n_slots: int = SCAN_L + 1):
    """Bounded range scan of one sorted segment ``key (cap,)``: the first
    ``n_slots`` slots at/after ``lo`` (the last one is the next-key slot).

    Returns (slots (n_slots,) int64 positions clipped to cap-1,
    keys_at (n_slots,) int32, in_range (n_slots,) bool) where ``in_range``
    marks live keys in [lo, hi) among the first n_slots-1 result slots.
    """
    # deferred (here and below): the kernel modules import this one
    from repro_torch.kernels.occ.ops import scan_window
    cap = key.shape[0]
    dev = key.device
    q = torch.tensor([int(lo)], dtype=torch.int32, device=dev)
    pos0, keys_w, _ = scan_window(
        key, torch.zeros((cap,), dtype=torch.int64, device=dev), q,
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.full((1,), cap, dtype=torch.int32, device=dev),
        n_slots=n_slots, n_iters=int(cap).bit_length() + 1)
    raw = pos0[0].long() + torch.arange(n_slots, device=dev)
    slots = raw.clamp(0, cap - 1)
    keys_at = keys_w[0]
    is_result = torch.arange(n_slots, device=dev) < (n_slots - 1)
    in_range = (raw < cap) & is_result & (keys_at >= int(lo)) \
        & (keys_at < int(hi)) & (keys_at != SENTINEL)
    return slots, keys_at, in_range


def index_batches(indexes, kinds, delta, win, tids, part_ids=None):
    """The per-index partition-aligned batches of one committed index-op
    batch: for each index a (del_pq, ins_pq, prow_pq, tid_pq) tuple of
    (P, Q) arrays with SENTINEL (or 0) where an op is masked out — the
    arguments ``apply_index_ops`` hands to ``index_merge``.  Shapes as in
    :func:`apply_index_ops`."""
    from repro_torch.core.ops import (DELETE_IDX, INSERT_IDX, IX_EXPECT,
                                      IX_ID, IX_KEY, IX_PROW, SCAN_CONSUME)
    P = indexes[0]["key"].shape[0]
    kinds = kinds.reshape(-1)
    win = win.reshape(-1)
    delta = delta.reshape(kinds.shape[0], -1)
    tids = tids.reshape(-1)
    iid = delta[:, IX_ID]
    part = key_partition(delta[:, IX_KEY])
    if part_ids is None:
        part_ids = torch.arange(P, dtype=torch.int32, device=kinds.device)
    mine = part_ids.reshape(P, 1) == part[None, :]                # (P, Q)
    dkey = torch.where(kinds == SCAN_CONSUME, delta[:, IX_EXPECT],
                       delta[:, IX_KEY])
    is_del0 = (kinds == DELETE_IDX) | (kinds == SCAN_CONSUME)
    is_ins0 = kinds == INSERT_IDX
    out = []
    for i in range(len(indexes)):
        sel_i = win & (iid == i)
        del_pq = torch.where(mine & (sel_i & is_del0)[None, :],
                             dkey[None, :], SENTINEL)
        ins_ok = mine & (sel_i & is_ins0)[None, :]
        out.append((del_pq,
                    torch.where(ins_ok, delta[None, :, IX_KEY], SENTINEL),
                    torch.where(ins_ok, delta[None, :, IX_PROW], 0),
                    torch.where(ins_ok, tids[None, :], 0)))
    return out


def apply_index_ops(indexes, kinds, delta, win, tids, part_ids=None):
    """Apply one batch of committed index-maintenance ops to every index.

    indexes: list of {"key","prow","tid"} (P, cap_i).  kinds: (..., K)
    int32 op kinds; delta: (..., K, C) op params (IX_* column layout);
    win: (..., K) bool — the op committed in this round/step; tids: (..., K)
    commit TIDs.  part_ids: optional (P,) global partition id per segment
    row (defaults to ``arange(P)``).

    Returns (indexes', overflow) where ``overflow`` (int64 0-dim tensor)
    counts live keys dropped by capacity-exceeding merges.  The same
    function runs in the executors and in replica replay, so both sides
    evolve bit-equal index arrays from the same op stream.
    """
    from repro_torch.kernels.index_merge.ops import index_merge
    out = []
    overflow = torch.zeros((), dtype=torch.int64,
                           device=indexes[0]["key"].device)
    for idx, batch in zip(indexes, index_batches(indexes, kinds, delta, win,
                                                 tids, part_ids)):
        k, p, t, ov = index_merge(idx["key"], idx["prow"], idx["tid"],
                                  *batch)
        overflow = overflow + ov.sum()
        out.append({"key": k, "prow": p, "tid": t})
    return out, overflow
