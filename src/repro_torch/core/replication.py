"""Replication: value vs operation streams + the Thomas write rule (§3,
§5), port of ``repro.core.replication``.

* ``thomas_apply`` / ``thomas_apply_batch`` — out-of-order-safe value
  replication through the ``thomas_merge`` kernel: apply a write iff its
  TID exceeds the record's TID; among duplicate rows the max-TID write
  wins.  ``thomas_apply`` takes any write stream (WAL recovery's record
  chunks), ``thomas_apply_batch`` the single-master log.
* ``replay_partitioned`` — ordered operation replication of the
  partitioned phase's stream, all partitions at once, with its index
  maintenance per queue slot.
* ``replay_index_rounds`` — the single-master phase's index-op stream,
  per OCC round.
* per-worker WAL streams — one committed epoch's streams split by owner
  for ``db.wal.Durability`` (host numpy, the reference's on-disk types).
* byte accounting — value bytes use real row sizes, operation bytes the
  operand sizes (Fig. 15).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ops import IDX_OPS, IX_KEY, apply_op
from repro_torch.core.partitioned import last_writes, pad_rows
from repro_torch.kernels.thomas_merge.ops import thomas_merge
from repro_torch.storage.index import PART_SHIFT, apply_index_ops

KEY_BYTES = 8
TID_BYTES = 8
# an index-maintenance op ships (key, kind, operand words) on the op stream
INDEX_OP_BYTES = KEY_BYTES + 4 + 8


def thomas_apply(val, tidw, wrows, wvals, wtids):
    """val (N, C) int32; tidw (N,) int64 TID words; wrows (K,) int32 (-1 =
    skip); wvals (K, C) int32; wtids (K,) int64, all contiguous.  Merges
    the stream into ``val``/``tidw`` IN PLACE (one ``thomas_merge`` launch
    on the card) and returns them.  Unlike the reference it returns no
    applied-write mask: no caller reads one."""
    return thomas_merge(val, tidw, wrows, wvals, wtids)


def thomas_apply_batch(val, tidw, log):
    """One merge of a single-master log {'row','val','tid'}, each (rounds,
    B, M, ...) and contiguous as the executor stacks it, in its (round,
    lane, op) order.  The executor writes row -1 where a write did not
    commit, so the flattened views are the stream: nothing is copied or
    masked before the kernel."""
    C = val.shape[1]
    return thomas_merge(val, tidw, log["row"].reshape(-1),
                        log["val"].reshape(-1, C), log["tid"].reshape(-1))


def replay_partitioned(val, tidw, log, index=None, part_ids=None):
    """Ordered replay of the whole partitioned-phase stream, all partitions
    at once, with optional index maintenance.

    val: (P, R, C); tidw: (P, R); log: {'row','kind','delta','tid','write'}
    each (P, T, M, ...) plus 'iwrite' (P, T, K) when index ops were logged.
    Returns (val', tid', index').  Inputs are not modified.
    """
    P, T, M = log["row"].shape
    R, C = val.shape[1], val.shape[2]
    K = min(IDX_OPS, M)
    vbuf, tbuf = pad_rows(val, tidw)
    dump = P * R
    pbase = (torch.arange(P, device=val.device) * R)[:, None]
    for t in range(T):
        rows = log["row"][:, t]
        flat = pbase + rows
        new = apply_op(log["kind"][:, t], vbuf[flat], log["delta"][:, t])
        wflat = torch.where(last_writes(rows, log["write"][:, t]), flat,
                            dump)
        vbuf[wflat] = new
        tbuf[wflat] = log["tid"][:, t]
        if index is not None:
            # overflow is identical to the master's (same batches)
            index, _ = apply_index_ops(
                index, log["kind"][:, t, :K], log["delta"][:, t, :K],
                log["iwrite"][:, t], log["tid"][:, t, :K],
                part_ids=part_ids)
    return vbuf[:dump].view(P, R, C), tbuf[:dump].view(P, R), index


def replay_index_rounds(index, kinds, delta, iwrite, tids, part_ids=None):
    """Replay the single-master phase's index-maintenance stream: the
    identical per-round ``apply_index_ops`` batches the master installed.

    kinds/delta: (B, K≥) static op arrays; iwrite: (rounds, B, K);
    tids: (rounds, B, M)."""
    K = iwrite.shape[-1]
    for r in range(iwrite.shape[0]):
        index, _ = apply_index_ops(index, kinds[:, :K], delta[:, :K],
                                   iwrite[r], tids[r][:, :K],
                                   part_ids=part_ids)
    return index


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# per-worker WAL streams (durability, §4.5.1/§5) — host numpy
# ---------------------------------------------------------------------------
def wal_partition_streams(log, R: int, n_workers: int, worker_of_partition,
                          part_ids=None):
    """Split one epoch's partitioned-phase log into per-worker WAL streams.

    The op stream is logged in its §5 TRANSFORMED form — the whole
    post-image ``val`` with its commit TID — so recovery can replay any
    (file, chunk) order under the Thomas write rule.  Rows globalize to the
    flat P*R space.  Yields ``(worker, rows, vals, tids, mask)`` numpy
    arrays with non-empty masks only.

    log: {'row' (P,T,M), 'val' (P,T,M,C), 'tid' (P,T,M), 'write' (P,T,M)};
    worker_of_partition: (P_all,) int; part_ids: the global partition id
    of each of the log's P rows (default ``arange(P)``: the whole table).
    """
    rows = _np(log["row"])
    P = rows.shape[0]
    ids = (np.arange(P, dtype=np.int64) if part_ids is None
           else np.asarray(part_ids, np.int64))
    grows = rows + ids[:, None, None] * R
    vals, tids, wm = _np(log["val"]), _np(log["tid"]), _np(log["write"])
    worker_of_partition = np.asarray(worker_of_partition)[ids]
    for w in range(n_workers):
        sel = worker_of_partition == w
        if sel.any() and wm[sel].any():
            yield w, grows[sel], vals[sel], tids[sel], wm[sel]


def wal_master_streams(log, R: int, C: int, n_workers: int,
                       worker_of_partition):
    """Split the single-master phase's value stream (whole-record
    post-images on global rows; row -1 where nothing was written) to each
    owner's WAL.  Yields ``(worker, rows, vals, tids, mask)`` with
    non-empty masks only."""
    rows = _np(log["row"]).reshape(-1)
    vals = _np(log["val"]).reshape(-1, C)
    tids = _np(log["tid"]).reshape(-1)
    wm = _np(log["write"]).reshape(-1)
    owner = np.asarray(worker_of_partition)[np.where(wm, rows, 0) // R]
    for w in range(n_workers):
        m = wm & (owner == w)
        if m.any():
            yield w, rows, vals, tids, m


def wal_index_streams(plog, n_workers: int, worker_of_partition,
                      cross_kinds=None, cross_delta=None, slog=None,
                      part_ids=None):
    """Split one epoch's index-maintenance op streams into per-worker WAL
    chunks.  Index ops replay ORDERED: each op carries a ``step`` id
    (partitioned queue slot t, then single-master round T+r) and recovery
    re-applies each file's chunks step group by step group in file order.
    A partition's ops all land in its owner's file, so cross-file chunks
    touch disjoint segments and commute.

    plog: partitioned log with 'kind' (P,T,M), 'delta' (P,T,M,C),
    'iwrite' (P,T,K), 'tid' (P,T,M).  cross_kinds/cross_delta: the
    single-master batch's (B, M)/(B, M, C) op arrays with slog the SM log
    ('iwrite' (rounds,B,K), 'tid' (rounds,B,M)).

    Yields ``(worker, step, kinds, delta, tids)`` flat committed-op numpy
    arrays in step-ascending order, non-empty only.  ``part_ids``: the
    global partition id of each of plog's rows (default ``arange(P)``).
    """
    worker_of_partition = np.asarray(worker_of_partition)
    T = 0
    per_worker = {w: [] for w in range(n_workers)}
    if plog is not None and "iwrite" in plog:
        iw = _np(plog["iwrite"])                                # (P, T, K)
        P, T, K = iw.shape
        kinds = _np(plog["kind"])[:, :, :K]
        delta = _np(plog["delta"])[:, :, :K]
        tids = _np(plog["tid"])[:, :, :K]
        steps = np.broadcast_to(np.arange(T, dtype=np.int32)[None, :, None],
                                iw.shape)
        ids = (np.arange(P) if part_ids is None
               else np.asarray(part_ids, np.int64))
        for w in range(n_workers):
            sel = worker_of_partition[ids] == w
            m = iw[sel]
            if not m.any():
                continue
            # (n_p, T, K) -> (T, n_p, K) so the flat stream is step-major
            order = (1, 0, 2)
            m_t = m.transpose(order).reshape(-1)
            per_worker[w].append((
                steps[sel].transpose(order).reshape(-1)[m_t],
                kinds[sel].transpose(order).reshape(-1)[m_t],
                delta[sel].transpose(1, 0, 2, 3).reshape(
                    -1, delta.shape[-1])[m_t],
                tids[sel].transpose(order).reshape(-1)[m_t]))
    if slog is not None and "iwrite" in slog:
        iw = _np(slog["iwrite"])                                # (r, B, K)
        rounds, B, K = iw.shape
        kinds = np.broadcast_to(_np(cross_kinds)[None, :, :K], iw.shape)
        cross_delta = _np(cross_delta)
        delta = np.broadcast_to(cross_delta[None, :, :K],
                                iw.shape + (cross_delta.shape[-1],))
        tids = _np(slog["tid"])[:, :, :K]
        steps = np.broadcast_to(
            T + np.arange(rounds, dtype=np.int32)[:, None, None], iw.shape)
        part = (delta[..., IX_KEY].astype(np.int64) >> PART_SHIFT)
        owner = worker_of_partition[np.clip(part, 0,
                                            len(worker_of_partition) - 1)]
        flat = iw.reshape(-1)
        for w in range(n_workers):
            m = flat & (owner.reshape(-1) == w)
            if not m.any():
                continue
            per_worker[w].append((
                steps.reshape(-1)[m], kinds.reshape(-1)[m],
                delta.reshape(-1, delta.shape[-1])[m],
                tids.reshape(-1)[m]))
    for w, chunks in per_worker.items():
        if chunks:
            yield (w,
                   np.concatenate([c[0] for c in chunks]),
                   np.concatenate([c[1] for c in chunks]),
                   np.concatenate([c[2] for c in chunks]),
                   np.concatenate([c[3] for c in chunks]))


# ---------------------------------------------------------------------------
# bandwidth accounting (Fig. 15) — host-side numpy on the write masks
# ---------------------------------------------------------------------------


def value_bytes(log_write_mask, row_bytes_per_op) -> int:
    """Value replication ships the full row (+key+tid) per committed write."""
    return int(np.sum(np.where(_np(log_write_mask),
                               row_bytes_per_op + KEY_BYTES + TID_BYTES, 0),
                      dtype=np.int64))


def operation_bytes(log_write_mask, op_bytes_per_op) -> int:
    """Operation replication ships only (key, kind, operand)."""
    return int(np.sum(np.where(_np(log_write_mask),
                               op_bytes_per_op + KEY_BYTES + 4, 0),
                      dtype=np.int64))


def index_op_bytes(iwrite_mask) -> int:
    """Index-maintenance ops ride the same op stream as record ops."""
    return int(np.sum(_np(iwrite_mask), dtype=np.int64)) * INDEX_OP_BYTES


def slab_op_bytes(wmask, op_tbl, iwrite, n_slabs: int) -> list[int]:
    """Per-slab op-stream bytes: the epoch's T queue slots split into
    ``n_slabs`` contiguous chunks; the sum over slabs is the epoch's total
    op-stream bytes."""
    T = wmask.shape[1]
    S = max(1, min(n_slabs, T))
    bounds = [T * s // S for s in range(S + 1)]
    out = []
    for s in range(S):
        sl = slice(bounds[s], bounds[s + 1])
        b = operation_bytes(wmask[:, sl], op_tbl[:, sl])
        if iwrite is not None:
            b += index_op_bytes(iwrite[:, sl])
        out.append(b)
    return out


def fence_net_seconds(net, fence_bytes: int, overlapped_bytes: int = 0,
                      t_exec_s: float = 0.0) -> float:
    """The modeled inter-node fence cost: ``fence_bytes`` drain inside the
    fence plus two barrier round trips; ``overlapped_bytes`` shipped during
    the preceding ``t_exec_s`` surface only as their unhidden residue."""
    return net.transfer_s(fence_bytes) + 2 * net.rtt_s \
        + max(0.0, net.transfer_s(overlapped_bytes) - t_exec_s)


def epoch_stream_bytes(batch, log, has_index: bool, n_slabs: int,
                       pad_fn) -> tuple[int, list[int], int]:
    """One epoch's partitioned-stream byte accounting.  Returns
    ``(value_bytes_alt, per_slab_op_bytes, index_op_bytes)`` — zeros /
    empty when the batch carries no byte tables."""
    has_tables = "p_row_bytes" in batch \
        or batch.get("row_bytes") is not None
    if not has_tables:
        return 0, [], 0
    wmask = _np(log["write"])
    iw = _np(log["iwrite"]) if has_index else None
    if "p_row_bytes" in batch:
        prb = np.asarray(pad_fn(batch["p_row_bytes"]))
        pob = np.asarray(pad_fn(batch["p_op_bytes"]))
    else:
        prb = np.broadcast_to(
            np.asarray(batch["row_bytes"])[None, None, :], wmask.shape)
        pob = np.broadcast_to(
            np.asarray(batch["op_bytes"])[None, None, :], wmask.shape)
    vb_alt = value_bytes(wmask, prb)
    slabs = slab_op_bytes(wmask, pob, iw, n_slabs)
    ib = index_op_bytes(iw) if iw is not None else 0
    return vb_alt, slabs, ib


def split_overlapped(slab_bytes: list[int]) -> tuple[int, int]:
    """Split a per-slab byte list into (overlapped, fence_exposed): the
    fence-exposed tail is the LAST slab that carried committed bytes."""
    if not slab_bytes:
        return 0, 0
    tail_i = max((i for i, b in enumerate(slab_bytes) if b > 0),
                 default=len(slab_bytes) - 1)
    tail = slab_bytes[tail_i]
    return sum(slab_bytes) - tail, tail


def snapshot_watermark(committed_epoch: int, slab_ledger) -> tuple[int, int]:
    """Per-replica applied watermark: (last-applied fence epoch, stream
    slabs of that epoch the replicas had consumed when it committed)."""
    slabs = sum(1 for (e, _s) in slab_ledger if e == committed_epoch)
    return int(committed_epoch), slabs
