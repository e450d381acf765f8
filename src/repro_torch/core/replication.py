"""Replication: value vs operation streams + the Thomas write rule (§3,
§5), port of ``repro.core.replication`` (the WAL stream splitters wait for
the WAL port).

* ``thomas_apply`` — out-of-order-safe value replication through the
  ``thomas_merge`` kernel: apply a write iff its TID exceeds the record's
  TID; among duplicate rows the max-TID write wins.
* ``replay_partitioned`` — ordered operation replication of the
  partitioned phase's stream, all partitions at once, with its index
  maintenance per queue slot.
* ``replay_index_rounds`` — the single-master phase's index-op stream,
  per OCC round.
* byte accounting — value bytes use real row sizes, operation bytes the
  operand sizes (Fig. 15).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ops import IDX_OPS, apply_op
from repro_torch.core.partitioned import last_writes, pad_rows
from repro_torch.kernels.thomas_merge.ops import thomas_merge
from repro_torch.storage.index import apply_index_ops

KEY_BYTES = 8
TID_BYTES = 8
# an index-maintenance op ships (key, kind, operand words) on the op stream
INDEX_OP_BYTES = KEY_BYTES + 4 + 8


def thomas_apply(val, tidw, wrows, wvals, wtids):
    """val: (N, C); tidw: (N,); wrows: (K,) int32 (-1 = skip); wvals: (K, C);
    wtids: (K,).  ``val`` and ``tidw`` are updated in place and
    returned."""
    return thomas_merge(val, tidw, wrows, wvals, wtids)


def thomas_apply_batch(val, tidw, log):
    """Flatten a phase log {'row','val','tid','write'} into one merge."""
    C = val.shape[1]
    rows = torch.where(log["write"], log["row"], -1).reshape(-1)
    return thomas_apply(val, tidw, rows.to(torch.int32),
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


# ---------------------------------------------------------------------------
# bandwidth accounting (Fig. 15) — host-side numpy on the write masks
# ---------------------------------------------------------------------------
def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
