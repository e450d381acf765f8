"""Partitioned-phase executor (§4.1), port of ``repro.core.partitioned``:
H-Store-style serial execution.

Transactions are pre-routed to their home partition — arrays shaped
(P, T, …).  A Python loop walks the T queue slots; at slot t every
partition executes its t-th transaction at once (the partition axis is a
batch dimension, the paper's one worker per partition).  No locks, no read
validation, but TIDs are generated and written records tagged, so
replication and the Thomas write rule work.

Ordered-index ops resolve against the partition's own segments through the
``scan_window`` kernel (``kernels.occ.ops.step_index_ops``); a SCAN_CONSUME
whose first live key differs from the declared EXPECT key skips its op
group (counted in ``consume_skips``, logged per op in ``log["cskip"]``).
Index maintenance runs through the ``index_merge`` kernel
(``storage.index.apply_index_ops``).

The executor copies ``val``/``tidw`` once into buffers with one extra dump
row and updates those in place: masked writes, and writes a later op of
the same transaction overwrites (``last_writes``), all land on the dump
row, so only that row ever sees duplicate scatter indices.
"""
from __future__ import annotations

import torch

from repro_torch.core import tid as tidlib
from repro_torch.core.ops import (IDX_OPS, SCAN_CONSUME, apply_op,
                                  resolve_op_guards, writes_index,
                                  writes_primary)
from repro_torch.kernels.occ.ops import step_index_ops
from repro_torch.storage.index import apply_index_ops


def pad_rows(val, tidw):
    """Flat copies of (P, R, C)/(P, R) record arrays with one dump row
    appended: (P*R + 1, C) and (P*R + 1,)."""
    C = val.shape[-1]
    vbuf = torch.cat([val.reshape(-1, C), val.new_zeros((1, C))])
    tbuf = torch.cat([tidw.reshape(-1), tidw.new_zeros(1)])
    return vbuf, tbuf


def last_writes(rows, wmask):
    """The write ops of ``wmask`` (..., M) that no LATER write op of the
    same transaction overwrites (same row).  TPC-C NewOrder can decrement
    one stock row twice; the reference's sequential scatter keeps the last
    post-image, and scattering only these ops keeps that on a device whose
    scatter has no order among duplicate indices."""
    M = rows.shape[-1]
    same = (rows[..., :, None] == rows[..., None, :]) & wmask[..., None, :]
    later = torch.ones((M, M), dtype=torch.bool, device=rows.device).triu(1)
    return wmask & ~(same & later).any(-1)


def run_partitioned(val, tidw, ptxn, epoch, seq0=None, index=None,
                    part_ids=None):
    """val: (P, R, C) int32; tidw: (P, R) int64 TID words.

    ptxn: {'valid': (P,T) bool, 'row': (P,T,M) int32 (partition-local row),
    'kind': (P,T,M) int32, 'delta': (P,T,M,C) int32, 'user_abort': (P,T)}.
    epoch: Python int.  index: optional list of {"key","prow","tid"}
    (P, cap_i).  part_ids: optional (P,) global partition id per row.

    Returns (val', tid', out, stats) with ``out = {"log", "committed",
    "seq"[, "index"]}``; the log holds every op slot's post-image (P,T,M,…)
    with a write mask — the replication stream, a padding lane's rows
    clamped into [0, R) — plus "iwrite"/"cskip" (P,T,K) when an index is
    attached.  Inputs are not modified.
    """
    P, T, M = ptxn["row"].shape
    R, C = val.shape[1], val.shape[2]
    K = min(IDX_OPS, M)
    dev = val.device
    if index is not None and ptxn["delta"].shape[-1] <= 4:
        raise ValueError("index ops need IX_* param columns + a guard col")
    seq = seq0 if seq0 is not None else torch.zeros(P, dtype=torch.int64,
                                                    device=dev)
    vbuf, tbuf = pad_rows(val, tidw)
    dump = P * R
    pbase = (torch.arange(P, device=dev) * R)[:, None]            # (P, 1)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    logs, committed, skips = [], [], []

    for t in range(T):
        # a padding lane of a service batch carries whatever its pool slot
        # held (a cross transaction's global rows, say): the reference's
        # gathers fill out-of-range reads and such a lane writes nothing,
        # so clamping its rows into the partition changes no result and
        # keeps every gather in bounds.  A valid lane keeps its rows.
        raw = ptxn["row"][:, t]
        rows = torch.where(ptxn["valid"][:, t, None], raw,
                           raw.clamp(0, R - 1))
        kind = ptxn["kind"][:, t]
        delta = ptxn["delta"][:, t]
        valid = ptxn["valid"][:, t] & ~ptxn["user_abort"][:, t]      # (P,)
        flat = pbase + rows                                           # (P, M)
        old = vbuf[flat]                                              # (P,M,C)
        delta_v = delta
        if index is not None:
            # the last delta column is op-guard metadata
            delta_v = delta.clone()
            delta_v[..., -1] = 0
        new = apply_op(kind, old, delta_v)
        wmask = writes_primary(kind) & valid[:, None]                 # (P, M)
        if index is not None:
            consume_ok, slot_tid = step_index_ops(index, kind[:, :K],
                                                  delta[:, :K])
            wmask, iwrite_ok = resolve_op_guards(kind, delta, consume_ok,
                                                 wmask)

        obs = tbuf[flat].amax(1)
        if index is not None:
            obs = torch.maximum(obs, slot_tid.amax(1))
        new_tid = tidlib.next_tid(epoch, obs, tidlib.make_tid(epoch, seq))
        seq = torch.where(valid, tidlib.tid_seq(new_tid), seq)

        # scatter ONLY write ops: read/padding ops may share a row with a
        # write of the same txn; masked ones go to the dump row
        wflat = torch.where(last_writes(rows, wmask), flat, dump)
        tid_pm = new_tid[:, None].expand(P, M)
        vbuf[wflat] = new
        tbuf[wflat] = tid_pm

        log = {"row": rows, "val": new, "tid": tid_pm, "write": wmask,
               "kind": kind, "delta": delta_v}
        if index is not None:
            iw = writes_index(kind[:, :K]) & valid[:, None] & iwrite_ok
            index, ov = apply_index_ops(
                index, kind[:, :K], delta[:, :K], iw,
                new_tid[:, None].expand(P, K), part_ids=part_ids)
            overflow = overflow + ov
            log["iwrite"] = iw
            # per-op skipped-consume mask: the host mirror re-queues these
            log["cskip"] = (kind[:, :K] == SCAN_CONSUME) & ~consume_ok \
                & valid[:, None]
            skips.append(log["cskip"].sum())
        logs.append(log)
        committed.append(valid)

    log = {k: torch.stack([lg[k] for lg in logs], dim=1) for k in logs[0]}
    committed = torch.stack(committed, dim=1)                        # (P,T)
    stats = {
        "committed": committed.sum(),
        "user_aborts": (ptxn["valid"] & ptxn["user_abort"]).sum(),
        "consume_skips": (torch.stack(skips).sum() if skips
                          else torch.zeros((), dtype=torch.int64,
                                           device=dev)),
        "writes": log["write"].sum(),
        "index_overflow": overflow,
    }
    out = {"log": log, "committed": committed, "seq": seq}
    if index is not None:
        out["index"] = index
    return (vbuf[:dump].view(P, R, C), tbuf[:dump].view(P, R), out, stats)
