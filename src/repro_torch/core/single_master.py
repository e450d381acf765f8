"""Single-master phase executor (§4.2), port of
``repro.core.single_master``: vectorized Silo-variant OCC.

A batch of B transactions runs as B parallel lanes.  Each round (a Python
loop over ``max_rounds``) reads, locks, validates and installs through the
``occ_round`` kernel (claim → validate + TID → install + release, one
launch a round, on lock arrays allocated once per call); index ops are
located through the ``scan_window`` kernel (``locate_index_ops``) and
committed index maintenance merges through the ``index_merge`` kernel.
Lanes abort and retry the next round if an earlier lane claims anything
they read — rows or scanned index slots (phantom protection).

With ``deterministic=True`` the same machinery is the Calvin baseline: the
lock order is the pre-assigned lane order and read validation is skipped.
"""
from __future__ import annotations

import torch

from repro_torch.core.ops import (IDX_OPS, SCAN_CONSUME, is_index_kind,
                                  resolve_op_guards, writes_index,
                                  writes_primary)
from repro_torch.kernels.occ.ops import (lock_arrays, locate_index_ops,
                                         occ_round)
from repro_torch.storage.index import apply_index_ops


def run_single_master(val, tidw, txns, epoch, max_rounds: int = 16,
                      deterministic: bool = False, last_tid0=None,
                      index=None):
    """val: (N, C) int32 (the master's flat view over ALL partitions);
    tidw: (N,) int64 TID words; epoch: Python int.

    txns: {'valid': (B,), 'row': (B, M) global row, 'kind': (B, M),
           'delta': (B, M, C), 'user_abort': (B,)}.

    index: optional list of {"key","prow","tid"} (P, cap_i).

    Returns (val', tid', out, stats); ``out["log"]`` is stacked over rounds
    (rounds, B, M, …) with "iwrite"/"cskip" (rounds, B, K) when an index is
    attached.  Inputs are not modified.
    """
    N, C = val.shape
    B, M = txns["row"].shape
    K = min(IDX_OPS, M)
    dev = val.device
    if index is not None and C <= 4:
        raise ValueError("index ops need IX_* param columns + a guard col")
    val = val.clone()
    tidw = tidw.clone()
    rows, kind, delta = txns["row"], txns["kind"], txns["delta"]
    runnable = txns["valid"] & ~txns["user_abort"]
    last_tid = (last_tid0.clone() if last_tid0 is not None
                else torch.zeros(B, dtype=torch.int64, device=dev))
    # index-enabled workloads own the last delta column (op guards)
    delta_v = delta
    if index is not None:
        delta_v = delta.clone()
        delta_v[..., -1] = 0
    # pure index ops carry no meaningful primary row — exclude them from
    # the primary read/validation set (consume's row IS its write target)
    prim_live = (kind >= 0) & (~is_index_kind(kind) | (kind == SCAN_CONSUME))
    wprim = writes_primary(kind)
    windex = writes_index(kind[:, :K])

    committed = torch.zeros(B, dtype=torch.bool, device=dev)
    committed_round = torch.full((B,), -1, dtype=torch.int32, device=dev)
    # the round's lock space: rows, then every index slot, then a dump
    # slot; every entry is the sentinel lane B between rounds
    NT = N + (0 if index is None else sum(ix["key"].numel() for ix in index))
    lock, rlock = lock_arrays(NT + 1, B, deterministic, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    retries, skipped, overflow = zero, zero, zero
    logs = []
    for r in range(max_rounds):
        active = runnable & ~committed                               # (B,)
        wmask = wprim & active[:, None]
        amask = active[:, None] & prim_live
        ix = has_claim = None
        if index is not None:
            ix = locate_index_ops(index, kind[:, :K], delta[:, :K], N)
            has_claim = (ix["claim_addr"] < ix["no_addr"]) & active[:, None]
            wmask, iwrite_ok = resolve_op_guards(kind, delta,
                                                 ix["consume_ok"], wmask)
            iwrite = windex & active[:, None] & iwrite_ok

        val, tidw, commit_now, new_tid, new, w = occ_round(
            val, tidw, rows, kind, delta_v, wmask, amask, active, epoch,
            last_tid, ix=ix, has_claim=has_claim,
            deterministic=deterministic, lock=lock, rlock=rlock)

        log = {"row": torch.where(w, rows, -1), "val": new,
               "tid": new_tid[:, None].expand(B, M), "write": w}
        if index is not None:
            iw = iwrite & commit_now[:, None]
            index, ov = apply_index_ops(index, kind[:, :K], delta[:, :K],
                                        iw, new_tid[:, None].expand(B, K))
            overflow = overflow + ov
            log["iwrite"] = iw
            # consume ops a COMMITTED txn skipped this round
            log["cskip"] = (kind[:, :K] == SCAN_CONSUME) \
                & ~ix["consume_ok"] & commit_now[:, None]
            skipped = skipped + log["cskip"].sum()
        committed_round = torch.where(commit_now & ~committed, r,
                                      committed_round)
        committed = committed | commit_now
        last_tid = torch.where(commit_now, new_tid, last_tid)
        retries = retries + (active & ~commit_now).sum()
        logs.append(log)

    logs = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}
    stats = {
        "committed": committed.sum(),
        "starved": (runnable & ~committed).sum(),
        "user_aborts": (txns["valid"] & txns["user_abort"]).sum(),
        "retries": retries,
        "writes": logs["write"].sum(),
        "consume_skips": skipped,
        "index_overflow": overflow,
    }
    out = {"log": logs, "committed": committed,
           "committed_round": committed_round, "last_tid": last_tid}
    if index is not None:
        out["index"] = index
    return val, tidw, out, stats
