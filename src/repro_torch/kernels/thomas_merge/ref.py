"""Plain PyTorch version of the Thomas-write-rule merge, port of
``repro.kernels.thomas_merge.ref.thomas_merge_ref`` (and of
``repro.core.replication.thomas_apply``, the same function).

It runs for CPU tensors only (``ops.thomas_merge`` dispatches); on the card
``csrc/thomas_merge.cu`` computes the same function.
"""
from __future__ import annotations

import torch


def thomas_merge_plain(val, tidw, wrows, wvals, wtids):
    """val (N, C) int32; tidw (N,) int64; wrows (K,) int32 (-1 = skip);
    wvals (K, C) int32; wtids (K,) int64.  Applies each write iff its TID
    is the row's largest incoming TID and exceeds the row's TID; among
    equal TIDs of one row the last write wins (a sequential scatter).
    ``val`` and ``tidw`` are updated IN PLACE and returned."""
    N = val.shape[0]
    rows = torch.where(wrows >= 0, wrows, N).long()
    tid_pad = torch.cat([tidw, tidw.new_zeros(1)])
    merged = tid_pad.scatter_reduce(0, rows, wtids, "amax")
    win = (wtids == merged[rows]) & (wtids > tid_pad[rows]) & (wrows >= 0)
    val[rows[win]] = wvals[win]            # CPU: sequential, last one wins
    # merged is the new TID column: the winning TID where a write wins,
    # the row's own TID elsewhere
    tidw.copy_(merged[:N])
    return val, tidw
