"""Stored-procedure op semantics shared by both phase executors.

Port of ``repro.core.ops``.  Every transaction is a fixed-width list of ops
(table, row, kind, delta).  Kinds:
  0 READ      — no write
  1 SET       — overwrite the row with delta
  2 ADD       — row += delta (RMW; models stock/ytd/balance updates)
  3 APPEND    — string concat modeled as a rolling hash + length word
  4 STOCK_DECR, 5 PAY_CUST — fused TPC-C stock / Payment-customer updates

Index/scan kinds (params in delta columns, see IX_*; they occupy the first
IDX_OPS op slots of a transaction):
  6 SCAN_READ, 7 SCAN_CONSUME, 8 INSERT_IDX, 9 DELETE_IDX.

int32 arithmetic wraps in PyTorch exactly as in the reference; the CUDA
kernels repeat :func:`apply_op` in ``csrc/occ_round.cu`` in uint32.
"""
from __future__ import annotations

import torch

READ, SET, ADD, APPEND, STOCK_DECR, PAY_CUST = 0, 1, 2, 3, 4, 5
SCAN_READ, SCAN_CONSUME, INSERT_IDX, DELETE_IDX = 6, 7, 8, 9
APPEND_CAP = 500

# index-op delta column layout (int32 words of the op's delta row)
IX_KEY = 0       # insert/delete: full (partition-prefixed) key
IX_LO = 0        # scans: range lo key (shares col 0 — always the key col)
IX_HI = 1        # scans: range hi key (exclusive)
IX_PROW = 1      # insert: partition-local primary row payload
IX_EXPECT = 2    # consume: expected (host-predicted) oldest key
IX_ID = 3        # all index ops: which index (position in the spec list)

IDX_OPS = 12     # index/scan ops live in op slots [0, IDX_OPS)

# Op groups: an op's delta LAST column is its guard — 0 = unguarded, g > 0
# = the op applies only if the SCAN_CONSUME at op slot g-1 validated.
GUARD_COL = 9


def hash_combine(h, x):
    return (h * 1000003 + x) & 0x7FFFFFFF


def apply_op(kind, old, delta):
    """kind: (...,) int32; old/delta: (..., C) int32 -> new value."""
    add_v = old + delta
    h = hash_combine(old[..., 0], delta[..., 0])
    ln = (old[..., 1] + delta[..., 1]).clamp(max=APPEND_CAP)
    app_v = old.clone()
    app_v[..., 0] = h
    app_v[..., 1] = ln
    # TPC-C stock update: col0 qty = qty-d if qty-d >= 10 else qty-d+91;
    # col1 ytd += d; col2 order_cnt += 1; col3 remote_cnt += delta[3]
    d = delta[..., 0]
    q = old[..., 0] - d
    stk = old.clone()
    stk[..., 0] = torch.where(q >= 10, q, q + 91)
    stk[..., 1] = old[..., 1] + d
    stk[..., 2] = old[..., 2] + 1
    stk[..., 3] = old[..., 3] + delta[..., 3]
    # Payment customer row, fused: cols0-1 = c_data hash+len, rest += delta
    pay = add_v.clone()
    pay[..., 0] = h
    pay[..., 1] = ln
    k = kind[..., None]
    new = torch.where(k == SET, delta, old)
    new = torch.where(k == ADD, add_v, new)
    new = torch.where(k == APPEND, app_v, new)
    new = torch.where(k == STOCK_DECR, stk, new)
    new = torch.where(k == PAY_CUST, pay, new)
    new = torch.where(k == SCAN_CONSUME, torch.zeros_like(old), new)
    return new


def writes_primary(kind):
    """Op scatters a post-image into its primary row (consume tombstones)."""
    return ((kind > READ) & (kind <= PAY_CUST)) | (kind == SCAN_CONSUME)


def writes_index(kind):
    """Op mutates an ordered index (claims an index-slot lock)."""
    return kind >= SCAN_CONSUME


def reads_index(kind):
    """Op's read set includes a scanned index range (phantom validation)."""
    return (kind == SCAN_READ) | (kind == SCAN_CONSUME)


def is_index_kind(kind):
    """Any index/scan op."""
    return kind >= SCAN_READ


def is_write_kind(kind):
    """Op needs an OCC lock claim (primary row and/or index slot)."""
    return writes_primary(kind) | writes_index(kind)


def resolve_op_guards(kind, delta, consume_ok, wmask):
    """Apply op-group guards + consume self-masking to one round/slot.

    kind: (..., M); delta: (..., M, C); consume_ok: (..., K) per index-op
    slot; wmask: (..., M) primary-write mask.  Returns (wmask', iwrite_ok)
    where ``iwrite_ok (..., K)`` is the factor to AND into the index-
    maintenance mask.
    """
    K = consume_ok.shape[-1]
    guard = delta[..., -1] * is_write_kind(kind)              # (..., M)
    gok = torch.gather(consume_ok, -1, (guard - 1).clamp(0, K - 1).long())
    guard_ok = torch.where(guard > 0, gok, True)
    consume_live = torch.where(kind[..., :K] == SCAN_CONSUME, consume_ok,
                               True)
    wmask = wmask & guard_ok
    wmask[..., :K] &= consume_live
    return wmask, consume_live & guard_ok[..., :K]
