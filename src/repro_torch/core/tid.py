"""Silo-style TID words (§3 of the paper), port of ``repro.core.tid``.

A TID is a 32-bit word:  [ epoch : 8 | sequence : 23 | lock : 1 ].

The port carries TID words in int64 tensors holding the unsigned 32-bit
value (this PyTorch has no uint32 comparison, max or shift on every
device).  Every expression is reduced mod 2**32, because the reference
computes in uint32 and wraps: ``make_tid(256, 1) == 2``.

Criteria for a committing transaction's TID (paper §3):
  (a) larger than the TID of any record in its read/write set,
  (b) larger than the worker's last chosen TID,
  (c) in the current global epoch.
"""
from __future__ import annotations

import torch

EPOCH_BITS = 8
SEQ_BITS = 23
LOCK_MASK = 1
SEQ_SHIFT = 1
EPOCH_SHIFT = 1 + SEQ_BITS
SEQ_MASK = (1 << SEQ_BITS) - 1
EPOCH_MASK = (1 << EPOCH_BITS) - 1
U32 = 0xFFFFFFFF
TID_DTYPE = torch.int64


def _w(x):
    """A TID operand: a tensor as int64, anything else as a Python int —
    both reduced mod 2**32 like the reference's uint32 cast."""
    if isinstance(x, torch.Tensor):
        return x.to(TID_DTYPE) & U32
    return int(x) & U32


def make_tid(epoch, seq, locked=False):
    t = ((_w(epoch) << EPOCH_SHIFT) | (_w(seq) << SEQ_SHIFT)) & U32
    return t | LOCK_MASK if locked else t


def tid_epoch(tid):
    return (_w(tid) >> EPOCH_SHIFT) & EPOCH_MASK


def tid_seq(tid):
    return (_w(tid) >> SEQ_SHIFT) & SEQ_MASK


def tid_locked(tid):
    return (_w(tid) & LOCK_MASK) != 0


def tid_lock(tid):
    return _w(tid) | LOCK_MASK


def tid_unlock(tid):
    return _w(tid) & (U32 ^ LOCK_MASK)


def next_tid(epoch, observed_max_tid, last_tid):
    """TID satisfying (a), (b), (c): seq = max(observed, last)+1 in `epoch`.
    TIDs from other epochs contribute seq 0.  ``observed_max_tid`` and
    ``last_tid`` are int64 tensors of one shape; ``epoch`` a Python int."""
    e = _w(epoch)

    def seq_in_epoch(t):
        t = tid_unlock(t)
        return torch.where(tid_epoch(t) == e, tid_seq(t), 0)

    seq = torch.maximum(seq_in_epoch(observed_max_tid),
                        seq_in_epoch(last_tid)) + 1
    return make_tid(e, seq)
