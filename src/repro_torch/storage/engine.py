"""StorageEngine: array-resident tables + ordered secondary indexes, port of
``repro.storage.engine``.

One replica's storage: partition-major ``val (P, R, C) int32`` /
``tid (P, R)`` TID words (int64 holding the uint32 value) with two record
versions (working + last committed epoch, the paper's §4.5.2 revert
machinery) plus the ordered secondary indexes of ``storage.index``.

The JAX engine relies on immutable arrays: its snapshot simply references
the working arrays.  PyTorch tensors are updated in place (the replica's
Thomas merge writes values in place), so here the committed snapshot lives
in buffers of its own, allocated once: ``snapshot_commit`` copies the
working arrays into them and ``revert_to_snapshot``/``load_state`` copy out
of them into fresh working tensors.  Nothing working ever aliases the
snapshot, nor one store another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.storage.index import (SCAN_L, IndexSpec, apply_index_ops,
                                       make_index, segment_scan)

FIELDS = ("key", "prow", "tid")


def _clone_state(state):
    return {"val": state["val"].clone(), "tid": state["tid"].clone(),
            "indexes": [{f: ix[f].clone() for f in FIELDS}
                        for ix in state["indexes"]]}


class StorageEngine:
    """One replica's storage: record arrays + secondary indexes, two-version."""

    def __init__(self, n_partitions: int, rows_per_partition: int,
                 n_cols: int = 10, init_val=None,
                 index_specs: list[IndexSpec] | None = None, device=None):
        P, R, C = n_partitions, rows_per_partition, n_cols
        self.P, self.R, self.C = P, R, C
        self.device = resolve_device(device)
        if init_val is not None:
            # a copy: two stores built from one array must not share it
            self.val = torch.tensor(np.asarray(init_val, np.int32),
                                    device=self.device)
        else:
            self.val = torch.zeros((P, R, C), dtype=torch.int32,
                                   device=self.device)
        self.tid = torch.zeros((P, R), dtype=torch.int64, device=self.device)
        self.index_specs = list(index_specs or [])
        self.indexes = [make_index(s, P, self.device)
                        for s in self.index_specs]
        self._snap = _clone_state(self.state())

    # -- state plumbing ---------------------------------------------------
    def state(self):
        """The working arrays (not copies)."""
        return {"val": self.val, "tid": self.tid,
                "indexes": [dict(ix) for ix in self.indexes]}

    def load_state(self, state):
        """Make copies of ``state`` the working arrays."""
        st = _clone_state(state)
        self.val, self.tid, self.indexes = st["val"], st["tid"], \
            st["indexes"]

    # -- two-version records (§4.5.2), indexes included -----------------
    def snapshot_commit(self):
        self._snap["val"].copy_(self.val)
        self._snap["tid"].copy_(self.tid)
        for snap, cur in zip(self._snap["indexes"], self.indexes):
            for f in FIELDS:
                snap[f].copy_(cur[f])

    def revert_to_snapshot(self):
        self.load_state(self._snap)

    @property
    def snapshot(self):
        """The committed version (read only: the buffers themselves)."""
        return self._snap

    # -- batched index maintenance ---------------------------------------
    def apply_index_batch(self, kinds, delta, win, tids, part_ids=None):
        """Apply one committed index-op batch to every index (the same
        ``storage.index.apply_index_ops`` the executors and replica replay
        run).  Returns the overflow count."""
        self.indexes, overflow = apply_index_ops(
            self.indexes, kinds, delta, win, tids, part_ids=part_ids)
        return overflow

    # -- range scan over one index segment ------------------------------
    def index_id(self, name: str) -> int:
        for i, s in enumerate(self.index_specs):
            if s.name == name:
                return i
        raise KeyError(name)

    def range_scan(self, index: str | int, part: int, lo, hi,
                   limit: int = None):
        """Scan index ``index`` on partition ``part`` for keys in [lo, hi).

        Returns (keys, prows, tids, mask): fixed-width ``limit`` result
        slots, ``mask`` marking live in-range hits.  ``lo``/``hi`` are full
        (partition-prefixed) keys."""
        limit = SCAN_L if limit is None else limit
        i = index if isinstance(index, int) else self.index_id(index)
        idx = self.indexes[i]
        seg_k, seg_p, seg_t = idx["key"][part], idx["prow"][part], \
            idx["tid"][part]
        slots, keys_at, in_range = segment_scan(seg_k, lo, hi, limit + 1)
        res = slice(0, limit)
        return (keys_at[res], seg_p[slots][res], seg_t[slots][res],
                in_range[res])

    # -- consistency ------------------------------------------------------
    def equals(self, other: "StorageEngine") -> bool:
        if not (torch.equal(self.val, other.val)
                and torch.equal(self.tid, other.tid)):
            return False
        return all(torch.equal(a[f], b[f])
                   for a, b in zip(self.indexes, other.indexes)
                   for f in FIELDS)
