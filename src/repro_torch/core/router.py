"""Transaction router (§4.3): classification + re-routing + admission, port
of ``repro.core.router`` (host-side numpy, as the reference is).

"For ease of presentation, we assume that all cross-partition transaction
requests go to the designated master node ... This could be implemented via
router nodes that are aware of the partitioning of the database. If some
transaction accesses multiple partitions on a non-master node, the system
would re-route the request to the master node for later execution."

The router ingests raw (parts, rows, kinds, deltas) transaction arrays,
classifies single- vs cross-partition by inspecting the op partition sets,
routes singles to their home partition queues (the partitioned phase input)
and defers cross txns to the master queue (the single-master phase input).
Mis-declared transactions (claimed single but touching remote partitions)
are detected and re-routed — the paper's re-route case.

Everything is vectorized (argsort + cumulative-count scatter, no per-txn
Python loop): the online admission controller classifies each arrival chunk
through `Router.classify` at wire rate, while `scatter_singles` backs the
offline `route()` path (the epoch batcher drains already-classified
admission queues with its own fixed-shape gather).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RouterStats:
    singles: int = 0
    cross: int = 0
    rerouted: int = 0
    deferred_epochs: int = 0


def globalize_rows(parts: np.ndarray, rows: np.ndarray, R: int) -> np.ndarray:
    """Partition-local (part, row) -> master's flat global row id."""
    return (parts.astype(np.int64) * R + rows).astype(np.int32)


def scatter_singles(P: int, T: int, M: int, C: int, home: np.ndarray,
                    rows: np.ndarray, kinds: np.ndarray, deltas: np.ndarray,
                    user_abort: np.ndarray):
    """Vectorized (P, T, …) queue formation for single-partition txns.

    home: (n,) home partition per txn; rows/kinds: (n, M); deltas: (n, M, C).
    Returns (ptxn, placed_idx, slot_of, overflow_idx): `placed_idx[k]` is the
    input index landed at (home[placed_idx[k]], slot_of[k]); txns beyond the
    per-partition capacity T overflow in FIFO order (back-pressure).
    """
    n = home.shape[0]
    ptxn = {
        "valid": np.zeros((P, T), bool),
        "row": np.zeros((P, T, M), np.int32),
        "kind": np.zeros((P, T, M), np.int32),
        "delta": np.zeros((P, T, M, C), np.int32),
        "user_abort": np.zeros((P, T), bool),
    }
    if n == 0:
        return ptxn, np.zeros(0, np.int64), np.zeros(0, np.int64), \
            np.zeros(0, np.int64)
    order = np.argsort(home, kind="stable")          # FIFO within partition
    hs = home[order]
    counts = np.bincount(hs, minlength=P)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n, dtype=np.int64) - starts[hs]
    fit = slot < T
    idx, ps, ss = order[fit], hs[fit], slot[fit]
    ptxn["valid"][ps, ss] = True
    ptxn["row"][ps, ss] = rows[idx]
    ptxn["kind"][ps, ss] = kinds[idx]
    ptxn["delta"][ps, ss] = deltas[idx]
    ptxn["user_abort"][ps, ss] = user_abort[idx]
    return ptxn, idx, ss, order[~fit]


class Router:
    def __init__(self, n_partitions: int, rows_per_partition: int,
                 max_ops: int, n_cols: int = 10):
        self.P = n_partitions
        self.R = rows_per_partition
        self.M = max_ops
        self.C = n_cols
        self.stats = RouterStats()

    def classify(self, parts: np.ndarray, kinds: np.ndarray,
                 declared_home: np.ndarray):
        """parts: (B, M) op partition ids; kinds: (B, M) (0 = READ/pad).

        Returns (is_cross (B,), home (B,)). A txn is cross iff its live ops
        span >1 partition; any txn *declared* single-partition
        (declared_home >= 0) whose ops actually span more is the paper's
        mis-routed case — it must be re-routed to the master queue and is
        counted in ``stats.rerouted``."""
        live = kinds >= 0
        # ops beyond n_ops are padded with part == home, so span test is exact
        span_min = np.where(live, parts, parts.max(initial=0, axis=None)).min(axis=1)
        span_max = np.where(live, parts, 0).max(axis=1)
        is_cross = span_min != span_max
        rerouted = int(np.sum(is_cross & (declared_home >= 0)))
        self.stats.rerouted += rerouted
        self.stats.singles += int(np.sum(~is_cross))
        self.stats.cross += int(np.sum(is_cross))
        return is_cross, np.where(is_cross, -1, span_max)

    def route(self, parts, rows, kinds, deltas, user_abort=None,
              declared_home=None, T: int | None = None):
        """Build the two phase queues from raw txn arrays (B, M, ...).

        T caps the per-partition queue depth (None = fit everything);
        overflowing singles are deferred to the next epoch and counted in
        ``stats.deferred_epochs``."""
        B = parts.shape[0]
        if user_abort is None:
            user_abort = np.zeros(B, bool)
        if declared_home is None:
            declared_home = np.full(B, -1)
        is_cross, home = self.classify(parts, kinds, declared_home)

        single_idx = np.nonzero(~is_cross)[0]
        n_per_part = np.bincount(home[single_idx], minlength=self.P) \
            if single_idx.size else np.zeros(self.P, np.int64)
        if T is None:
            T = max(1, int(n_per_part.max(initial=0)))
        ptxn, placed, _, overflow = scatter_singles(
            self.P, T, self.M, self.C, home[single_idx], rows[single_idx],
            kinds[single_idx], deltas[single_idx], user_abort[single_idx])
        self.stats.deferred_epochs += int(overflow.size)

        cidx = np.nonzero(is_cross)[0]
        cross = {
            "valid": np.ones(len(cidx), bool),
            "row": globalize_rows(parts[cidx], rows[cidx], self.R),
            "kind": kinds[cidx],
            "delta": deltas[cidx],
            "user_abort": user_abort[cidx],
        }
        return {"ptxn": ptxn, "cross": cross,
                "n_single": int(placed.size), "n_cross": len(cidx),
                "overflow_idx": single_idx[overflow]}
