"""Epoch-pipelined batch formation (§4.1/§4.2 device feeds), port of
``repro.service.batcher``.

Drains the admission queues into the engine's device formats — single-
partition txns to (P, T, M, …) partitioned-phase arrays, master-queue txns
to (B, M, …) single-master OCC lanes — with FIXED T/B shapes, the same for every epoch whatever the
instantaneous load (invalid lanes are masked out, never executed); the
engine's pad-to-pow2 then leaves them as they are.

The service double-buffers: while the device executes epoch k, the engine's
``ingest`` hook calls back into `pull → offer → form` on the host, so batch
k+1 is ready the moment the fence of epoch k returns.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.service.admission import AdmissionController


@dataclass
class BatchPlan:
    """Maps a formed batch back to pool slots for commit stamping."""
    p_idx: np.ndarray          # (P, T) pool slot or -1
    c_idx: np.ndarray          # (B,)  pool slot
    n_single: int
    n_cross: int

    @property
    def total(self):
        return self.n_single + self.n_cross


class EpochBatcher:
    def __init__(self, admission: AdmissionController, slots_per_partition: int,
                 master_lanes: int, row_bytes=None, op_bytes=None):
        """slots_per_partition (T) and master_lanes (B) fix the device batch
        shape — powers of two keep the engine's pad-to-pow2 a no-op."""
        self.adm = admission
        self.T = int(slots_per_partition)
        self.B = int(master_lanes)
        self.row_bytes = row_bytes     # optional (M,) for Fig. 15 accounting
        self.op_bytes = op_bytes

    def form(self, now_s: float):
        """Drain queues into one epoch batch. Returns (batch, plan)."""
        adm, pool = self.adm, self.adm.pool
        P, T, B = adm.P, self.T, self.B
        M, C = pool.M, pool.C

        p_idx = np.full((P, T), -1, np.int64)
        for p in range(P):
            got = adm.drain_singles(p, T)
            p_idx[p, :len(got)] = got
        c_idx = np.array(adm.drain_master(B), np.int64)

        flat = p_idx.reshape(-1)
        pvalid = flat >= 0
        safe = np.where(pvalid, flat, 0)
        ptxn = {
            "valid": pvalid.reshape(P, T),
            "row": pool.row[safe].reshape(P, T, M),
            "kind": pool.kind[safe].reshape(P, T, M),
            "delta": pool.delta[safe].reshape(P, T, M, C),
            "user_abort": (pool.user_abort[safe] & pvalid).reshape(P, T),
        }
        # fixed-width master lanes: pad c_idx to B with invalid lanes
        n_cross = int(c_idx.size)
        cpad = np.full(B, 0, np.int64)
        cpad[:n_cross] = c_idx
        cross = {
            "valid": np.arange(B) < n_cross,
            "row": pool.row[cpad].reshape(B, M),
            "kind": pool.kind[cpad].reshape(B, M),
            "delta": pool.delta[cpad].reshape(B, M, C),
            "user_abort": pool.user_abort[cpad] & (np.arange(B) < n_cross),
        }
        live = np.concatenate([flat[pvalid], c_idx])
        pool.form_s[live] = now_s

        batch = {"ptxn": ptxn, "cross": cross,
                 "n_single": int(pvalid.sum()), "n_cross": n_cross}
        if self.row_bytes is not None:
            batch["row_bytes"] = self.row_bytes
            batch["op_bytes"] = self.op_bytes
        return batch, BatchPlan(p_idx, np.array(cpad[:n_cross], np.int64),
                                int(pvalid.sum()), n_cross)
