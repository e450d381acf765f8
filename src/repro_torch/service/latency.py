"""End-to-end latency accounting for the online service (§4.3, Fig. 12),
port of ``repro.service.latency``.

Every request carries four stamps on the service clock (seconds since
service start): ``arrival`` (client emitted it), ``admit`` (admission
accepted it into a bounded queue), ``form`` (the batcher drained it into an
epoch batch) and ``commit`` (the epoch's commit fence — group commit, so all
transactions of an epoch share one commit stamp).  The recorder accumulates
completed requests columnar-style and reports measured percentiles — these
replace the synthetic U(0, e) latency model the offline benchmarks used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

COMMITTED, USER_ABORTED, SHED = 0, 1, 2

_COLS = ("tenant", "arrival_s", "admit_s", "form_s", "commit_s", "status")


@dataclass
class LatencySummary:
    n: int
    p50_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float

    def __str__(self):
        return (f"n={self.n} p50={self.p50_ms:.2f}ms p99={self.p99_ms:.2f}ms "
                f"p99.9={self.p999_ms:.2f}ms mean={self.mean_ms:.2f}ms")


class LatencyRecorder:
    """Columnar accumulator of per-request stamps; chunks are appended per
    epoch (vectorized) and concatenated lazily at report time."""

    def __init__(self):
        self._chunks: list[dict] = []
        self._cache = None
        self.started_s = 0.0
        self.finished_s = 0.0

    def record(self, tenant, arrival_s, admit_s, form_s, commit_s, status):
        """All args are equal-length 1-D arrays (one row per request)."""
        n = len(arrival_s)
        if n == 0:
            return
        self._chunks.append({
            "tenant": np.asarray(tenant, np.int32),
            "arrival_s": np.asarray(arrival_s, np.float64),
            "admit_s": np.asarray(admit_s, np.float64),
            "form_s": np.asarray(form_s, np.float64),
            "commit_s": np.asarray(commit_s, np.float64),
            "status": np.asarray(status, np.int32),
        })
        self._cache = None

    # ------------------------------------------------------------------
    def _table(self):
        if self._cache is None:
            if not self._chunks:
                self._cache = {c: np.zeros(0) for c in _COLS}
            else:
                self._cache = {c: np.concatenate([ch[c] for ch in self._chunks])
                               for c in _COLS}
        return self._cache

    def latencies_ms(self, start="arrival_s", end="commit_s", tenant=None,
                     status=COMMITTED):
        """Per-request (end - start) in ms for completed requests."""
        t = self._table()
        sel = np.ones(len(t["status"]), bool)
        if status is not None:
            sel &= t["status"] == status
        if tenant is not None:
            sel &= t["tenant"] == tenant
        return (t[end][sel] - t[start][sel]) * 1e3

    def percentiles(self, start="arrival_s", end="commit_s", tenant=None):
        lat = self.latencies_ms(start, end, tenant)
        if lat.size == 0:
            return LatencySummary(0, float("nan"), float("nan"),
                                  float("nan"), float("nan"))
        return LatencySummary(
            int(lat.size),
            float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
            float(np.percentile(lat, 99.9)), float(lat.mean()))

    def committed(self, tenant=None) -> int:
        t = self._table()
        sel = t["status"] == COMMITTED
        if tenant is not None:
            sel &= t["tenant"] == tenant
        return int(sel.sum())

    def throughput_txn_s(self) -> float:
        """Sustained committed txn/s over the measured service interval."""
        span = self.finished_s - self.started_s
        return self.committed() / span if span > 0 else 0.0

    def mean_queue_delay_ms(self, last_chunk_only=True) -> float:
        """enqueue→batch-formation delay — the PhaseController telemetry."""
        chunks = self._chunks[-1:] if last_chunk_only else self._chunks
        ds = [c["form_s"] - c["arrival_s"] for c in chunks
              if len(c["arrival_s"])]
        if not ds:
            return -1.0
        d = np.concatenate(ds)
        return float(d.mean() * 1e3)
