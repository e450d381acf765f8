"""Open-loop and closed-loop client simulators (§7 workloads, served live),
port of ``repro.service.clients``.

Open-loop clients emit requests on their own timeline at a configured rate —
Poisson, uniform, or bursty (square-wave rate modulation) inter-arrivals —
independent of how fast the service drains them; this is the arrival model
under which admission control and queue growth are meaningful.  Closed-loop
clients keep a fixed number of requests outstanding and only issue a new one
when a previous one commits (the paper's §7 load generators).

Payloads come from the streaming workload sources (`ycsb.make_raw` /
`tpcc.make_raw`); multi-tenant mixes are just several clients with distinct
tenant ids feeding one service.
"""
from __future__ import annotations

import numpy as np

from repro_torch.db import tpcc, ycsb

_GEN_CHUNK = 256      # payload pre-generation granularity

_REQ_FIELDS = ("parts", "rows", "kinds", "deltas", "user_abort", "home",
               "read_only", "txn_id", "tenant", "arrival_s")


def empty_request(M: int, C: int) -> dict:
    return {"parts": np.zeros((0, M), np.int32),
            "rows": np.zeros((0, M), np.int32),
            "kinds": np.zeros((0, M), np.int32),
            "deltas": np.zeros((0, M, C), np.int32),
            "user_abort": np.zeros(0, bool),
            "home": np.zeros(0, np.int32),
            "read_only": np.zeros(0, bool),
            "txn_id": np.zeros(0, np.int64),
            "tenant": np.zeros(0, np.int32),
            "arrival_s": np.zeros(0, np.float64)}


def concat_requests(chunks: list[dict]) -> dict:
    chunks = [c for c in chunks if c["parts"].shape[0]]
    if not chunks:
        return None
    return {k: np.concatenate([c[k] for c in chunks]) for k in _REQ_FIELDS}


def slice_request(req: dict, mask_or_idx) -> dict:
    return {k: req[k][mask_or_idx] for k in _REQ_FIELDS}


def read_lane_request(raw: dict, sel) -> dict:
    """The transactions ``sel`` of a ``make_raw`` draw (read-only ones) as
    one read-lane arrival: tenant 0, arriving at 0.0."""
    n = len(sel)
    req = {k: raw[k][sel] for k in _REQ_FIELDS[:7]}
    req.update(txn_id=np.arange(n, dtype=np.int64),
               tenant=np.zeros(n, np.int32), arrival_s=np.zeros(n))
    return req


def without_writers(state: tpcc.TPCCState, raw: dict, homes) -> dict:
    """A ``tpcc.make_raw`` draw without its single-partition writers homed
    at a partition of ``homes``, unwound from the generator's mirror as a
    shed request is: those partitions stay clean through the partitioned
    phase."""
    drop = (np.isin(raw["home"], np.asarray(homes))
            & ~raw["declared_cross"] & ~raw["read_only"])
    for i in np.nonzero(drop)[0]:
        tpcc.unwind_never_executed(state, raw["kinds"][i, :tpcc.IDX_OPS],
                                   raw["deltas"][i, :tpcc.IDX_OPS])
    B = drop.size
    return {k: (v[~drop] if isinstance(v, np.ndarray) and v.ndim
                and v.shape[0] == B else v) for k, v in raw.items()}


class YCSBSource:
    """Streaming YCSB payload generator (skew via cfg.zipf_theta etc.)."""

    def __init__(self, cfg: ycsb.YCSBConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.M, self.C = ycsb.M, ycsb.C
        self.row_bytes = np.full((ycsb.M,), ycsb.ROW_BYTES, np.int32)
        self.op_bytes = self.row_bytes.copy()

    def generate(self, n: int) -> dict:
        raw = ycsb.make_raw(self.cfg, n, self.rng)
        # clients declare their home; cross txns go undeclared (-1) straight
        # to the master queue, mis-declared singles get re-route detected
        raw["home"] = np.where(raw.pop("declared_cross"), -1,
                               raw["home"]).astype(np.int32)
        return raw


class TPCCSource:
    """Streaming NewOrder/Payment generator (shared sequencer state)."""

    def __init__(self, cfg: tpcc.TPCCConfig, state: tpcc.TPCCState | None = None,
                 seed: int = 0):
        self.cfg = cfg
        self.state = state or tpcc.TPCCState(cfg)
        self.rng = np.random.default_rng(seed)
        self.M, self.C = tpcc.M, tpcc.C
        self.row_bytes = None          # per-txn bytes: not batch-uniform
        self.op_bytes = None
        self._emitted = 0

    def generate(self, n: int) -> dict:
        raw = tpcc.make_raw(self.cfg, self.state, n, self.rng,
                            txn_offset=self._emitted)
        self._emitted += n
        raw["home"] = np.where(raw.pop("declared_cross"), -1,
                               raw["home"]).astype(np.int32)
        raw.pop("row_bytes"), raw.pop("op_bytes")
        return raw

    def unclaim(self, req: dict):
        """Unwind the mirror effects of requests that will NEVER execute
        (shed by admission, dropped from the retry buffer): a Delivery's
        claimed orders go back to the front of the undelivered queues
        instead of stranding in ``pending_claims`` forever, and a shed
        NewOrder's mirror entry (undelivered push, last-order, ring
        contents, ledger) is erased so Delivery never chases an order the
        device has no index entry for."""
        if self.cfg.mix != "full":
            return
        kinds, deltas = req["kinds"], req["deltas"]
        for i in range(kinds.shape[0]):
            tpcc.unwind_never_executed(self.state, kinds[i, :tpcc.IDX_OPS],
                                       deltas[i, :tpcc.IDX_OPS])


class OpenLoopClient:
    """Emits requests at `rate_txn_s` regardless of service progress.

    process: 'poisson' (Exp inter-arrivals), 'uniform' (1/rate), or 'bursty'
    (square wave: rate*burst_factor for the first half of every
    burst_period_s, rate/burst_factor for the second half).
    Backpressured requests go to a bounded retry buffer re-offered first;
    overflow beyond `retry_cap` is dropped and counted."""

    def __init__(self, source, rate_txn_s: float, process: str = "poisson",
                 burst_factor: float = 4.0, burst_period_s: float = 0.2,
                 tenant: int = 0, seed: int = 0, retry_cap: int = 4096):
        self.source = source
        self.rate = float(rate_txn_s)
        self.process = process
        self.burst_factor = burst_factor
        self.burst_period_s = burst_period_s
        self.tenant = tenant
        self.rng = np.random.default_rng(seed ^ 0x5EED)
        self.retry_cap = retry_cap
        self.retry: dict | None = None
        self.dropped_retries = 0
        self.emitted = 0
        self._t = 0.0                 # arrival-time cursor
        self._pending: dict | None = None   # generated but not yet due

    # ------------------------------------------------------------------
    def _gaps(self, n):
        if self.process == "poisson":
            return self.rng.exponential(1.0 / self.rate, n)
        if self.process == "uniform":
            return np.full(n, 1.0 / self.rate)
        if self.process == "bursty":
            # square-wave rate modulation, normalized so the time-averaged
            # arrival rate stays `rate` (half period high, half period low)
            f = self.burst_factor
            norm = 2.0 / (f + 1.0 / f)
            gaps = np.empty(n)
            t = self._t
            for i in range(n):     # sequential: each gap shifts the phase
                phase = (t % self.burst_period_s) / self.burst_period_s
                r = self.rate * norm * (f if phase < 0.5 else 1.0 / f)
                gaps[i] = self.rng.exponential(1.0 / r)
                t += gaps[i]
            return gaps
        raise ValueError(f"unknown arrival process {self.process!r}")

    def _generate_chunk(self):
        gaps = self._gaps(_GEN_CHUNK)
        arrivals = self._t + np.cumsum(gaps)
        self._t = float(arrivals[-1])
        req = self.source.generate(_GEN_CHUNK)
        req["arrival_s"] = arrivals
        req["tenant"] = np.full(_GEN_CHUNK, self.tenant, np.int32)
        req["txn_id"] = np.arange(self.emitted, self.emitted + _GEN_CHUNK,
                                  dtype=np.int64)
        self.emitted += _GEN_CHUNK
        return req

    def pull(self, until_s: float) -> dict | None:
        """All requests (retries first) with arrival time <= until_s."""
        chunks = []
        if self.retry is not None:
            chunks.append(self.retry)
            self.retry = None
        while True:
            if self._pending is not None:
                due = self._pending["arrival_s"] <= until_s
                if due.any():
                    chunks.append(slice_request(self._pending, due))
                    rest = ~due
                    self._pending = slice_request(self._pending, rest) \
                        if rest.any() else None
                if self._pending is not None:
                    break              # earliest undelivered is in the future
            if self._t > until_s:
                break
            self._pending = self._generate_chunk()
        return concat_requests(chunks)

    def on_shed(self, req: dict, now_s: float):
        """Shed requests are gone — an open-loop client just keeps emitting.
        Sources with host-mirror claims (TPC-C Delivery) unwind them."""
        unclaim = getattr(self.source, "unclaim", None)
        if unclaim is not None:
            unclaim(req)

    def shutdown(self):
        """End of a serving run: requests generated ahead of their arrival
        time (the lookahead chunk) and buffered retries will never execute
        — unwind their host-mirror effects (TPC-C claims/NewOrder entries)
        through the same channel sheds use."""
        unclaim = getattr(self.source, "unclaim", None)
        for buf in (self._pending, self.retry):
            if buf is not None and unclaim is not None:
                unclaim(buf)
        self._pending = self.retry = None

    def push_back(self, req: dict):
        """Backpressured requests: retry next tick (bounded buffer)."""
        merged = concat_requests([c for c in (self.retry, req)
                                  if c is not None])
        if merged is None:
            return
        n = merged["parts"].shape[0]
        if n > self.retry_cap:
            dropped = n - self.retry_cap
            self.dropped_retries += dropped
            unclaim = getattr(self.source, "unclaim", None)
            if unclaim is not None:    # oldest overflow is dropped for good
                unclaim(slice_request(merged, np.arange(dropped)))
            merged = slice_request(merged, np.arange(dropped, n))
        self.retry = merged


class ClosedLoopClient:
    """Keeps `n_outstanding` requests in flight; a commit triggers the next
    issue (plus optional think time)."""

    def __init__(self, source, n_outstanding: int, tenant: int = 1,
                 think_time_s: float = 0.0, seed: int = 0):
        self.source = source
        self.n_outstanding = int(n_outstanding)
        self.tenant = tenant
        self.think_time_s = think_time_s
        self.rng = np.random.default_rng(seed ^ 0xC105ED)
        self.emitted = 0
        self.in_flight = 0
        self._due: list[float] = [0.0] * self.n_outstanding  # issue times

    def _issue(self, n, now_s):
        req = self.source.generate(n)
        req["arrival_s"] = np.full(n, now_s, np.float64)
        req["tenant"] = np.full(n, self.tenant, np.int32)
        req["txn_id"] = np.arange(self.emitted, self.emitted + n,
                                  dtype=np.int64)
        self.emitted += n
        self.in_flight += n
        return req

    def pull(self, until_s: float) -> dict | None:
        due = [t for t in self._due if t <= until_s]
        if not due:
            return None
        self._due = [t for t in self._due if t > until_s]
        return self._issue(len(due), until_s)

    def on_complete(self, n: int, now_s: float):
        """n of this client's requests reached the commit fence."""
        self.in_flight -= n
        think = self.rng.exponential(self.think_time_s, n) \
            if self.think_time_s > 0 else np.zeros(n)
        self._due.extend((now_s + t) for t in think)

    def push_back(self, req: dict):
        """Backpressure for a closed-loop client = the slot frees instantly
        and reissues on the next pull."""
        n = req["parts"].shape[0]
        self.in_flight -= n
        self._due.extend([0.0] * n)

    def on_shed(self, req: dict, now_s: float):
        """A shed request is an error the client observes: the slot frees
        and reissues — it must NOT leak from the outstanding window."""
        n = req["parts"].shape[0]
        self.in_flight -= n
        self._due.extend([now_s] * n)
