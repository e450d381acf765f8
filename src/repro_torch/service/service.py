"""Online transaction service: clients → admission → batcher → StarEngine,
port of ``repro.service.service`` driving the port's engine (on ``cuda``
unless the engine was built with ``device="cpu"``).

The epoch loop is pipelined two-deep: while the card executes epoch k, the
engine's ``ingest`` hook pulls new arrivals from the clients, runs admission,
and forms batch k+1 on the host (double buffering, §4.3's "the data plane
never idles on ingest").  At each epoch's commit fence the service stamps
every transaction of the batch with the fence time (group commit), feeds the
measured queue delay and commit latency into the `PhaseController` (so Eqs
1–2 plan from observed traffic, not synthetic numbers), retires completed
requests to the `LatencyRecorder`, and re-queues starved OCC transactions at
the front of the master queue.

The service runs on the wall clock: open-loop arrival timelines map onto
seconds-since-start, so if the engine cannot keep up, queues fill and
admission control sheds or backpressures — measurably, not by assumption.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.engine import StarEngine
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.service import latency as lat
from repro_torch.service.admission import (AdmissionConfig,
                                           AdmissionController, BACKPRESSURE)
from repro_torch.service.batcher import EpochBatcher
from repro_torch.service.clients import slice_request


@dataclass
class ServiceStats:
    epochs: int = 0
    committed: int = 0
    user_aborted: int = 0
    starved_requeues: int = 0
    ingest_time_s: float = 0.0
    epoch_time_s: float = 0.0


class TxnService:
    def __init__(self, engine: StarEngine, clients: list,
                 admission_cfg: AdmissionConfig | None = None,
                 slots_per_partition: int = 64, master_lanes: int = 64,
                 max_ops: int | None = None, feedback=None,
                 node_of_partition=None, read_tier=None, analytics=None,
                 metrics: MetricsRegistry | None = None):
        """feedback: optional callable(batch, metrics) invoked after every
        epoch's commit fence — the service-level consume-feedback hook
        (e.g. ``lambda b, m: tpcc.apply_consume_feedback(state, b, m)``
        re-queues Delivery districts the device skipped).
        node_of_partition: cluster deployments pass the partition→node map
        so admission enforces per-node queue bounds and attributes
        shed/depth telemetry per node (see ClusterTxnService).
        read_tier, analytics: the reference's read lane and HTAP lane,
        which the port does not have yet; anything but None raises
        NotImplementedError.
        metrics: optional ``obs.MetricsRegistry`` (one is created if not
        given) — the engine/service/admission stats dataclasses register
        into it and ``_observe_epoch`` records a per-epoch snapshot."""
        if read_tier is not None or analytics is not None:
            raise NotImplementedError("the port has no read tier or "
                                      "analytics lane yet")
        self.engine = engine
        self.clients = list(clients)
        self.feedback = feedback
        M = max_ops if max_ops is not None else self.clients[0].source.M
        self.admission = AdmissionController(
            engine.P, engine.R, M, engine.C, cfg=admission_cfg,
            node_of_partition=node_of_partition)
        src = self.clients[0].source
        self.batcher = EpochBatcher(self.admission, slots_per_partition,
                                    master_lanes, row_bytes=src.row_bytes,
                                    op_bytes=src.op_bytes)
        self.recorder = lat.LatencyRecorder()
        self.stats = ServiceStats()
        self._t0 = None
        self._deadline = float("inf")
        # one metrics namespace: the stats dataclasses register as live
        # objects (snapshot-time reads, never hand-merged), the lane
        # summaries and the kernel-launch counter come in as providers
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.register_object("engine", engine.stats)
        self.metrics.register_object("service", self.stats)
        self.metrics.register_object("admission", self.admission.stats)
        self.metrics.register_provider("kernels", obs.kernel_launch_counts)

    # ------------------------------------------------------------------
    def clock(self) -> float:
        return time.perf_counter() - self._t0

    def _ingest(self, now_s: float):
        """Pull due arrivals from every client and run admission. New
        arrivals stop at the deadline so the drain phase terminates."""
        until = min(now_s, self._deadline)
        with obs.span("service.admission", cat="service"):
            for c in self.clients:
                req = c.pull(until)
                if req is None:
                    continue
                rejected = self.admission.offer(req, now_s)
                if rejected.any():
                    rej = slice_request(req, rejected)
                    if self.admission.cfg.policy == BACKPRESSURE:
                        c.push_back(rej)
                    else:
                        c.on_shed(rej, until)   # client sees the rejection

    def _complete(self, plan, metrics):
        """Commit fence reached: stamp, retire, re-queue starved."""
        pool, rec = self.admission.pool, self.recorder
        commit_s = metrics["t_fence2_s"] - self._t0
        P, T = plan.p_idx.shape

        p_slots = plan.p_idx.reshape(-1)
        p_live = p_slots >= 0
        p_slots = p_slots[p_live]
        p_ok = metrics["p_committed"][:, :T].reshape(-1)[p_live]

        B = plan.c_idx.size
        c_slots = plan.c_idx
        c_ok = metrics["c_committed"][:B] if B else np.zeros(0, bool)

        # starved OCC lanes (valid, not aborted, not committed) retry next
        # epoch from the FRONT of the master queue
        c_aborted = pool.user_abort[c_slots] if B else np.zeros(0, bool)
        starved = ~c_ok & ~c_aborted
        if starved.any():
            self.admission.requeue_master_front(c_slots[starved])
            self.stats.starved_requeues += int(starved.sum())
        done_c = c_slots[~starved]
        done_c_ok = c_ok[~starved]

        slots = np.concatenate([p_slots, done_c])
        ok = np.concatenate([p_ok, done_c_ok])
        status = np.where(ok, lat.COMMITTED, lat.USER_ABORTED)
        rec.record(pool.tenant[slots], pool.arrival_s[slots],
                   pool.admit_s[slots], pool.form_s[slots],
                   np.full(slots.size, commit_s), status)
        self.stats.committed += int(ok.sum())
        self.stats.user_aborted += int((~ok).sum())

        # notify closed-loop clients (tenant-keyed)
        now = self.clock()
        for c in self.clients:
            if hasattr(c, "on_complete"):
                n = int((pool.tenant[slots] == c.tenant).sum())
                if n:
                    c.on_complete(n, now)

        # measured telemetry → Eq. 1–2 planning + latency model (the last
        # recorded chunk is exactly this epoch's completions)
        if slots.size:
            qd = rec.mean_queue_delay_ms()
            cl = float((commit_s - pool.arrival_s[slots]).mean()) * 1e3
            self.engine.controller.observe_latency(qd, cl)
        pool.release(slots)

    # ------------------------------------------------------------------
    def warmup(self, n: int = 2):
        """Run empty epochs before the clock starts: the batcher emits
        FIXED shapes, so an empty formed batch loads every kernel library
        (building any not yet built) and allocates the buffers live traffic
        will reuse — no first-call stall inside the measured window."""
        self._t0 = time.perf_counter()
        for _ in range(n):
            batch, plan = self.batcher.form(0.0)
            assert plan.total == 0, "warmup must run before clients are pulled"
            self.engine.run_epoch(batch)

    def run(self, duration_s: float = 1.0, max_epochs: int | None = None,
            idle_sleep_s: float = 0.0002, warmup_epochs: int = 2) -> dict:
        """Serve until `duration_s` of wall clock (and the pipeline drains of
        admitted work) or `max_epochs`. Returns a summary dict."""
        if warmup_epochs:
            self.warmup(warmup_epochs)
        self._t0 = time.perf_counter()
        self._deadline = duration_s
        self.recorder.started_s = 0.0
        self._ingest(self.clock())
        batch, plan = self.batcher.form(self.clock())
        nxt = {}

        def ingest_hook():
            self._ingest(self.clock())
            with obs.span("service.batch_form", cat="service"):
                nxt["formed"] = self.batcher.form(self.clock())

        while True:
            if max_epochs is not None and self.stats.epochs >= max_epochs:
                break
            past_deadline = self.clock() >= duration_s
            if past_deadline and plan.total == 0 and self.admission.depth() == 0:
                break
            if not past_deadline and plan.total == 0 \
                    and self.admission.depth() == 0:
                time.sleep(idle_sleep_s)     # open-loop arrivals are sparse
                self._ingest(self.clock())
                batch, plan = self.batcher.form(self.clock())
                continue
            nxt.clear()
            t0 = time.perf_counter()
            m = self.engine.run_epoch(batch, ingest=ingest_hook)
            self.stats.epoch_time_s += time.perf_counter() - t0
            self.stats.ingest_time_s += m["t_ingest_s"]
            self.stats.epochs += 1
            if self.feedback is not None:
                self.feedback(batch, m)
            self._complete(plan, m)
            self._observe_epoch(m)
            batch, plan = nxt["formed"]

        self.recorder.finished_s = self.clock()
        return self.summary()

    def _observe_epoch(self, metrics: dict):
        """Per-epoch telemetry hook: one registry snapshot per committed
        epoch (ClusterTxnService extends it with per-node sampling and
        recovery-event collection)."""
        self.metrics.snapshot(self.engine.committed_epoch)

    def summary(self) -> dict:
        rec, adm = self.recorder, self.admission.stats
        p = rec.percentiles()
        out = {
            "epochs": self.stats.epochs,
            "committed": self.stats.committed,
            "user_aborted": self.stats.user_aborted,
            "throughput_txn_s": rec.throughput_txn_s(),
            "p50_ms": p.p50_ms, "p99_ms": p.p99_ms, "p999_ms": p.p999_ms,
            "mean_ms": p.mean_ms,
            "offered": adm.offered, "admitted": adm.admitted,
            "shed": adm.shed,
            "backpressured": adm.backpressured,
            "dropped_retries": sum(getattr(c, "dropped_retries", 0)
                                   for c in self.clients),
            "starved_requeues": self.stats.starved_requeues,
            "rerouted": self.admission.router.stats.rerouted,
            "max_part_depth": adm.max_part_depth,
            "max_master_depth": adm.max_master_depth,
            "ingest_overlap_s": self.stats.ingest_time_s,
            "epoch_time_s": self.stats.epoch_time_s,
        }
        return out
