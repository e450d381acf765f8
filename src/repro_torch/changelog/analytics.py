"""The HTAP analytics lane: CH-benCHmark-style queries off the MVs, port
of ``repro.changelog.analytics`` (host numpy, as the reference is).

CH-benCHmark runs TPC-C's decision-support cousins concurrently with the
transactional mix; here the analytical side never touches the OCC phases
at all — it reads the epoch-stamped aggregate snapshots the
:class:`~repro.changelog.views.MaterializedViews` subscriber maintains
from the ChangeLog, so queries are answered BETWEEN fences (and during
the in-flight epoch) with fence-consistent results, plus fence-granular
time-travel to any retained epoch.

The lane plugs into ``TxnService`` next to the
read tier: ``ensure_attached`` subscribes the views to the engine's
changelog (seeding them from the committed full-replica state) and
``serve`` runs one round of the query mix, stamping per-query latency:

* ``top_revenue``    — top-k (warehouse, district) pairs by ring revenue;
* ``stock_low``      — warehouses ranked by stock-below-threshold count;
* ``undelivered``    — max / total NEW-ORDER backlog depth per district;
* ``order_latency``  — fleet-wide NewOrder→Delivery latency histogram
  (order-id distance buckets) plus the worst district's p-high bucket;
* ``revenue_delta``  — time-travel: revenue movement between the oldest
  and newest retained fence (periodic, exercises the stamp history).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.changelog.views import LATENCY_BUCKETS, MaterializedViews
from repro_torch.obs import trace as obs


class AnalyticsLane:
    """Serves the analytical query mix from epoch-stamped MV snapshots."""

    QUERIES = ("top_revenue", "stock_low", "undelivered", "order_latency",
               "revenue_delta")

    def __init__(self, cfg, top_k: int = 5, stock_threshold: int = 15,
                 retain: int = 8, travel_every: int = 4):
        self.views = MaterializedViews(cfg, stock_threshold=stock_threshold,
                                       retain=retain)
        self.top_k = int(top_k)
        self.travel_every = int(travel_every)
        self._attached = False
        self.serves = 0
        self.queries = 0
        self.by_query = {q: 0 for q in self.QUERIES}
        self.query_s = 0.0
        self.lat_ms: list = []
        self.max_epoch_lag = 0
        self.last: dict = {}

    # -- wiring ----------------------------------------------------------
    def ensure_attached(self, engine) -> bool:
        """Subscribe the views to ``engine.changelog``, seeding the
        projection from the committed full-replica state (the views copy
        it: the engine's snapshot buffers change at the next fence)."""
        if self._attached:
            return True
        clog = getattr(engine, "changelog", None)
        if clog is None:
            return False
        val, tid = engine.committed_state()
        clog.subscribe(self.views)
        self.views.on_reset(val, tid, engine.committed_epoch)
        self._attached = True
        return True

    # -- query mix -------------------------------------------------------
    def serve(self, committed_epoch: int, now_s: float | None = None):
        """One round of the analytical mix against the freshest stamp.
        Returns the results dict (also kept in ``self.last``)."""
        stamp = self.views.latest()
        if stamp is None:
            return None
        epoch, aggs = stamp
        self.max_epoch_lag = max(self.max_epoch_lag,
                                 int(committed_epoch) - int(epoch))
        out = {"epoch": int(epoch)}
        t0 = time.perf_counter()
        out["top_revenue"] = self._q_top_revenue(aggs)
        out["stock_low"] = self._q_stock_low(aggs)
        out["undelivered"] = self._q_undelivered(aggs)
        out["order_latency"] = self._q_order_latency(aggs)
        ran = 4
        if self.serves % self.travel_every == 0:
            delta = self._q_revenue_delta()
            if delta is not None:
                out["revenue_delta"] = delta
                ran += 1
        dt = time.perf_counter() - t0
        obs.complete("analytics.serve", "service", t0, t0 + dt,
                     epoch=int(epoch), queries=ran)
        self.query_s += dt
        self.lat_ms.append(1e3 * dt / ran)
        self.serves += 1
        self.queries += ran
        self.last = out
        return out

    def _q_top_revenue(self, aggs):
        self.by_query["top_revenue"] += 1
        rev = aggs["revenue"]
        flat = rev.reshape(-1)
        k = min(self.top_k, flat.size)
        top = np.argsort(flat, kind="stable")[::-1][:k]
        return [(int(i) // rev.shape[1], int(i) % rev.shape[1],
                 int(flat[i])) for i in top]

    def _q_stock_low(self, aggs):
        self.by_query["stock_low"] += 1
        low = aggs["stock_low"]
        return {"total": int(low.sum()), "worst_warehouse": int(low.argmax()),
                "worst_count": int(low.max())}

    def _q_undelivered(self, aggs):
        self.by_query["undelivered"] += 1
        und = aggs["undelivered"]
        return {"total": int(und.sum()), "max_depth": int(und.max()),
                "mean_depth": float(und.mean())}

    def _q_order_latency(self, aggs):
        """Fleet-wide latency histogram: sum the per-district cumulative
        bucket counts; report the distribution plus the district whose
        deliveries lag the most (largest share above the last edge)."""
        self.by_query["order_latency"] += 1
        h = aggs["order_latency"].astype(np.int64)   # (P, N_DIST, NB+1)
        fleet = h.sum(axis=(0, 1))                   # cumulative + total
        total = int(fleet[-1])
        over = h[..., -1] - h[..., -2]               # > last bucket edge
        worst = int(over.reshape(-1).argmax())
        return {
            "buckets": {f"le_{b}": int(fleet[i])
                        for i, b in enumerate(LATENCY_BUCKETS)},
            "delivered": total,
            "over_last_bucket": int(fleet[-1] - fleet[-2]),
            "worst_warehouse": worst // h.shape[1],
            "worst_district": worst % h.shape[1],
            "worst_over": int(over.reshape(-1)[worst]),
        }

    def _q_revenue_delta(self):
        epochs = self.views.retained_epochs()
        if len(epochs) < 2:
            return None
        self.by_query["revenue_delta"] += 1
        old = self.views.time_travel(epochs[0])
        new = self.views.time_travel(epochs[-1])
        d = new["revenue"].astype(np.int64) - old["revenue"].astype(np.int64)
        return {"from_epoch": epochs[0], "to_epoch": epochs[-1],
                "total": int(d.sum()), "max": int(d.max())}

    # -- surfacing -------------------------------------------------------
    def summary(self) -> dict:
        lat = np.asarray(self.lat_ms) if self.lat_ms else np.zeros(1)
        v = self.views
        return {
            "analytics_serves": self.serves,
            "analytics_queries": self.queries,
            "analytics_by_query": dict(self.by_query),
            "analytics_q_p50_ms": float(np.percentile(lat, 50)),
            "analytics_q_p99_ms": float(np.percentile(lat, 99)),
            "analytics_query_s": self.query_s,
            "analytics_max_epoch_lag": self.max_epoch_lag,
            "analytics_retained_epochs": len(v.retained_epochs()),
            "analytics_mv_slabs": v.slabs_applied,
            "analytics_mv_writes": v.writes_applied,
            "analytics_mv_commits": v.commits,
            "analytics_mv_reverts": v.reverts,
        }
