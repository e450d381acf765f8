"""ReadTier: the between-fence serving loop over the snapshot catalog.
Port of ``repro.reads.tier``.

Wired into the service epoch pipeline after every commit fence:

  1. ``observe_epoch`` — purge replicas that died with a killed node
     (their retained snapshots are gone; §4.5 recovery re-registers them
     at the next fence stamp), then stamp the engine's committed read
     views into the catalog.  Secondary views refresh on a configurable
     cadence (``sec_refresh_every``) — the modeled cost of materializing
     a queryable snapshot off the replication stream — which is what
     makes ``freshness > 0`` real and the staleness bound meaningful.
  2. ``serve`` — drain the read admission lane, group by home partition,
     load-balance each group across the replicas whose freshness is
     within ``max_staleness_epochs``, and execute one snapshot read
     program per chosen replica.  Transactions with NO replica inside the
     bound re-enter their home partition's OCC queue (the fallback path:
     a bound violation is never served, it is re-routed).

On the cluster with one process a node, a group whose chosen copy lives
on another rank is served there (``reads/remote.py``): the catalog
entry of such a copy holds the hosting rank, not the tensors, and
``observe_epoch`` ends with every hosting rank keeping exactly the
snapshots its entry keeps.

Served reads commit at serve time (group-"commit" at the snapshot they
drained against) into the tier's own LatencyRecorder, so the service
reports the read vs write latency split from the same machinery.  A
serve's time runs until its outputs are ready on the device (the
executor waits on its own stream, not on the whole card).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.reads.catalog import SnapshotCatalog
from repro_torch.reads.executor import SnapshotReadExecutor
from repro_torch.service import latency as lat


@dataclass
class ReadTierStats:
    served: int = 0
    batches: int = 0
    fallbacks: int = 0             # reads re-routed to the OCC path
    stale_violations: int = 0      # served past the bound (must stay 0)
    replicas_removed: int = 0      # catalog entries purged by node death
    max_freshness_served: int = 0
    serve_time_s: float = 0.0
    served_by_freshness: dict = field(default_factory=dict)
    mid_epoch_served: int = 0      # k=0 serves below the slab watermark
    mid_epoch_deferred: int = 0    # dirty-partition reads held to the fence


class _DirtyGate:
    """ChangeLog subscriber accumulating the in-flight epoch's per-
    partition write set at slab granularity: ``dirty[p]`` is True once any
    published slab (at-or-below the current slab watermark) wrote
    partition p.  Mid-epoch k=0 reads of CLEAN partitions are provably
    watermark-fresh — the committed snapshot equals the state after
    replaying every published slab — so the tier serves them between
    fences; dirty partitions defer to the fence.  The mask is the
    changelog's host copy of each slab's write set (one (P,) copy a
    slab, made because this subscriber sets ``needs_write_mask``)."""

    needs_write_mask = True

    def __init__(self):
        self.dirty = None          # (P,) bool; None = no slabs published

    def on_slab(self, log, info):
        d = info["dirty"]
        self.dirty = d if self.dirty is None else (self.dirty | d)

    def on_commit(self, epoch, record):
        self.dirty = None

    def on_revert(self, epoch, n_slabs):
        self.dirty = None

    def on_reset(self, val, tid, epoch):
        self.dirty = None


class ReadTier:
    def __init__(self, max_staleness_epochs: int = 0,
                 sec_refresh_every: int = 1, serve_limit: int = 256,
                 retain: int | None = None):
        self.k = int(max_staleness_epochs)
        self.sec_refresh_every = max(1, int(sec_refresh_every))
        self.serve_limit = int(serve_limit)
        self.catalog = SnapshotCatalog(
            n_partitions=0, retain=retain if retain is not None
            else self.k + 2)
        self.executor = SnapshotReadExecutor()
        self.recorder = lat.LatencyRecorder()
        self.stats = ReadTierStats()
        self._gate: _DirtyGate | None = None
        # the engine's transport to copies on other ranks (one process a
        # node: ``reads/remote.py``), else None
        self.remote = None

    def attach_changelog(self, changelog) -> None:
        """Subscribe the slab-watermark dirty gate to the engine's
        changelog — enables ``serve(..., mid_epoch=True)``."""
        if self._gate is None:
            self._gate = changelog.subscribe(_DirtyGate())

    # ------------------------------------------------------------------
    def observe_epoch(self, engine, metrics: dict | None = None):
        """Commit fence reached: update the catalog from the engine's
        committed read views (and first purge what a failure killed)."""
        ev = (metrics or {}).get("recovery")
        if ev is not None:
            self._on_failure(ev)
        views = engine.read_views()
        if self.remote is None and any(v["val"] is None for v in views):
            # copies on other ranks (one process a node): serve them there
            self.remote = engine.attach_read_peers()
        for view in views:
            if self.catalog.P == 0:
                self.catalog.P = len(np.asarray(view["cover"]))
            fresh_stamp = (view["kind"] == "full"
                           or int(view["epoch"]) % self.sec_refresh_every == 0
                           or view["id"] not in self.catalog.entries)
            if fresh_stamp:
                self.catalog.stamp(view)
            else:
                self.catalog.announce_epoch(int(view["epoch"]))
        if self.remote is not None:
            # each rank that hosts a copy keeps the snapshots its entry
            # keeps here: new ones taken at this fence, the rest dropped
            ents = self.catalog.entries
            self.remote.sync_rings({
                int(v["node"]): ([e for e, _, _ in ents[v["id"]].snaps]
                                 if v["id"] in ents else [])
                for v in views if v["val"] is None})
            self.remote.close()

    def _on_failure(self, event):
        """A killed node's memory is gone: every copy it hosted leaves the
        catalog (retained snapshots included) until recovery re-stamps."""
        for n in event.failed:
            self.stats.replicas_removed += self.catalog.remove(f"sec{n}")
        if event.case.name in ("FALLBACK_DIST_CC", "UNAVAILABLE"):
            # no full replica survived the failure — it is re-replicated
            # (or disk-reloaded) by recovery and re-stamped at that fence
            self.stats.replicas_removed += self.catalog.remove("full")

    # ------------------------------------------------------------------
    def serve(self, admission, now_s: float = 0.0,
              limit: int | None = None, mid_epoch: bool = False) -> list[dict]:
        """Drain + execute one round of the read lane.  Returns the group
        results [{replica, epoch, freshness, slots, out}, ...] so callers
        (tests, ledgers) can verify the served snapshots.

        mid_epoch=True is the slab-watermark serving mode (requires
        ``attach_changelog``): DURING the in-flight epoch, k=0 reads of
        partitions no published slab has written serve from the committed
        snapshot (provably watermark-fresh); reads of dirty partitions —
        and reads with no freshness-0 replica — re-enter the read lane's
        FRONT and serve at the fence instead of falling back to OCC."""
        if mid_epoch and self._gate is None:
            return []                  # no changelog wired: fence-only mode
        got = admission.drain_reads(limit if limit is not None
                                    else self.serve_limit)
        if not got:
            return []
        k_eff = 0 if mid_epoch else self.k
        dirty = self._gate.dirty if mid_epoch else None
        pool = admission.pool
        slots = np.asarray(got, np.int64)
        homes = pool.home[slots].astype(np.int64)
        groups: dict[str, dict] = {}
        fallback: list[int] = []
        defer: list[int] = []
        for p in np.unique(homes):
            sel = slots[homes == p]
            if dirty is not None and dirty[int(p)]:
                # a slab at-or-below the watermark wrote this partition:
                # the committed snapshot is no longer watermark-fresh here
                defer.extend(int(s) for s in sel)
                continue
            choice = self.catalog.choose(int(p), k_eff, weight=len(sel))
            if choice is None:
                if mid_epoch:
                    defer.extend(int(s) for s in sel)
                else:
                    fallback.extend(int(s) for s in sel)
                continue
            ent, epoch, snap, arow = choice
            g = groups.setdefault(ent.replica_id,
                                  {"ent": ent, "epoch": epoch, "snap": snap,
                                   "slots": [], "arow": []})
            g["slots"].extend(int(s) for s in sel)
            g["arow"].extend([arow] * len(sel))

        results = []
        served: list[np.ndarray] = []
        for rid, g in groups.items():
            freshness = self.catalog.current_epoch - g["epoch"]
            if freshness > k_eff:
                # belt and braces: eligibility already enforced the bound —
                # over-stale data is NEVER returned, it re-routes to OCC
                self.stats.stale_violations += len(g["slots"])
                fallback.extend(g["slots"])
                continue
            gs = np.asarray(g["slots"], np.int64)
            t0 = time.perf_counter()
            args = (np.asarray(g["arow"], np.int64), pool.row[gs],
                    pool.kind[gs], pool.delta[gs])
            if "host" in g["snap"]:
                # the copy lives on another rank, which serves the group
                out = self.remote.read(g["snap"]["host"], g["epoch"], *args)
            else:
                # returns once the outputs are ready on the device
                out = self.executor.run(g["snap"], *args)
            t1 = time.perf_counter()
            obs.complete("reads.serve_batch", "reads", t0, t1,
                         replica=rid, reads=int(gs.size),
                         freshness=freshness, mid_epoch=mid_epoch)
            self.stats.serve_time_s += t1 - t0
            self.stats.batches += 1
            self.stats.served += gs.size
            self.stats.max_freshness_served = max(
                self.stats.max_freshness_served, freshness)
            byf = self.stats.served_by_freshness
            byf[freshness] = byf.get(freshness, 0) + gs.size
            n = gs.size
            self.recorder.record(pool.tenant[gs], pool.arrival_s[gs],
                                 pool.admit_s[gs], np.full(n, now_s),
                                 np.full(n, now_s),
                                 np.full(n, lat.COMMITTED))
            served.append(gs)
            if mid_epoch:
                self.stats.mid_epoch_served += gs.size
            results.append({"replica": rid, "epoch": g["epoch"],
                            "freshness": freshness, "slots": gs,
                            "out": out})
        if self.remote is not None:
            self.remote.close()
        if served:
            admission.pool.release(np.concatenate(served))
        if defer:
            admission.requeue_reads_front(defer)
            self.stats.mid_epoch_deferred += len(defer)
            obs.instant("reads.mid_epoch_defer", "reads", reads=len(defer))
        if fallback:
            admission.requeue_reads_occ(fallback)
            self.stats.fallbacks += len(fallback)
        return results

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        p = self.recorder.percentiles()
        s = self.stats
        return {
            "read_served": s.served,
            "read_txn_s": self.recorder.throughput_txn_s(),
            "read_p50_ms": p.p50_ms, "read_p99_ms": p.p99_ms,
            "read_fallbacks": s.fallbacks,
            "read_stale_violations": s.stale_violations,
            "read_max_freshness": s.max_freshness_served,
            "read_by_replica": self.catalog.serves_by_replica(),
            "read_replicas_removed": s.replicas_removed,
            "read_serve_time_s": round(s.serve_time_s, 6),
            "read_mid_epoch_served": s.mid_epoch_served,
            "read_mid_epoch_deferred": s.mid_epoch_deferred,
        }
