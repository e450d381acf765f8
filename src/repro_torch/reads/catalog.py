"""SnapshotCatalog: which replica can serve a read, and how fresh is it.
Port of ``repro.reads.catalog``.

Every replica copy (the master's full copy, the single-host replica
store) is registered as an entry carrying its partition coverage and the
partition -> array-row mapping of its physical layout.

At every commit fence the owning engine publishes its committed snapshot
views (``engine.read_views()``); the catalog STAMPS each entry with the
fence epoch, the per-slab high-watermark the replication ledger recorded
for that epoch, and the committed ``val/tid`` + index arrays.  A bounded
ring of recent stamped snapshots is retained per replica so reads may be
served at ``freshness = current_epoch - snapshot_epoch`` anywhere within
the configured staleness bound.

The one change of mechanism against the reference: the catalog OWNS what
it retains.  The JAX engine makes new arrays at every fence, so a
reference to them stays as stamped; the port's engine copies each fence
into the same snapshot buffers, so ``stamp`` keeps a copy of ``val``,
``tid`` and every index field.  A retained snapshot then never changes
after its fence.  Views of one fence that hold the same arrays (the
cluster engine's secondary views) share one copy.  On the card the copy
is enqueued on the current stream and an event recorded after it
(``snap["ready"]``): the read executor's own stream waits on that event
alone, not on the epoch queued behind it.

With one process a node (``core.cluster.DistClusterStarEngine``) a copy
on another rank is an entry with the same metadata whose snapshots hold
no tensors, only ``{"host": rank}``: that rank retains the snapshot
itself (``reads/remote.py``), and the catalog never copies a remote
block.

Lifecycle: a killed node's hosted copies are ``remove()``d — their
retained snapshots died with the node's memory — and re-registered by the
first post-recovery fence stamp (so freshness restarts from the recovered
epoch, exactly the §4.5 case-2 re-materialization contract).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.storage.engine import FIELDS


def _own(x):
    """A copy of one stamped array that nothing else writes."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return np.array(x, copy=True)


def snapshot_copy(val, tid, idx, own=_own) -> dict:
    """A retained snapshot of one copy: ``val``, ``tid`` and every index
    field copied by ``own``.  On the card an event is recorded after the
    copies were enqueued (``snap["ready"]``), which the read executor's
    stream waits on."""
    snap = {"val": own(val), "tid": own(tid),
            "idx": [{f: own(ix[f]) for f in FIELDS} for ix in (idx or [])]}
    val = snap["val"]
    if isinstance(val, torch.Tensor) and val.device.type == "cuda":
        snap["ready"] = torch.cuda.Event()
        snap["ready"].record(torch.cuda.current_stream(val.device))
    return snap


class _FenceCopies:
    """The copies ``stamp`` made at one fence, by source array: views of
    one fence that hold the same array (the cluster engine's secondary
    views all hold its one rolled secondary copy) share one copy."""

    def __init__(self):
        self.epoch = None
        self._made = {}            # id(source) -> (source, copy)

    def own(self, x, epoch: int):
        if epoch != self.epoch:
            self.epoch, self._made = epoch, {}
        hit = self._made.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1], False
        c = _own(x)
        self._made[id(x)] = (x, c)
        return c, True


@dataclass
class ReplicaEntry:
    replica_id: str
    kind: str                      # "full" | "secondary"
    node: int                      # hosting node (whose memory holds it)
    cover: np.ndarray              # (P,) bool — partitions this copy holds
    row_of_partition: np.ndarray   # (P,) int — partition -> array row
    snaps: deque = field(default_factory=deque)   # (epoch, snap, watermark)
    serves: int = 0                # load-balancing counter

    def latest_epoch(self) -> int | None:
        return self.snaps[-1][0] if self.snaps else None


class SnapshotCatalog:
    def __init__(self, n_partitions: int, retain: int = 4):
        """``retain`` bounds the per-replica ring of stamped snapshots —
        it must cover the staleness window (k + 1) for bound-k serving."""
        self.P = int(n_partitions)
        self.retain = max(1, int(retain))
        self.entries: dict[str, ReplicaEntry] = {}
        self.current_epoch = 0     # last fence epoch any stamp announced
        self.stamp_copies = 0      # snapshots stamped by stamp()
        self.stamp_bytes = 0       # bytes those stamps copied
        self._fence = _FenceCopies()

    # -- lifecycle -------------------------------------------------------
    def stamp(self, view: dict):
        """Register/refresh one replica from an engine read view:
        {'id','kind','node','epoch','watermark','cover','row_of_partition',
        'val','tid','idx'}.  Idempotent per (replica, epoch): a repeated
        stamp copies nothing."""
        rid = view["id"]
        ent = self.entries.get(rid)
        if ent is None:
            ent = ReplicaEntry(
                replica_id=rid, kind=view["kind"], node=int(view["node"]),
                cover=np.asarray(view["cover"], bool),
                row_of_partition=np.asarray(view["row_of_partition"],
                                            np.int64))
            self.entries[rid] = ent
        epoch = int(view["epoch"])
        self.current_epoch = max(self.current_epoch, epoch)
        if ent.snaps and ent.snaps[-1][0] >= epoch:
            return                                  # already stamped
        copied = []

        def own(x):
            c, fresh = self._fence.own(x, epoch)
            if fresh:
                copied.append(c)
            return c
        if view["val"] is None:
            # a copy on another rank: that rank keeps the snapshot
            snap = {"host": int(view["node"])}
        else:
            snap = snapshot_copy(view["val"], view["tid"], view.get("idx"),
                                 own)
        self.stamp_copies += 1
        self.stamp_bytes += sum(a.nbytes for a in copied)
        ent.snaps.append((epoch, snap, view.get("watermark")))
        while len(ent.snaps) > self.retain:
            ent.snaps.popleft()

    def announce_epoch(self, epoch: int):
        """Advance the catalog clock without stamping (a replica whose view
        was NOT refreshed this fence ages by one)."""
        self.current_epoch = max(self.current_epoch, int(epoch))

    def remove(self, replica_id: str) -> bool:
        """Node death: the copy AND its retained snapshots died with the
        node's memory.  Returns True if the entry existed."""
        return self.entries.pop(replica_id, None) is not None

    # -- freshness + choice ---------------------------------------------
    def freshness(self, replica_id: str) -> int | None:
        ent = self.entries.get(replica_id)
        if ent is None or not ent.snaps:
            return None
        return self.current_epoch - ent.latest_epoch()

    def eligible(self, partition: int, max_staleness: int):
        """Replicas covering ``partition`` whose freshest retained snapshot
        is within the staleness bound: [(entry, epoch, snap, arow), ...]."""
        out = []
        for ent in self.entries.values():
            if not ent.snaps or not ent.cover[partition]:
                continue
            epoch, snap, _wm = ent.snaps[-1]
            if self.current_epoch - epoch <= max_staleness:
                out.append((ent, epoch, snap,
                            int(ent.row_of_partition[partition])))
        return out

    def choose(self, partition: int, max_staleness: int, weight: int = 1):
        """Least-served eligible replica (round-robin load balancing across
        the copies); None = no replica within the bound (caller falls back
        to the OCC path).  ``weight`` — how many reads this choice will
        serve — feeds the balance counter."""
        cands = self.eligible(partition, max_staleness)
        if not cands:
            return None
        ent, epoch, snap, arow = min(cands, key=lambda c: (c[0].serves,
                                                           c[0].replica_id))
        ent.serves += weight
        return ent, epoch, snap, arow

    def serves_by_replica(self) -> dict:
        return {rid: ent.serves for rid, ent in self.entries.items()}
