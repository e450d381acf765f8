"""Admission control (§4.3 router nodes + bounded ingest), port of
``repro.service.admission`` (host-side numpy, as the reference is).

Arriving request chunks are classified by the vectorized `core.router`:
single-partition transactions enter their home partition's bounded FIFO
queue (the partitioned-phase feed), cross-partition — and mis-declared
"single" — transactions enter the bounded master queue (the single-master
feed).  When a queue is full the controller applies the configured policy:

  shed         — reject the excess outright (client sees an error; the load
                 generator counts it) — queues never grow without bound;
  backpressure — refuse the excess but report it back to the caller, who
                 retries next tick (open-loop clients keep a bounded retry
                 buffer; closed-loop clients simply stall).

Admitted requests live in a columnar `RequestPool` (structure-of-arrays,
grow-by-doubling, free-list recycling) so the epoch batcher can drain queues
into the engine's device formats with pure fancy-indexed gathers.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.core.router import Router, globalize_rows

SHED, BACKPRESSURE = "shed", "backpressure"


@dataclass
class AdmissionConfig:
    part_queue_cap: int = 256       # per-partition single-partition bound
    master_queue_cap: int = 1024    # cross-partition (master node) bound
    policy: str = SHED              # "shed" | "backpressure"
    # cluster: total bound across ONE NODE's partition queues (requires
    # node_of_partition on the controller) — a hot node sheds before its
    # partitions individually fill, modeling per-node ingest memory
    node_queue_cap: int | None = None
    # read tier: bound on the snapshot-read lane (active only when the
    # controller is built with read_lane=True)
    read_queue_cap: int = 1024


@dataclass
class AdmissionStats:
    offered: int = 0
    admitted: int = 0
    shed: int = 0
    backpressured: int = 0
    requeued: int = 0               # starved OCC txns pushed back (front)
    max_part_depth: int = 0
    max_master_depth: int = 0
    max_read_depth: int = 0
    # per-queue rejection attribution — the array is ALWAYS sized P + 2:
    # index p < P = partition p's queue, index P = the master queue,
    # index P + 1 = the read-tier lane (0 when no read lane is wired);
    # cluster telemetry groups the first P + 1 by node (node_shed)
    rejected_by_queue: np.ndarray | None = None


class RequestPool:
    """Columnar in-flight request store. `row` holds partition-local rows
    for singles and pre-globalized master rows for cross txns."""

    def __init__(self, max_ops: int, n_cols: int, capacity: int = 2048):
        self.M, self.C = max_ops, n_cols
        self.capacity = 0
        self._grow(capacity)
        self.live = 0

    def _grow(self, new_cap: int):
        def extend(name, shape, dtype):
            new = np.zeros(shape, dtype)
            if self.capacity:
                new[:self.capacity] = getattr(self, name)
            setattr(self, name, new)
        extend("row", (new_cap, self.M), np.int32)
        extend("kind", (new_cap, self.M), np.int32)
        extend("delta", (new_cap, self.M, self.C), np.int32)
        extend("user_abort", (new_cap,), bool)
        extend("is_cross", (new_cap,), bool)
        extend("home", (new_cap,), np.int32)
        extend("tenant", (new_cap,), np.int32)
        extend("txn_id", (new_cap,), np.int64)
        extend("arrival_s", (new_cap,), np.float64)
        extend("admit_s", (new_cap,), np.float64)
        extend("form_s", (new_cap,), np.float64)
        self._free = list(range(new_cap - 1, self.capacity - 1, -1)) + \
            (self._free if self.capacity else [])
        self.capacity = new_cap

    def alloc(self, n: int) -> np.ndarray:
        while len(self._free) < n:
            self._grow(self.capacity * 2)
        idx = np.array([self._free.pop() for _ in range(n)], np.int64)
        self.live += n
        return idx

    def release(self, idx: np.ndarray):
        self._free.extend(int(i) for i in idx)
        self.live -= len(idx)


class AdmissionController:
    """Bounded per-partition + master queues over a shared request pool."""

    def __init__(self, n_partitions: int, rows_per_partition: int,
                 max_ops: int, n_cols: int = 10,
                 cfg: AdmissionConfig | None = None,
                 router: Router | None = None,
                 pool: RequestPool | None = None,
                 node_of_partition=None, read_lane: bool = False):
        self.P, self.R = n_partitions, rows_per_partition
        self.cfg = cfg or AdmissionConfig()
        self.router = router or Router(n_partitions, rows_per_partition,
                                       max_ops, n_cols)
        self.pool = pool or RequestPool(max_ops, n_cols)
        self.part_queues = [deque() for _ in range(n_partitions)]
        self.master_queue = deque()
        # read tier: declared-read-only single-home transactions bypass the
        # OCC queues into this bounded lane (drained by reads.ReadTier)
        self.read_lane = bool(read_lane)
        self.read_queue = deque()
        # cluster: which node owns each partition's queue (per-node caps
        # + per-node shed/depth telemetry); None = single-node service
        self.node_of_partition = (np.asarray(node_of_partition, np.int64)
                                  if node_of_partition is not None else None)
        self.stats = AdmissionStats()
        # sized P + 2 unconditionally (read-lane slot is zero without a
        # read lane) so every consumer indexes one fixed layout
        self.stats.rejected_by_queue = np.zeros(n_partitions + 2, np.int64)

    # ------------------------------------------------------------------
    def offer(self, req: dict, now_s: float):
        """Classify + admit one arrival chunk.

        req: {'parts' (B,M), 'rows' (B,M), 'kinds', 'deltas', 'user_abort',
        'home' (declared home, -1 = undeclared), 'txn_id', 'tenant',
        'arrival_s'}.  Returns a boolean `rejected` mask over the chunk
        (True = not admitted this tick: shed or backpressured)."""
        B = req["parts"].shape[0]
        self.stats.offered += B
        if B == 0:
            return np.zeros(0, bool)
        is_cross, home = self.router.classify(
            req["parts"], req["kinds"], req["home"])

        admitted = np.zeros(B, bool)
        dest = np.where(is_cross, -1, home).astype(np.int64)
        # read tier: declared-read-only single-home transactions take the
        # bounded read lane instead of the OCC queues
        ro = req.get("read_only")
        to_read = (np.asarray(ro, bool) & ~is_cross
                   if self.read_lane and ro is not None
                   else np.zeros(B, bool))
        # per-node ingest budget (cluster): a node's partition queues share
        # one bound on top of the per-partition caps
        node_budget = None
        if self.node_of_partition is not None \
                and self.cfg.node_queue_cap is not None:
            n_nodes = int(self.node_of_partition.max()) + 1
            depth = np.zeros(n_nodes, np.int64)
            for p, q in enumerate(self.part_queues):
                depth[self.node_of_partition[p]] += len(q)
            node_budget = np.maximum(self.cfg.node_queue_cap - depth, 0)
        # singles, per home partition (≤P small iterations, vectorized body)
        for p in np.unique(dest[dest >= 0]):
            q = self.part_queues[p]
            room = max(0, self.cfg.part_queue_cap - len(q))
            if node_budget is not None:
                n = self.node_of_partition[p]
                room = min(room, int(node_budget[n]))
            sel = np.nonzero((dest == p) & ~to_read)[0]
            take = sel[:room]
            if node_budget is not None:
                node_budget[self.node_of_partition[p]] -= len(take)
            admitted[take] = True
        cross_sel = np.nonzero(is_cross)[0]
        cross_take = cross_sel[:max(0, self.cfg.master_queue_cap
                                    - len(self.master_queue))]
        admitted[cross_take] = True
        read_sel = np.nonzero(to_read)[0]
        read_take = read_sel[:max(0, self.cfg.read_queue_cap
                                  - len(self.read_queue))]
        admitted[read_take] = True

        aidx = np.nonzero(admitted)[0]
        if aidx.size:
            pool, slots = self.pool, self.pool.alloc(aidx.size)
            # cross rows are globalized once, here, at admission
            pool.row[slots] = np.where(
                is_cross[aidx, None],
                globalize_rows(req["parts"][aidx], req["rows"][aidx], self.R),
                req["rows"][aidx])
            pool.kind[slots] = req["kinds"][aidx]
            pool.delta[slots] = req["deltas"][aidx]
            pool.user_abort[slots] = req["user_abort"][aidx]
            pool.is_cross[slots] = is_cross[aidx]
            pool.home[slots] = np.where(is_cross[aidx], -1, home[aidx])
            pool.tenant[slots] = req["tenant"][aidx]
            pool.txn_id[slots] = req["txn_id"][aidx]
            pool.arrival_s[slots] = req["arrival_s"][aidx]
            pool.admit_s[slots] = now_s
            for k, i in zip(aidx, slots):
                if to_read[k]:
                    self.read_queue.append(int(i))
                elif is_cross[k]:
                    self.master_queue.append(int(i))
                else:
                    self.part_queues[int(home[k])].append(int(i))

        rejected = ~admitted
        n_rej = int(rejected.sum())
        self.stats.admitted += int(aidx.size)
        if n_rej:
            rq = np.where(dest[rejected] >= 0, dest[rejected], self.P)
            rq = np.where(to_read[rejected], self.P + 1, rq)
            np.add.at(self.stats.rejected_by_queue, rq, 1)
        if self.cfg.policy == SHED:
            self.stats.shed += n_rej
        else:
            self.stats.backpressured += n_rej
        self.stats.max_part_depth = max(
            self.stats.max_part_depth,
            max((len(q) for q in self.part_queues), default=0))
        self.stats.max_master_depth = max(self.stats.max_master_depth,
                                          len(self.master_queue))
        self.stats.max_read_depth = max(self.stats.max_read_depth,
                                        len(self.read_queue))
        return rejected

    # ------------------------------------------------------------------
    def drain_singles(self, p: int, limit: int) -> list[int]:
        q = self.part_queues[p]
        return [q.popleft() for _ in range(min(limit, len(q)))]

    def drain_master(self, limit: int) -> list[int]:
        q = self.master_queue
        return [q.popleft() for _ in range(min(limit, len(q)))]

    def requeue_master_front(self, slots):
        """Starved OCC transactions re-enter at the FRONT, preserving FIFO."""
        self.master_queue.extendleft(reversed([int(s) for s in slots]))
        self.stats.requeued += len(slots)

    # -- read tier -------------------------------------------------------
    def drain_reads(self, limit: int) -> list[int]:
        q = self.read_queue
        return [q.popleft() for _ in range(min(limit, len(q)))]

    def requeue_reads_front(self, slots):
        """Mid-epoch deferral: reads whose home partition a published slab
        already dirtied re-enter the READ lane at the front (in their
        original order) — they serve at the next fence, not via OCC."""
        self.read_queue.extendleft(reversed([int(s) for s in slots]))
        self.stats.requeued += len(slots)

    def requeue_reads_occ(self, slots):
        """Staleness-bound fallback: reads with NO replica inside the bound
        re-enter their home partition's OCC queue at the FRONT (they are
        the oldest admitted work) — over-stale data is never served, the
        transaction executes fence-fresh through the normal phases."""
        for s in reversed([int(s) for s in slots]):
            self.part_queues[int(self.pool.home[s])].appendleft(int(s))
        self.stats.requeued += len(slots)

    def read_depth(self) -> int:
        return len(self.read_queue)

    def depth(self) -> int:
        return sum(len(q) for q in self.part_queues) \
            + len(self.master_queue) + len(self.read_queue)

    def depths(self):
        """(per-partition queue depths (P,), master queue depth)."""
        return (np.array([len(q) for q in self.part_queues], np.int64),
                len(self.master_queue))
