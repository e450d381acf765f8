"""Fault tolerance (§4.5): failure classification, revert, recovery plans.

Cluster: f nodes with full replicas, k nodes with partial replicas; the k
partial nodes collectively hold ``replicas_per_partition`` copies of each
partition (paper experiments use 2 total copies: primary + secondary hashed
to different nodes).

The coordinator (deployable as a Paxos/Raft replicated state machine — we
model it as the view service) detects failures at the replication fence,
broadcasts the failed set, reverts to the last committed epoch (two-version
records, db.revert_to_snapshot) and selects one of the paper's four recovery
cases (§4.5.3).  ``FaultInjector`` schedules the node kills the cluster
runtime detects at its fences; ``catch_up`` is the case-1 Thomas-rule
catch-up of a recovering node.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class RecoveryCase(Enum):
    PHASE_SWITCHING = 1          # ≥1 full replica AND ≥1 complete partial set
    FALLBACK_DIST_CC = 2         # no full replica, ≥1 complete partial set
    FULL_ONLY = 3                # ≥1 full replica, no complete partial set
    UNAVAILABLE = 4              # neither — reload from disk checkpoint + logs


@dataclass(frozen=True)
class ClusterConfig:
    """Replica placement.  Two layouts:

    * disjoint (default, ``ppn=None``): nodes 0..f-1 hold ONLY full
      replicas; nodes f..f+k-1 hold the partial replicas, partitions
      hashed across them — ``n_nodes = f + k``;
    * co-located contiguous (``ppn`` set — the paper's deployment and the
      cluster runtime's device mesh): every node holds a contiguous block
      of ``ppn`` primary partitions (node = partition // ppn, matching
      shard_map's contiguous sharding), nodes 0..f-1 ADDITIONALLY hold
      full replicas, and each partition's secondary partial copies land on
      the next nodes round-robin — ``n_nodes = k``.
    """
    f: int                        # nodes with full replicas
    k: int                        # nodes with partial replicas
    n_partitions: int
    replicas_per_partition: int = 2
    ppn: int | None = None        # partitions per node (co-located layout)

    def __post_init__(self):
        if self.ppn is not None:
            assert self.k * self.ppn == self.n_partitions, \
                (self.k, self.ppn, self.n_partitions)
            assert 0 < self.f <= self.k

    @property
    def n_nodes(self):
        return self.k if self.ppn is not None else self.f + self.k

    def primary_of(self, partition: int) -> int:
        """The node that masters ``partition`` in the partitioned phase."""
        if self.ppn is not None:
            return partition // self.ppn
        return self.f + partition % self.k

    def partition_homes(self, partition: int) -> list[int]:
        """Primary + secondaries for a partition among the k partial nodes
        (hashed so primary and secondary land on different nodes, §7.1.3;
        contiguous-block primary + round-robin secondaries when
        co-located)."""
        if self.ppn is not None:
            first = partition // self.ppn
            return [(first + r) % self.k
                    for r in range(min(self.replicas_per_partition, self.k))]
        homes = []
        for r in range(self.replicas_per_partition):
            homes.append(self.f + (partition + r) % self.k)
        return homes


def classify_failure(cfg: ClusterConfig, failed: set[int]) -> RecoveryCase:
    full_alive = any(n not in failed for n in range(cfg.f))
    # a complete partial set exists iff every partition has a live partial home
    complete_partial = all(
        any(h not in failed for h in cfg.partition_homes(p))
        for p in range(cfg.n_partitions))
    if full_alive and complete_partial:
        return RecoveryCase.PHASE_SWITCHING
    if complete_partial:
        return RecoveryCase.FALLBACK_DIST_CC
    if full_alive:
        return RecoveryCase.FULL_ONLY
    return RecoveryCase.UNAVAILABLE


@dataclass
class RecoveryPlan:
    case: RecoveryCase
    revert_to_epoch: int
    remaster: dict                # partition -> new master node
    copy_sources: dict            # recovering node -> source node
    run_mode: str                 # "star" | "dist_cc" | "single_node" | "halt"


def make_recovery_plan(cfg: ClusterConfig, failed: set[int],
                       committed_epoch: int) -> RecoveryPlan:
    case = classify_failure(cfg, failed)
    remaster: dict = {}
    copy_sources: dict = {}
    full_alive = [n for n in range(cfg.f) if n not in failed]
    for p in range(cfg.n_partitions):
        homes = [h for h in cfg.partition_homes(p) if h not in failed]
        if homes:
            remaster[p] = homes[0]
        elif full_alive:
            remaster[p] = full_alive[0]     # case 3: re-master onto full replica
    for n in sorted(failed):
        donors = [m for m in range(cfg.n_nodes) if m not in failed]
        if donors:
            copy_sources[n] = full_alive[0] if full_alive else donors[0]
    run_mode = {
        RecoveryCase.PHASE_SWITCHING: "star",
        RecoveryCase.FALLBACK_DIST_CC: "dist_cc",
        RecoveryCase.FULL_ONLY: "star" if any(
            h not in failed for p in range(cfg.n_partitions)
            for h in cfg.partition_homes(p)) else "single_node",
        RecoveryCase.UNAVAILABLE: "halt",
    }[case]
    return RecoveryPlan(case=case, revert_to_epoch=committed_epoch,
                        remaster=remaster, copy_sources=copy_sources,
                        run_mode=run_mode)


def catch_up(val, tidw, donor_log, thomas_apply):
    """A recovering node copies remote data and applies live updates with the
    Thomas write rule in parallel (§4.5.3 case 1)."""
    return thomas_apply(val, tidw, donor_log["row"], donor_log["val"],
                        donor_log["tid"])


# ---------------------------------------------------------------------------
# live failure injection
# ---------------------------------------------------------------------------
@dataclass
class FaultInjector:
    """Schedules node kills at chosen epochs for the cluster runtime.

    The coordinator polls the injector at every replication fence (a
    killed node's fence message never arrives — the §4.5 missed-heartbeat
    detection); a kill takes effect DURING the scheduled epoch, so that
    epoch's work is never committed: the coordinator reverts to the last
    committed epoch and runs the classified recovery.  ``killed`` tracks
    nodes currently down; recovery revives them once their state is
    restored from a donor or from disk (case-1 copy + catch-up, §4.5.3).

    ``schedule_kill(..., slab=s)`` kills the node MID-STREAM: while the
    scheduled epoch's partitioned phase executes stream slab ``s`` —
    slabs ``0..s-1`` have already shipped to the replicas, so the epoch
    aborts with that prefix of its op stream consumed, exercising the
    §4.5 revert's slab high-watermark (exactly-once re-streaming).
    ``slab=0`` kills before anything shipped (nothing to discard).
    """
    schedule: dict = field(default_factory=dict)    # epoch -> set[node]
    slab_schedule: dict = field(default_factory=dict)  # epoch -> {slab: set}
    killed: set = field(default_factory=set)
    kills_injected: int = 0

    def schedule_kill(self, node: int, epoch: int, slab: int | None = None):
        if slab is None:
            self.schedule.setdefault(int(epoch), set()).add(int(node))
        else:
            self.slab_schedule.setdefault(int(epoch), {}).setdefault(
                int(slab), set()).add(int(node))

    def slab_kills(self, epoch: int) -> dict:
        """Peek the mid-stream kills of ``epoch`` ({slab: nodes}) without
        consuming them — the runtime arms its abort check from this before
        polling the fence."""
        return {s: set(ns)
                for s, ns in self.slab_schedule.get(int(epoch), {}).items()}

    def poll(self, epoch: int) -> set[int]:
        """Nodes newly killed during ``epoch`` (mid-stream kills included —
        by fence time they are just as dead); they join ``killed``."""
        fresh = set(self.schedule.pop(int(epoch), set()))
        for nodes in self.slab_schedule.pop(int(epoch), {}).values():
            fresh |= set(nodes)
        fresh -= self.killed
        self.killed |= fresh
        self.kills_injected += len(fresh)
        return fresh

    def revive(self, nodes):
        for n in nodes:
            self.killed.discard(int(n))
