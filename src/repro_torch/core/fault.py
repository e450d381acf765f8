"""Fault tolerance (§4.5): failure classification, revert, recovery plans.

Cluster: f nodes with full replicas, k nodes with partial replicas; the k
partial nodes collectively hold ``replicas_per_partition`` copies of each
partition (paper experiments use 2 total copies: primary + secondary hashed
to different nodes).

The coordinator (deployable as a Paxos/Raft replicated state machine — we
model it as the view service) detects failures at the replication fence,
broadcasts the failed set, reverts to the last committed epoch (two-version
records, db.revert_to_snapshot) and selects one of the paper's four recovery
cases (§4.5.3).
"""
from __future__ import annotations

from dataclasses import dataclass
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
