"""The §4.5 coordinator / view service, port of
``repro.cluster.coordinator`` (pure Python, copied).

One logical coordinator (deployable as a Paxos/Raft replicated state
machine; modeled in-process) drives the cluster:

* **phase switching** — it owns the :class:`PhaseController` and publishes
  (tau_p, tau_s) from the Eq. 1-2 plan at every fence;
* **view service** — it tracks the alive set and the view number; a node
  that misses the replication fence (its commit-statistics message never
  arrives — here: the :class:`~repro_torch.core.fault.FaultInjector`
  killed it during the epoch) is declared failed, the view advances, and
  the epoch in flight is discarded;
* **recovery** — it classifies the failure into one of the paper's four
  :class:`~repro_torch.core.fault.RecoveryCase`s from the replica-set
  layout (``ClusterConfig.partition_homes``), re-masters orphaned
  partitions onto surviving replicas, and records the measured recovery
  latency.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.fault import (ClusterConfig, RecoveryCase,
                                    RecoveryPlan, make_recovery_plan)
from repro_torch.core.phase_switch import PhaseController


@dataclass
class RecoveryEvent:
    """One detected failure + the recovery that resolved it."""
    epoch: int                    # the discarded (in-flight) epoch
    failed: tuple                 # nodes that missed the fence
    case: RecoveryCase
    run_mode: str                 # "star" | "dist_cc" | "single_node" | "halt"
    reverted_to: int              # last committed epoch
    view: int                     # view number after the reconfiguration
    t_recovery_s: float = 0.0     # detection -> resumed execution
    lost_blocks: tuple = ()       # node blocks with no surviving replica
    reloaded_from_disk: bool = False
    restored_from_secondary: tuple = ()   # blocks rebuilt from the physical
                                          # surviving secondary copy
    slabs_discarded: int = 0      # in-flight stream slabs the revert dropped
                                  # (the §4.5 slab high-watermark)
    aborted_at_slab: int | None = None    # mid-stream kill position, if any


@dataclass
class Coordinator:
    cfg: ClusterConfig
    controller: PhaseController = field(default_factory=PhaseController)
    view: int = 1
    alive: set = None
    master_of: dict = None        # partition -> current master node
    events: list = field(default_factory=list)

    def __post_init__(self):
        if self.alive is None:
            self.alive = set(range(self.cfg.n_nodes))
        if self.master_of is None:
            self.master_of = {p: self.cfg.primary_of(p)
                              for p in range(self.cfg.n_partitions)}

    # ------------------------------------------------------------------
    def plan_phases(self):
        """Publish (tau_p, tau_s) for the next epoch (Eq. 1-2)."""
        return self.controller.plan()

    def fence_missed(self, epoch: int, fresh_failures: set) -> RecoveryPlan:
        """Nodes ``fresh_failures`` missed epoch ``epoch``'s fence: advance
        the view, drop them from the alive set, classify against EVERY
        currently-failed node, and return the recovery plan (the in-flight
        epoch reverts to ``epoch - 1``)."""
        self.view += 1
        self.alive -= set(fresh_failures)
        failed = set(range(self.cfg.n_nodes)) - self.alive
        plan = make_recovery_plan(self.cfg, failed, committed_epoch=epoch - 1)
        for p, m in plan.remaster.items():
            self.master_of[p] = m
        return plan

    def recovered(self, event: RecoveryEvent, rejoined: set):
        """Recovery finished: rejoined nodes re-enter the view and take
        their partitions back (the §4.5.3 catch-up completed)."""
        self.view += 1
        self.alive |= set(rejoined)
        for p in range(self.cfg.n_partitions):
            if self.cfg.primary_of(p) in self.alive:
                self.master_of[p] = self.cfg.primary_of(p)
        self.events.append(event)

    # ------------------------------------------------------------------
    def lost_blocks(self, failed: set) -> list[int]:
        """Node blocks whose EVERY partial replica home is dead — their
        partition data is physically gone from cluster memory and must be
        restored from a full replica or from disk.  (A block with any live
        home survives in the cluster: the surviving copy is the donor.)"""
        out = []
        for n in range(self.cfg.n_nodes):
            if self.cfg.ppn is None:
                continue
            p0 = n * self.cfg.ppn
            if all(h in failed for h in self.cfg.partition_homes(p0)):
                out.append(n)
        return out
