"""ClusterRuntime: the distributed STAR runtime over simulated nodes on one
card, port of ``repro.cluster.runtime``.

Composes the pieces the paper's cluster runs as separate processes:

* :class:`~repro_torch.core.cluster.ClusterStarEngine` — the cluster
  execution (slab-streamed partitioned phase whose op stream ships to the
  full replica and the physical secondary homes DURING execution, the
  commit-counter fence waiting only on the unshipped tail slab,
  single-master phase on the full replica, value + index-stream
  scatter-back);
* :class:`~repro_torch.cluster.coordinator.Coordinator` — the §4.5 view service
  owning the :class:`PhaseController` (phase switching at the fence) and
  the failure/recovery state machine;
* :class:`~repro_torch.db.wal.Durability` — per-NODE write-ahead logs (node n
  logs its ``ppn`` partitions' committed record streams AND, for
  index-bearing workloads, their ordered index-op streams; the master's
  value stream is split to each owner's log) flushed at the commit fence,
  with checkpoints on cadence;
* :class:`~repro_torch.core.fault.FaultInjector` — kills nodes at chosen
  epochs, optionally MID-STREAM (after a chosen slab shipped).

Failure semantics (simulation contract, see DESIGN.md "Cluster runtime"):
a node killed during epoch e misses e's fence, so e never commits — the
runtime runs the doomed epoch to the fence (``commit=False``; its wall
time is real lost work) or aborts it mid-stream at the killed slab,
reverts every replica to epoch e-1 via the two-version snapshots (which
also discards every stream slab the replicas consumed in-flight — the
slab high-watermark guarantees the re-executed epoch applies each slab to
committed state exactly once), and physically destroys what died with the
node: its primary partition block AND the secondary copy it hosted.  The
coordinator classifies the failure (four ``RecoveryCase``s), restores
dead blocks from the full replica (donor copy) or — when no full replica
survives — from the PHYSICAL surviving secondary copies, rebuilds a dead
full replica from the complete partial set (re-replication all-gather),
or reloads checkpoint+logs (records and index segments) from disk in the
UNAVAILABLE case, re-masters orphaned partitions, revives the nodes
(§4.5.3 copy + catch-up, secondary slices resynced), re-executes the
reverted epoch, and reports the measured recovery latency in the epoch
metrics.

``run_epoch`` keeps the ``StarEngine.run_epoch`` metric surface, so
``service.TxnService`` (and :class:`ClusterTxnService`) drive the cluster
runtime unchanged — full-mix TPC-C included (``indexes=...``).  The
recovery latency is read on the host clock after the card is
synchronised, so it covers the restores' device copies.

With ``distributed=True`` the nodes are the ranks of the default process
group, one process a node (``core.cluster.DistClusterStarEngine``), and
every rank runs the runtime in step with the same injector schedule: the
coordinator's view service decides on the master (rank 0) and broadcasts
its recovery plan and view; a kill scribbles the killed rank's blocks and
the process stays up, as the reference's device does; each rank writes
its own node's write-ahead log (``Durability(..., worker=rank)``, one
shared directory) and the master the checkpoints, and the UNAVAILABLE
case reloads from those logs on the master, which sends each rank its
blocks.  The other ranks run :meth:`ClusterRuntime.follow` under a
service on the master (``cluster.service.serve_cluster``).

Both read lanes run there on the master.  The analytics lane's views
subscribe to the master's changelog, which publishes every node's slab
log, and seed from its committed full copy.  The read tier's catalog
holds the full copy and node 0's secondary copy; a group it sends to
``sec{m}`` runs on rank m from that rank's own retained snapshot
(``reads/remote.py``).  A follower answers such a read round at the
fence, while it waits for the next epoch, and mid-epoch at its slab
boundaries, by point-to-point messages only, so the partitioned phase
stays free of collective calls.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.cluster.coordinator import Coordinator, RecoveryEvent
from repro_torch.core.cluster import ClusterStarEngine, DistClusterStarEngine
from repro_torch.core.fault import ClusterConfig, FaultInjector, RecoveryCase
from repro_torch.db import wal as walmod
from repro_torch.obs import trace as obs


class ClusterRuntime:
    def __init__(self, n_nodes: int, n_partitions: int,
                 rows_per_partition: int,
                 n_cols: int = 10, init_val=None, max_rounds: int = 16,
                 iteration_ms: float = 10.0, f: int = 1,
                 replicas_per_partition: int = 2,
                 adaptive_epoch: bool = False,
                 durability: walmod.Durability | None = None,
                 injector: FaultInjector | None = None,
                 indexes=None, net=None, n_slabs: int = 4, device=None,
                 distributed: bool = False):
        """n_nodes: the simulated nodes, or with ``distributed`` the group's
        ranks (module docstring).  device: ``None``/``"cuda"`` (raises
        without a card) or ``"cpu"``."""
        kw = dict(n_cols=n_cols, init_val=init_val, max_rounds=max_rounds,
                  iteration_ms=iteration_ms, adaptive_epoch=adaptive_epoch,
                  indexes=indexes, net=net, n_slabs=n_slabs, device=device)
        self.distributed = distributed
        if distributed:
            self.eng = DistClusterStarEngine(n_partitions,
                                             rows_per_partition, **kw)
            assert self.eng.n_nodes == n_nodes, (self.eng.n_nodes, n_nodes)
        else:
            self.eng = ClusterStarEngine(n_nodes, n_partitions,
                                         rows_per_partition, **kw)
        N = self.eng.n_nodes
        # the topology must describe the copies that physically exist:
        # primary blocks + (multi-node) one materialized secondary home
        phys_replicas = 2 if self.eng.secondary else 1
        self.topology = ClusterConfig(
            f=min(f, N), k=N, n_partitions=n_partitions,
            replicas_per_partition=min(replicas_per_partition,
                                       phys_replicas, N),
            ppn=self.eng.ppn)
        self.coordinator = Coordinator(self.topology, self.eng.controller)
        self.injector = injector
        self.durability = durability
        if durability is not None:
            eng = self.eng
            assert durability.n_workers == N, (durability.n_workers, N)
            part_ids = None
            if distributed:
                assert durability.worker == eng.rank, (durability.worker,
                                                       eng.rank)
                if eng.is_master:     # the master's full copy = the set
                    durability.attach(eng.full_val, eng.full_tid,
                                      indexes=eng.full_idx
                                      if eng.has_index else None)
                else:
                    part_ids = eng._part_ids.cpu().numpy()
            else:
                durability.attach(eng.part_val, eng.part_tid,
                                  indexes=eng.part_idx
                                  if eng.has_index else None)
            # the WAL is a changelog subscriber: at every commit fence the
            # sink fans the epoch's streams to the per-node logs and
            # flushes (the disk part of the group commit), checkpointing
            # the committed snapshot on cadence
            eng.changelog.subscribe(walmod.WalSink(
                durability, eng.R, eng.C, np.arange(eng.P) // eng.ppn,
                self._committed_snapshot, part_ids=part_ids))

    def _committed_snapshot(self):
        """(val, tid, indexes) of the committed partition set — the WAL
        sink's checkpoint source (the snapshot buffers; the sink copies
        them to the host when it writes a checkpoint)."""
        snap = self.eng._snap
        if self.distributed:
            if not self.eng.is_master:
                return None, None, None
            return (snap["full_val"], snap["full_tid"],
                    snap["full_idx"] if self.eng.has_index else None)
        return (snap["part_val"], snap["part_tid"],
                snap["part_idx"] if self.eng.has_index else None)

    # -- StarEngine-compatible surface ----------------------------------
    @property
    def P(self):
        return self.eng.P

    @property
    def R(self):
        return self.eng.R

    @property
    def C(self):
        return self.eng.C

    @property
    def controller(self):
        return self.eng.controller

    @property
    def stats(self):
        return self.eng.stats

    @property
    def epoch(self):
        return self.eng.epoch

    @property
    def n_nodes(self):
        return self.eng.n_nodes

    @property
    def committed_epoch(self):
        return self.eng.committed_epoch

    @property
    def changelog(self):
        return self.eng.changelog

    def committed_state(self):
        return self.eng.committed_state()

    def read_views(self):
        return self.eng.read_views()

    @property
    def read_peers(self):
        """The master's transport to copies on other ranks, once the read
        tier attached it (None on one process and off the master)."""
        return getattr(self.eng, "read_peers", None)

    def attach_read_peers(self):
        """The master's transport to copies on other ranks, made on the
        first call (``DistClusterStarEngine.attach_read_peers``)."""
        return self.eng.attach_read_peers()

    def replica_consistent(self) -> bool:
        return self.eng.consistent()

    def follow(self, on_epoch=None):
        """A rank other than the master under a service: run epochs in step
        with the master's until it calls :meth:`stop_followers`, answering
        the master's read rounds: at the fence (while it waits for the
        next epoch) and mid-epoch (at its slab boundaries).
        ``on_epoch(metrics)`` runs after each epoch, where the master runs
        the same collective calls right after its ``run_epoch``.  Returns
        the epochs run."""
        n = 0
        while (m := self.run_epoch(None)) is not None:
            n += 1
            if on_epoch is not None:
                on_epoch(m)
        return n

    def stop_followers(self):
        self.eng.stop_followers()

    # ------------------------------------------------------------------
    def run_epoch(self, batch, ingest=None) -> dict:
        slab_kills = (self.injector.slab_kills(self.epoch)
                      if self.injector is not None else {})
        kills = (self.injector.poll(self.epoch)
                 if self.injector is not None else set())
        if not kills:
            return self.eng.run_epoch(batch, ingest=ingest)
        # ---- failure epoch: the phases run, the fence detects the miss —
        # nothing commits, the doomed wall time is real lost work.  A
        # mid-stream kill aborts the phase at the killed slab: a PREFIX of
        # the op stream is already applied on the replicas.
        abort_check = ((lambda s: s in slab_kills) if slab_kills else None)
        doomed = self.eng.run_epoch(batch, ingest=ingest, commit=False,
                                    abort_check=abort_check)
        if doomed is None:              # the master ended the service
            return None
        if slab_kills and "aborted_at_slab" not in doomed:
            # a slab index past the executed range would silently test the
            # plain fence-miss path instead of the mid-stream one — discard
            # the doomed epoch and un-kill before raising so a caller that
            # catches the error is not left running on uncommitted state
            self.eng.revert_to_snapshot()
            self.injector.revive(kills)
            raise ValueError(
                f"mid-stream kill scheduled at slab(s) "
                f"{sorted(slab_kills)} but epoch {self.epoch} executed "
                f"only {doomed.get('slabs')} slab(s) — slab index out of "
                f"range for this batch/n_slabs configuration")
        t0 = time.perf_counter()
        with obs.span("recovery", cat="recovery", epoch=self.epoch,
                      failed=str(sorted(kills))) as rspan:
            event = self._recover(kills)
            self.eng._sync()
            event.t_recovery_s = time.perf_counter() - t0
            event.aborted_at_slab = doomed.get("aborted_at_slab")
            rspan.set(case=event.case.name, run_mode=event.run_mode,
                      aborted_at_slab=event.aborted_at_slab)
            with obs.span("recovery.remaster", cat="recovery",
                          view=self.coordinator.view + 1):
                self.coordinator.recovered(event, set(kills))
                self.injector.revive(kills)
            # ---- resume: re-execute the reverted epoch (ingest already
            # ran); the changelog's watermark was reset by the revert, so
            # the stream re-publishes from slab 0 onto the reverted base —
            # exactly once
            with obs.span("recovery.reexecute", cat="recovery",
                          epoch=self.epoch):
                m = self.eng.run_epoch(batch)
        m["recovery"] = event
        return m

    # ------------------------------------------------------------------
    def _recover(self, kills: set) -> RecoveryEvent:
        """§4.5: revert, classify, restore, re-master."""
        eng, coord = self.eng, self.coordinator
        epoch = self.epoch
        with obs.span("recovery.classify", cat="recovery", epoch=epoch,
                      failed=str(sorted(kills))) as csp:
            if not self.distributed:
                plan = coord.fence_missed(epoch, kills)
            else:
                # the view service lives on the master: it classifies and
                # broadcasts the plan and the new view
                view = None
                if eng.is_master:
                    plan = coord.fence_missed(epoch, kills)
                    view = (plan, coord.view, set(coord.alive),
                            dict(coord.master_of))
                plan, coord.view, coord.alive, coord.master_of = \
                    eng.comm.broadcast_object(view)
            csp.set(case=plan.case.name, run_mode=plan.run_mode)
        failed = set(range(self.topology.n_nodes)) - coord.alive
        # revert every replica to the last committed epoch (§4.5.2) —
        # discarding the in-flight stream slabs the replicas consumed
        hwm_before = eng._slab_hwm
        with obs.span("recovery.revert", cat="recovery", epoch=epoch,
                      to_epoch=plan.revert_to_epoch,
                      slabs_discarded=hwm_before):
            eng.revert_to_snapshot()
        # physical memory loss: EVERYTHING a killed node held dies with it
        # — its primary block and the secondary copy it hosted; full
        # replicas die with their node
        lost = set(coord.lost_blocks(failed)) & set(kills)
        full_dead = all(n in failed for n in range(self.topology.f))
        for n in sorted(kills):
            eng.scribble_node(n)
        if full_dead:
            eng.scribble_full()
        reloaded = False
        from_secondary: tuple = ()
        if plan.case in (RecoveryCase.PHASE_SWITCHING,
                         RecoveryCase.FULL_ONLY):
            # donor copy from the surviving full replica (§4.5.3 case 1/3):
            # every killed node re-copies its block on rejoin, lost or not
            with obs.span("recovery.restore", cat="recovery",
                          source="full_replica", nodes=str(sorted(kills))):
                eng.restore_nodes_from_full(sorted(kills))
        elif plan.case is RecoveryCase.FALLBACK_DIST_CC:
            # no full replica left; the partial set is complete — dead
            # blocks restore from their PHYSICAL surviving secondary
            # copies (the actual §4.5.3 case-2 copy, not a snapshot
            # stand-in), then a full copy re-replicates from the partials
            restorable = [n for n in sorted(kills)
                          if eng.secondary
                          and eng.sec_home(n) not in failed]
            if restorable:
                with obs.span("recovery.restore", cat="recovery",
                              source="secondary_copy",
                              nodes=str(restorable)):
                    eng.restore_blocks_from_secondary(restorable)
                from_secondary = tuple(restorable)
            with obs.span("recovery.restore", cat="recovery",
                          source="rebuild_full_from_partials"):
                eng.rebuild_full_from_partials()
        else:                                   # UNAVAILABLE: disk or halt
            if self.durability is None:
                raise RuntimeError(
                    "cluster UNAVAILABLE (no full replica, incomplete "
                    "partial set) and no durability attached: halt")
            with obs.span("recovery.restore", cat="recovery",
                          source="disk_wal"):
                if self.distributed:
                    # every node flushed its log at the last fence
                    eng.comm.barrier()
                if not self.distributed or eng.is_master:
                    val, tid, idx, e_c = walmod.recover_full(
                        self.durability.dir, device=eng.device)
                else:
                    val = tid = idx = None
                eng.load_committed(val, tid, indexes=idx)
            reloaded = True
        return RecoveryEvent(
            epoch=epoch, failed=tuple(sorted(kills)), case=plan.case,
            run_mode=plan.run_mode, reverted_to=plan.revert_to_epoch,
            view=coord.view, lost_blocks=tuple(sorted(lost)),
            reloaded_from_disk=reloaded,
            restored_from_secondary=from_secondary,
            slabs_discarded=hwm_before)
