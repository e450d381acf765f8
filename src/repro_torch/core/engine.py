"""STAR engine: phase-switched epochs over the storage subsystem (§3-§5),
port of ``repro.core.engine``.

One engine instance models the cluster: the master view plus an operation
replica kept consistent purely through the replication streams — ordered
operation replication from the partitioned phase and Thomas-rule value
replication from the single-master phase, both published once on the
``ChangeLog`` and applied by the replica subscriber.  ``replica_consistent``
checks bit-equality of records and indexes.  With ``durability=`` a
``db.wal.WalSink`` subscribes after the replica and appends every committed
epoch to per-worker write-ahead logs inside the commit fence.

Every kernel of the epoch runs on the engine's device: on ``cuda`` the
hand-written kernels of ``csrc/`` (scan_window, occ_round, index_merge,
thomas_merge), on ``cpu`` their plain PyTorch versions.  Phase times
synchronise the device before the host clock is read.  ``run_epoch``'s
``ingest`` hook runs on the host while the card works through the
partitioned phase's enqueued launches (no thread; the engine uses one
stream, and the read tier's executor, which the service runs in the
hook, one of its own).  ``read_views()`` and ``committed_state()`` hand
out the committed snapshot buffers, which the next fence overwrites.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.baselines.cost_model import Network
from repro_torch.changelog.log import ChangeLog
from repro_torch.core import replication as repl
from repro_torch.core.fault import ClusterConfig, make_recovery_plan
from repro_torch.core.partitioned import run_partitioned
from repro_torch.core.phase_switch import PhaseController
from repro_torch.core.single_master import run_single_master
from repro_torch.obs import trace as obs
from repro_torch.storage.engine import StorageEngine
from repro_torch.storage.index import IndexSpec


@dataclass
class EngineStats:
    epochs: int = 0
    committed_single: int = 0
    committed_cross: int = 0
    user_aborts: int = 0
    consume_skips: int = 0          # Delivery districts skipped (stale scan)
    index_overflow: int = 0         # live index keys dropped at capacity
    retries: int = 0
    fences: int = 0
    value_bytes: int = 0
    op_bytes_hybrid: int = 0
    value_bytes_if_not_hybrid: int = 0
    index_op_bytes: int = 0         # index-maintenance ops on the op stream
    op_bytes_overlapped: int = 0    # shipped DURING the partitioned phase
    op_bytes_fence: int = 0         # the unshipped tail the fence waits on
    slabs_shipped: int = 0          # stream slabs applied to replicas
    slabs_discarded: int = 0        # in-flight slabs dropped by a revert
    ledger_dropped: int = 0         # slab-ledger entries aged out at the cap
    part_time_s: float = 0.0
    sm_time_s: float = 0.0
    sm_rounds: int = 0              # OCC rounds executed
    fence_time_s: float = 0.0
    fence_net_s: float = 0.0


class _ReplicaReplay:
    """ChangeLog subscriber keeping the operation replica consistent: the
    ordered partitioned stream replays per slab (``replay_partitioned``),
    the single-master stream merges under the Thomas write rule
    (``thomas_apply_batch``, the thomas_merge kernel) with its
    round-ordered index ops (``replay_index_rounds``)."""

    def __init__(self, eng):
        self.eng = eng

    def on_slab(self, log, info):
        eng = self.eng
        rs = eng.replica_store
        rs.val, rs.tid, ri = repl.replay_partitioned(
            rs.val, rs.tid, log, rs.indexes if eng.has_index else None)
        if eng.has_index:
            rs.indexes = ri

    def on_master(self, stream):
        eng = self.eng
        rs = eng.replica_store
        log = stream["log"]
        P, R, C = eng.P, eng.R, eng.C
        rv, rt = repl.thomas_apply_batch(rs.val.reshape(P * R, C),
                                         rs.tid.reshape(P * R), log)
        rs.val, rs.tid = rv.reshape(P, R, C), rt.reshape(P, R)
        if eng.has_index:
            rs.indexes = repl.replay_index_rounds(
                rs.indexes, stream["kinds"], stream["delta"], log["iwrite"],
                log["tid"])

    def on_reset(self, val, tid, epoch):
        self.eng.replica_store.load_state(self.eng.store.snapshot)


class StarEngine:
    """The single-host STAR engine: operation stream from the partitioned
    phase, value stream from the single-master phase."""

    def __init__(self, n_partitions: int, rows_per_partition: int,
                 n_cols: int = 10, init_val=None, hybrid_replication=True,
                 max_rounds=16, cluster: ClusterConfig | None = None,
                 iteration_ms: float = 10.0,
                 indexes: list[IndexSpec] | None = None,
                 net: Network | None = None, adaptive_epoch: bool = False,
                 strict_index: bool = False, durability=None,
                 n_slabs: int = 4, device=None):
        """device: ``None``/``"cuda"`` (the hand-written kernels; raises
        without a card) or ``"cpu"`` (their plain versions).
        hybrid_replication: False charges the fence with the value bytes
        the partitioned phase would ship without operation replication
        (byte accounting only: the replica receives the same streams).
        strict_index: raise instead of counting when an ordered-index
        segment overflows its capacity.
        durability: optional ``db.wal.Durability`` — committed epochs
        append their value streams, and with indexes their ordered
        index-op streams, to per-worker write-ahead logs flushed inside the
        commit fence, with checkpoints on a cadence; ``db.wal.recover_full``
        rebuilds the committed state from disk (§4.5.1).
        n_slabs: the §5 op-stream overlap model — the partitioned stream
        ships in ``n_slabs`` chunks, the first ``n_slabs - 1`` overlapped
        with execution, only the tail exposed at the fence."""
        P, R, C = n_partitions, rows_per_partition, n_cols
        self.P, self.R, self.C = P, R, C
        self.store = StorageEngine(P, R, C, init_val=init_val,
                                   index_specs=indexes, device=device)
        self.device = self.store.device
        self.replica_store = StorageEngine(P, R, C, init_val=init_val,
                                           index_specs=indexes,
                                           device=self.device)
        self.strict_index = strict_index
        self.has_index = bool(indexes)
        self.epoch = 1
        self.committed_epoch = 0
        self.part_seq = torch.zeros(P, dtype=torch.int64, device=self.device)
        self.hybrid = hybrid_replication
        self.max_rounds = max_rounds
        self.cluster = cluster or ClusterConfig(f=1, k=max(P, 1),
                                                n_partitions=P)
        self.controller = PhaseController(e_ms=iteration_ms,
                                          adaptive=adaptive_epoch)
        self.net = net or Network()
        assert n_slabs >= 1, n_slabs
        self.n_slabs = n_slabs
        self.durability = durability
        self.stats = EngineStats()
        # the one ordered op stream: the engine publishes, the operation
        # replica subscribes first (stream order), then the WAL sink
        self.changelog = ChangeLog(n_slabs)
        self.changelog.subscribe(_ReplicaReplay(self))
        if durability is not None:
            from repro_torch.db.wal import WalSink
            durability.attach(self.store.val, self.store.tid,
                              indexes=self.store.indexes
                              if self.has_index else None)
            snap = self.store.snapshot
            self.changelog.subscribe(WalSink(
                durability, R, C, np.arange(P) % durability.n_workers,
                lambda: (snap["val"], snap["tid"],
                         snap["indexes"] if self.has_index else None)))

    # -- dict views kept for callers/tests that read engine state --------
    @property
    def master(self):
        return {"val": self.store.val, "tid": self.store.tid}

    @property
    def replica(self):
        return {"val": self.replica_store.val, "tid": self.replica_store.tid}

    @property
    def snapshot(self):
        return {"val": self.store.snapshot["val"],
                "tid": self.store.snapshot["tid"]}

    # ------------------------------------------------------------------
    @staticmethod
    def _pad_axis(tree, axis: int):
        """Pad a numpy txn dict to the next power of two along `axis`, as
        the reference does (its results depend on the padded shapes)."""
        def pad(a):
            n = a.shape[axis]
            target = 1 << max(0, (n - 1).bit_length())
            if target == n:
                return a
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, target - n)
            return np.pad(a, widths)
        if isinstance(tree, dict):
            return {k: pad(np.asarray(v)) for k, v in tree.items()}
        return pad(np.asarray(tree))

    def _to_device(self, tree):
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   device=self.device)
                for k, v in tree.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_epoch(self, batch, ingest=None) -> dict:
        """batch: output of ycsb/tpcc make_batch (or the service's
        batcher).  Runs partitioned phase, fence, single-master phase,
        fence.  Returns epoch metrics.

        ingest: optional zero-arg callable run after the partitioned
        phase's launches are enqueued and before the host waits for them —
        the service forms the next epoch's batch here while the card
        executes.  Its host time is reported as ``t_ingest_s``."""
        tr = obs.get_tracer()
        t_ep0 = time.perf_counter()
        ptxn = self._to_device(self._pad_axis(batch["ptxn"], 1))
        cross = self._to_device(self._pad_axis(batch["cross"], 0))
        index = self.store.indexes if self.has_index else None

        # ---- partitioned phase (single-partition txns, no CC) ----------
        t0 = time.perf_counter()
        val, tidw, part_out, pstats = run_partitioned(
            self.store.val, self.store.tid, ptxn, self.epoch, self.part_seq,
            index)
        t_ingest = 0.0
        if ingest is not None:       # host ingest while the card executes
            ti = time.perf_counter()
            ingest()
            t_ingest = time.perf_counter() - ti
            tr.complete("service.ingest_overlap", "service", ti,
                        ti + t_ingest, epoch=self.epoch)
        tb = time.perf_counter()
        self._sync()
        t1 = time.perf_counter()
        tr.complete("engine.partitioned", "phase", t0, t1, epoch=self.epoch)
        # device-attributable time: when host ingest outlasts the card the
        # wall clock measures ingest, not the phase
        t_part = max(t1 - t0 - t_ingest, t1 - tb)
        self.store.val, self.store.tid = val, tidw
        if self.has_index:
            self.store.indexes = part_out["index"]

        # operation replication: publish the epoch's ordered stream
        self.changelog.publish_slab(part_out["log"], self.epoch)

        # ---- replication byte accounting, partitioned stream (Fig. 15) --
        vb = 0
        attr = self.changelog.attribute(batch, part_out["log"],
                                        self.has_index,
                                        lambda a: self._pad_axis(a, 1))
        vb_alt, slab_bytes, ib = attr.value_bytes_alt, attr.slab_bytes, \
            attr.index_op_bytes
        ob = attr.total

        # ---- fence 1: all streams applied, snapshot commit --------------
        t0 = time.perf_counter()
        ob_head, ob_tail = attr.overlapped, attr.fence
        if self.hybrid:
            t_net1 = self._fence(ob_tail, overlapped_bytes=ob_head,
                                 t_exec_s=t_part)
        else:
            t_net1 = self._fence(vb_alt)
        t_fence1 = time.perf_counter()
        t_f1 = t_fence1 - t0
        tr.complete("engine.fence", "fence", t0, t_fence1, which=1,
                    epoch=self.epoch, tail_bytes=ob_tail if self.hybrid
                    else vb_alt, overlapped_bytes=ob_head)

        # ---- single-master phase (cross-partition txns, Silo OCC) ------
        t0 = time.perf_counter()
        P, R, C = self.P, self.R, self.C
        B = int(cross["row"].shape[0])
        if B > 0:
            fval, ftid, sm_out, sstats = run_single_master(
                self.store.val.reshape(P * R, C),
                self.store.tid.reshape(P * R), cross, self.epoch,
                max_rounds=self.max_rounds,
                index=self.store.indexes if self.has_index else None)
            self._sync()
            self.store.val = fval.reshape(P, R, C)
            self.store.tid = ftid.reshape(P, R)
            if self.has_index:
                self.store.indexes = sm_out["index"]
            self.changelog.publish_master(
                sm_out["log"],
                kinds=cross["kind"] if self.has_index else None,
                delta=cross["delta"] if self.has_index else None)
        else:
            sstats = {"committed": 0, "retries": 0, "user_aborts": 0,
                      "starved": 0, "writes": 0}
        t_sm = time.perf_counter() - t0
        t_sm_round = t_sm / self.max_rounds if B > 0 else 0.0
        tr.complete("engine.single_master", "phase", t0, t0 + t_sm,
                    epoch=self.epoch, rounds=self.max_rounds if B else 0)

        # ---- byte accounting, single-master value stream ----------------
        ib_sm = 0
        if B > 0:
            cw = sm_out["log"]["write"].cpu().numpy()          # (rounds,B,M)
            if "c_row_bytes" in batch:
                crb = np.broadcast_to(self._pad_axis(batch["c_row_bytes"], 0),
                                      cw.shape[1:])
                vb = repl.value_bytes(cw, crb[None])
            elif batch.get("row_bytes") is not None:
                vb = repl.value_bytes(cw, batch["row_bytes"][None, None, :])
            if self.has_index and (vb or ob):
                ib_sm = repl.index_op_bytes(sm_out["log"]["iwrite"])

        # ---- fence 2: epoch boundary ------------------------------------
        t0 = time.perf_counter()
        t_net2 = self._fence(vb + ib_sm, commit_epoch=self.epoch)
        self.epoch += 1
        t_fence2 = time.perf_counter()
        t_f2 = t_fence2 - t0
        tr.complete("engine.fence", "fence", t0, t_fence2, which=2,
                    epoch=self.epoch - 1, commit=True,
                    value_bytes=vb + ib_sm)

        # ---- controller telemetry ---------------------------------------
        nc = int(sstats["committed"])
        ns = int(pstats["committed"])
        self.controller.observe("partitioned", ns, t_part)
        self.controller.observe("single", nc, t_sm,
                                frac_cross=nc / max(nc + ns, 1))
        tau_p, tau_s = self.controller.plan()

        s = self.stats
        s.epochs += 1
        s.committed_single += ns
        s.committed_cross += nc
        s.user_aborts += int(pstats["user_aborts"]) + int(sstats["user_aborts"])
        s.consume_skips += int(pstats.get("consume_skips", 0)) \
            + int(sstats.get("consume_skips", 0))
        overflow = int(pstats.get("index_overflow", 0)) \
            + int(sstats.get("index_overflow", 0))
        s.index_overflow += overflow
        if self.strict_index and overflow:
            raise RuntimeError(
                f"ordered-index segment overflow: {overflow} live keys "
                f"dropped this epoch (IndexSpec capacity too small)")
        s.retries += int(sstats["retries"])
        s.part_time_s += t_part
        s.sm_time_s += t_sm
        s.sm_rounds += self.max_rounds if B > 0 else 0
        s.fence_time_s += t_f1 + t_f2
        s.value_bytes += vb
        s.op_bytes_hybrid += ob if self.hybrid else vb_alt
        s.value_bytes_if_not_hybrid += vb_alt
        s.index_op_bytes += ib + ib_sm
        if self.hybrid:
            s.op_bytes_overlapped += ob_head
            s.op_bytes_fence += ob_tail
            s.slabs_shipped += len(slab_bytes)
        p_committed = part_out["committed"].cpu().numpy()        # (P, T_pad)
        c_committed = (sm_out["committed"].cpu().numpy() if B > 0
                       else np.zeros(B, bool))                   # (B_pad,)
        m = {"committed_single": ns, "committed_cross": nc,
             "tau_p_ms": tau_p, "tau_s_ms": tau_s,
             "t_part_s": t_part, "t_sm_s": t_sm,
             "t_sm_round_s": t_sm_round,
             "t_ingest_s": t_ingest,
             "t_fence1_s": t_fence1, "t_fence2_s": t_fence2,
             "t_fence_net_s": t_net1 + t_net2,
             "op_bytes_overlapped": ob_head if self.hybrid else 0,
             "op_bytes_fence": ob_tail if self.hybrid else vb_alt,
             "p_committed": p_committed, "c_committed": c_committed,
             "index_overflow": overflow,
             "starved": int(sstats["starved"])}
        if self.has_index:
            m["p_cskip"] = part_out["log"]["cskip"].cpu().numpy()  # (P,T,K)
            m["c_cskip"] = (sm_out["log"]["cskip"].any(0).cpu().numpy()
                            if B > 0 else None)                   # (B_pad,K)
        tr.complete("engine.epoch", "epoch", t_ep0, time.perf_counter(),
                    epoch=self.epoch - 1, committed=ns + nc)
        return m

    # ------------------------------------------------------------------
    def _fence(self, stream_bytes: int = 0, commit_epoch=None,
               overlapped_bytes: int = 0, t_exec_s: float = 0.0) -> float:
        """Replication fence: the streams were applied synchronously above,
        so the fence is the snapshot promotion of both stores + epoch
        bookkeeping; the inter-node cost is modeled through the Network
        envelope and returned (``t_fence_net_s``), not slept.  The device is
        synchronised before the fence returns, so the fence's time covers
        the streams' device work and the snapshot copies, not their
        enqueue.  ``commit_epoch`` (fence 2 only) retires the epoch through
        the changelog: the WAL sink appends the committed streams and
        fsyncs every worker's log inside the fence."""
        self.store.snapshot_commit()
        self.replica_store.snapshot_commit()
        self._sync()
        self.stats.fences += 1
        if commit_epoch is not None:
            self.committed_epoch = int(commit_epoch)
            _shipped, dropped = self.changelog.commit(commit_epoch)
            self.stats.ledger_dropped += dropped
        t_net = repl.fence_net_seconds(self.net, stream_bytes,
                                       overlapped_bytes, t_exec_s)
        self.stats.fence_net_s += t_net
        return t_net

    def committed_state(self):
        """The committed full-replica arrays — what a new changelog
        subscriber seeds its projection from.  These are the snapshot
        buffers themselves, which the next fence overwrites: a subscriber
        copies what it keeps."""
        sn = self.store.snapshot
        return sn["val"], sn["tid"]

    def replica_consistent(self) -> bool:
        return self.store.equals(self.replica_store)

    def read_views(self):
        """Committed snapshot views for the read tier's SnapshotCatalog:
        the master copy plus the (single-host) operation replica, both
        covering every partition with the identity row mapping — two
        independently load-balanceable serving copies.  Views reference
        the committed snapshot buffers, never the working arrays; the
        next fence overwrites those buffers in place, so the catalog
        copies what it retains (``SnapshotCatalog.stamp``)."""
        wm = self.changelog.watermark(self.committed_epoch)
        P = self.P
        cover = np.ones(P, bool)
        rop = np.arange(P, dtype=np.int64)
        views = []
        for rid, kind, store in (("full", "full", self.store),
                                 ("replica", "secondary",
                                  self.replica_store)):
            sn = store.snapshot
            views.append({"id": rid, "kind": kind, "node": 0,
                          "epoch": self.committed_epoch, "watermark": wm,
                          "cover": cover, "row_of_partition": rop,
                          "val": sn["val"], "tid": sn["tid"],
                          "idx": sn["indexes"] if self.has_index else []})
        return views

    # ------------------------------------------------------------------
    # fault tolerance (§4.5)
    # ------------------------------------------------------------------
    def inject_failure(self, failed: set[int], dirty: bool = True):
        """Simulate node failures mid-epoch: optionally scribble uncommitted
        writes into the working version, then run detection + revert."""
        if dirty:
            self.store.val[:, 0, 0] += 12345
            self.store.tid[:, 0] = (self.store.tid[:, 0] + 2) & 0xFFFFFFFF
        plan = make_recovery_plan(self.cluster, failed, self.epoch - 1)
        # revert to the last committed epoch (two-version records, §4.5.2 —
        # indexes roll back with the records they point at)
        self.store.revert_to_snapshot()
        self.replica_store.load_state(self.store.snapshot)
        self.stats.slabs_discarded += self.changelog.revert(self.epoch)
        return plan

    def recover_node(self, plan):
        """Case-1 recovery: resync the replica from the committed
        snapshot."""
        self.replica_store.load_state(self.store.snapshot)
        return True
