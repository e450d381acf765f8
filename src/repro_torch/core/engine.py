"""STAR engine: phase-switched epochs over the storage subsystem (§3-§5),
port of ``repro.core.engine`` (the WAL durability hook waits for the WAL
port).

One engine instance models the cluster: the master view plus an operation
replica kept consistent purely through the replication streams — ordered
operation replication from the partitioned phase and Thomas-rule value
replication from the single-master phase, both published once on the
``ChangeLog`` and applied by the replica subscriber.  ``replica_consistent``
checks bit-equality of records and indexes.

Every kernel of the epoch runs on the engine's device: on ``cuda`` the
hand-written kernels of ``csrc/`` (scan_window, occ_round, index_merge,
thomas_merge), on ``cpu`` their plain PyTorch versions.  Phase times
synchronise the device before the host clock is read.
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

# §5 op-stream slabs an epoch's partitioned stream ships in (the first
# N_SLABS-1 overlap execution; the fence waits on the tail)
N_SLABS = 4


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
    """The single-host STAR engine with hybrid replication (operation
    stream from the partitioned phase, value stream from the single-master
    phase) — the reference's default configuration."""

    def __init__(self, n_partitions: int, rows_per_partition: int,
                 n_cols: int = 10, init_val=None, max_rounds=16,
                 indexes: list[IndexSpec] | None = None,
                 strict_index: bool = False, device=None):
        """device: ``None``/``"cuda"`` (the hand-written kernels; raises
        without a card) or ``"cpu"`` (their plain versions).
        strict_index: raise instead of counting when an ordered-index
        segment overflows its capacity."""
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
        self.max_rounds = max_rounds
        self.cluster = ClusterConfig(f=1, k=max(P, 1), n_partitions=P)
        self.controller = PhaseController()
        self.net = Network()
        self.stats = EngineStats()
        # the one ordered op stream: the engine publishes, the operation
        # replica subscribes
        self.changelog = ChangeLog(N_SLABS)
        self.changelog.subscribe(_ReplicaReplay(self))

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

    def run_epoch(self, batch) -> dict:
        """batch: output of tpcc make_batch.  Runs partitioned phase, fence,
        single-master phase, fence.  Returns epoch metrics."""
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
        self._sync()
        t1 = time.perf_counter()
        tr.complete("engine.partitioned", "phase", t0, t1, epoch=self.epoch)
        t_part = t1 - t0
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
        t_net1 = self._fence(ob_tail, overlapped_bytes=ob_head,
                             t_exec_s=t_part)
        t_fence1 = time.perf_counter()
        t_f1 = t_fence1 - t0
        tr.complete("engine.fence", "fence", t0, t_fence1, which=1,
                    epoch=self.epoch, tail_bytes=ob_tail,
                    overlapped_bytes=ob_head)

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
        s.op_bytes_hybrid += ob
        s.value_bytes_if_not_hybrid += vb_alt
        s.index_op_bytes += ib + ib_sm
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
             "t_fence1_s": t_f1, "t_fence2_s": t_f2,
             "t_fence_net_s": t_net1 + t_net2,
             "op_bytes_overlapped": ob_head, "op_bytes_fence": ob_tail,
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
        enqueue."""
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

    def replica_consistent(self) -> bool:
        return self.store.equals(self.replica_store)

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
