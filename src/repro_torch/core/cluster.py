"""Distributed STAR engine over simulated nodes on one card, port of
``repro.core.cluster``.

The single-host :class:`repro_torch.core.engine.StarEngine` models the
cluster as one master view plus one replica; this module is the *cluster*
form, each paper "node" a block of the partition axis:

* database partitions split over ``n_nodes`` nodes — node n holds the
  contiguous block ``node_slice(n)`` of ``ppn = P / n_nodes`` primary
  partitions of the partial copy, plus (``secondary=True``) a PHYSICAL
  secondary copy of the previous node's block in home-major layout — the
  partial replica set is real state, not a modeling convention;
* **partitioned phase**: one ``run_partitioned`` call over all P
  partitions where the reference runs one per node block (its partitions
  are a batch axis: each node's result is the same either way, and the
  path is host-bound, so one launch serves every node).  The phase
  executes in ``n_slabs`` chunks of queue slots and the committed op
  stream of each chunk ships to the full replica (and the secondary
  homes) while the next chunk executes — the §5 in-phase op-stream
  overlap — so the replication fence waits only on the unshipped tail
  slab;
* **replication fence**: the sum of the per-node commit counters — the
  §4.3 statistics exchange — reached with every slab but the tail
  already applied;
* **single-master phase**: the designated master executes
  cross-partition transactions on its full copy (no 2PC — the paper's
  core claim), then the write stream is scattered back to the partition
  owners AND the secondary homes with the Thomas write rule (one
  ``thomas_merge`` launch a copy: each row lies in exactly one node
  block, so one merge over the whole copy equals one per node); index
  maintenance replays round-ordered on every partial copy.

All copies live on the engine's one device and run on one stream; the ship
to the master's device is a no-op there.  The full replica, the partial
copy and the secondary copy are three sets of tensors, and the committed
two-version snapshot a fourth that owns its memory: the port's kernels
update tensors in place (``thomas_merge``), so ``snapshot_commit`` copies
the working state into the snapshot buffers and every restore copies out
of them — nothing working ever aliases the snapshot.

Beyond the execution, the engine carries what the cluster runtime
(``repro_torch.cluster``) needs for §4.5 fault tolerance: two-version
snapshots at the epoch fence (revert on failure — which also discards the
in-flight epoch's consumed stream slabs, tracked by a slab high-watermark
so a re-executed epoch applies each slab exactly once), node-granular
memory loss + donor-copy restore, surviving-secondary block restore,
full-replica rebuild from the partial set, and per-node commit /
fence-wait telemetry.  Its ``run_epoch`` returns the same metric surface
as ``StarEngine.run_epoch``, so ``service.TxnService`` drives either
engine unchanged.

:class:`DistClusterStarEngine` is the same cluster with one process a
node over a ``torch.distributed`` process group (the reference's one
device a node): each rank holds its own blocks, the slab ships and the
scatter-back cross the group, the read tier's groups for a secondary
copy run on the rank that holds it, and it is bit-equal to
:class:`ClusterStarEngine` fed the same batches.
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch

from repro_torch.baselines.cost_model import Network
from repro_torch.changelog.log import ChangeLog
from repro_torch.core import replication as repl
from repro_torch.core.engine import EngineStats, StarEngine
from repro_torch.core.ops import IX_KEY
from repro_torch.core.partitioned import run_partitioned
from repro_torch.core.phase_switch import PhaseController
from repro_torch.core.single_master import run_single_master
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs
from repro_torch.storage.index import IndexSpec, key_partition, make_index

FIELDS = ("key", "prow", "tid")
# what a dead node's memory reads as after ``scribble_node``: the
# reference's junk words (uint32 0xDEAD for TID words, int32 -0x5A5A5A5
# for values, keys and payloads), as numbers
JUNK_TID = 0xDEAD
JUNK_WORD = -0x5A5A5A5


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _clone(tree):
    return _tree_map(lambda a: a.clone(), tree)


def _copy_into(dst, src):
    _tree_map(lambda d, s: d.copy_(s), dst, src)


def _scribble(tree, sl):
    def scrib(a):
        a[sl] = JUNK_TID if a.dtype == torch.int64 else JUNK_WORD
    _tree_map(scrib, tree)


def _equal(a, b) -> bool:
    eq = []
    _tree_map(lambda x, y: eq.append(torch.equal(x, y)), a, b)
    return all(eq)


class _ReplicaShip:
    """ChangeLog subscriber doing the physical replica shipping: each
    published slab replays in order on the full replica, then — rolled
    home-major — onto the physical secondary homes; the single-master
    stream scatters back to the partition owners and secondary homes
    under the Thomas write rule, index rounds replaying on every partial
    copy.  Fires while the NEXT slab executes, so the fence only ever
    waits on the tail."""

    def __init__(self, eng):
        self.eng = eng

    def on_slab(self, log, info):
        eng = self.eng
        with obs.span("replica.replay_full", cat="replay",
                      epoch=info["epoch"], slab=info["slab"]):
            eng.full_val, eng.full_tid, fidx = repl.replay_partitioned(
                eng.full_val, eng.full_tid, log,
                eng.full_idx if eng.has_index else None)
            if eng.has_index:
                eng.full_idx = fidx
        if eng.secondary:
            with obs.span("replica.replay_secondary", cat="replay",
                          epoch=info["epoch"], slab=info["slab"]):
                # the roll IS the ship: each block's ordered stream moves
                # to its secondary home
                eng.sec_val, eng.sec_tid, sidx = repl.replay_partitioned(
                    eng.sec_val, eng.sec_tid, eng._roll_home(log),
                    eng.sec_idx if eng.has_index else None,
                    part_ids=eng._part_ids_sec)
                if eng.has_index:
                    eng.sec_idx = sidx

    def on_master(self, stream):
        eng = self.eng
        P, R, C = eng.P, eng.R, eng.C
        with obs.span("replica.scatter_back", cat="replay"):
            slog = stream["log"]
            # the executor writes row -1 where a write did not commit, so
            # the log's flattened views are the stream (global rows)
            repl.thomas_apply_batch(eng.part_val.view(P * R, C),
                                    eng.part_tid.view(P * R), slog)
            if eng.secondary:
                rows = slog["row"].reshape(-1)
                srows = torch.where(
                    rows >= 0,
                    torch.remainder(rows // R + eng.ppn, P) * R + rows % R,
                    -1).to(rows.dtype)
                repl.thomas_apply(eng.sec_val.view(P * R, C),
                                  eng.sec_tid.view(P * R), srows,
                                  slog["val"].reshape(-1, C),
                                  slog["tid"].reshape(-1))
            if eng.has_index:
                kinds, delta = stream["kinds"], stream["delta"]
                eng.part_idx = repl.replay_index_rounds(
                    eng.part_idx, kinds, delta, slog["iwrite"], slog["tid"])
                if eng.secondary:
                    eng.sec_idx = repl.replay_index_rounds(
                        eng.sec_idx, kinds, delta, slog["iwrite"],
                        slog["tid"], part_ids=eng._part_ids_sec)


class ClusterStarEngine:
    """f full replicas (the designated master's complete copies) + the
    node-sharded partial replicas: each node's contiguous ``ppn``-partition
    primary block plus the physical secondary copy of its predecessor's
    block (round-robin homes, matching ``ClusterConfig.partition_homes``)."""

    LEDGER_CAP = 4096              # committed-slab telemetry window

    def _roll_home(self, tree):
        """The ONE encoding of the home-major secondary layout: array
        row p holds partition (p - ppn) mod P, i.e. node m hosts node
        m-1's block (ClusterConfig.partition_homes round-robin).  Every
        site that materializes, ships to, resyncs, reloads, or checks the
        secondary copies goes through this shift."""
        return _tree_map(lambda a: torch.roll(a, self.ppn, dims=0), tree)

    def __init__(self, n_nodes: int, n_partitions: int,
                 rows_per_partition: int, n_cols: int = 10, init_val=None,
                 max_rounds: int = 16, iteration_ms: float = 10.0,
                 adaptive_epoch: bool = False,
                 indexes: list[IndexSpec] | None = None,
                 net: Network | None = None, n_slabs: int = 4,
                 secondary: bool | None = None, device=None):
        """n_nodes: the simulated nodes (the reference's mesh size).
        device: ``None``/``"cuda"`` (the hand-written kernels; raises
        without a card) or ``"cpu"`` (their plain versions)."""
        self.device = resolve_device(device)
        self.n_nodes = int(n_nodes)
        assert n_partitions % self.n_nodes == 0, \
            (n_partitions, self.n_nodes)
        self.ppn = n_partitions // self.n_nodes
        self.P, self.R, self.C = n_partitions, rows_per_partition, n_cols
        self.index_specs = list(indexes or [])
        self.has_index = bool(self.index_specs)
        self.net = net or Network()
        assert n_slabs >= 1, n_slabs
        self.n_slabs = n_slabs
        # physical secondary partial replicas need a second distinct home
        self.secondary = (self.n_nodes > 1 if secondary is None
                          else (secondary and self.n_nodes > 1))
        dev = self.device
        val = (torch.tensor(np.asarray(init_val, np.int32), device=dev)
               if init_val is not None else
               torch.zeros((self.P, self.R, self.C), dtype=torch.int32,
                           device=dev))
        tid = torch.zeros((self.P, self.R), dtype=torch.int64, device=dev)
        idx0 = [make_index(s, self.P, dev) for s in self.index_specs]
        # partial replicas (primary blocks), the master's full copy, and
        # the physical secondary copies, home-major: array row p holds
        # partition (p - ppn) mod P, so node m's block holds the SECONDARY
        # copy of node (m-1)'s partitions
        self.part_val, self.part_tid = val.clone(), tid.clone()
        self.part_idx = _clone(idx0)
        self.full_val, self.full_tid = val.clone(), tid.clone()
        self.full_idx = _clone(idx0)
        if self.secondary:
            self.sec_val = self._roll_home(val)
            self.sec_tid = self._roll_home(tid)
            self.sec_idx = self._roll_home(idx0)
        else:
            self.sec_val = self.sec_tid = None
            self.sec_idx = []
        self._part_ids_sec = torch.remainder(
            torch.arange(self.P, dtype=torch.int32, device=dev) - self.ppn,
            self.P).to(torch.int32)
        self._seq0 = torch.zeros(self.P, dtype=torch.int64, device=dev)
        self.epoch = 1
        self.max_rounds = max_rounds
        self.controller = PhaseController(e_ms=iteration_ms,
                                          adaptive=adaptive_epoch)
        self.stats = EngineStats()
        # per-node telemetry (fig12/fig13 skew): committed txns and modeled
        # fence wait (the slowest node sets the fence; everyone else waits)
        self.node_committed = np.zeros(self.n_nodes, np.int64)
        self.node_fence_wait_s = np.zeros(self.n_nodes)
        # the one ordered op stream: the engine PUBLISHES (slabs, master
        # stream, commit/revert) and every consumer subscribes — the
        # physical replica shipper first (stream order), then any sink
        # (WAL, materialized views) the runtime/service registers.  The
        # changelog owns the slab high-watermark and the committed ledger
        self.changelog = ChangeLog(n_slabs, ledger_cap=self.LEDGER_CAP)
        self.changelog.subscribe(_ReplicaShip(self))
        # read-tier watermark: the fence epoch the committed snapshot
        # (``_snap``) corresponds to — 0 until the first commit
        self.committed_epoch = 0
        # the committed two-version snapshot: buffers of its own
        self._snap = _clone(self._state())

    # ------------------------------------------------------------------
    @property
    def _slab_hwm(self) -> int:
        """In-flight slabs the subscribers already consumed (changelog
        high-watermark; kept as a property for the runtime/tests)."""
        return self.changelog.slab_hwm

    @property
    def slab_ledger(self) -> list:
        """Committed (epoch, slab) ledger — owned by the changelog."""
        return self.changelog.ledger

    def committed_state(self):
        """(val, tid) of the committed full-replica snapshot — the seed
        state changelog subscribers (MVs, analytics) reset from.  These are
        the snapshot buffers, which the next fence overwrites: a
        subscriber copies what it keeps."""
        return self._snap["full_val"], self._snap["full_tid"]

    def _slab_bounds(self, T: int):
        return self.changelog.slab_bounds(T)

    # the single-host engine's device helpers (they read only .device)
    _sync = StarEngine._sync
    _to_device = StarEngine._to_device

    # ------------------------------------------------------------------
    def run_epoch(self, batch, ingest=None, commit=True,
                  abort_check=None) -> dict:
        """StarEngine-compatible epoch: slab-streamed partitioned phase
        (each slab's op stream ships to the replicas while the next slab
        executes), the commit-statistics fence waiting only on the tail
        slab, single-master phase on the full copy, value + index-stream
        scatter-back, epoch fence + two-version snapshot.

        ingest: optional zero-arg callable run on the host while the card
        works through the partitioned phase's enqueued launches.
        commit=False runs the phases up TO the epoch fence but never
        commits — the cluster runtime uses it for an epoch whose fence a
        failed node will miss: everything the phases wrote (including the
        stream slabs the replicas already consumed, via the slab
        high-watermark) is discarded by the §4.5 revert.
        abort_check: optional callable(slab_idx) -> bool polled after each
        slab's execution dispatch; returning True at slab s kills the
        epoch mid-stream (a node died during the phase) with slabs
        0..s-1 already shipped: remaining slabs never execute or ship."""
        tr = obs.get_tracer()
        t_ep0 = time.perf_counter()
        pad = StarEngine._pad_axis
        ptxn = self._to_device(pad(batch["ptxn"], 1))
        cross = self._to_device(pad(batch["cross"], 0))

        # ---- partitioned phase: slab-chained execution + streaming ------
        T = ptxn["row"].shape[1]
        bounds = self._slab_bounds(T)
        S = len(bounds) - 1
        t0 = time.perf_counter()
        pv, pt, seq = self.part_val, self.part_tid, self._seq0
        pidx = self.part_idx if self.has_index else None
        slab_logs, committed_chunks = [], []
        extras = None
        aborted_at = None
        for s in range(S):
            slab = {k: v[:, bounds[s]:bounds[s + 1]] for k, v in ptxn.items()}
            with tr.span("cluster.slab_execute", cat="phase",
                         epoch=self.epoch, slab=s,
                         txns=bounds[s + 1] - bounds[s]):
                pv, pt, out, st = run_partitioned(
                    pv, pt, slab, self.epoch, seq0=seq, index=pidx)
            seq = out["seq"]
            if self.has_index:
                pidx = out["index"]
            if s > 0:
                # previous slab's stream ships while THIS slab executes
                self.changelog.publish_slab(slab_logs[s - 1], self.epoch)
            slab_logs.append(out["log"])
            committed_chunks.append(out["committed"])
            x = torch.stack([st["consume_skips"], st["index_overflow"],
                             st["user_aborts"]])
            extras = x if extras is None else extras + x
            if abort_check is not None and abort_check(s):
                aborted_at = s
                break
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
        t_part = max(t1 - t0 - t_ingest, t1 - tb)
        tr.complete("engine.partitioned", "phase", t0, t1,
                    epoch=self.epoch, slabs=S)
        self.part_val, self.part_tid = pv, pt
        if self.has_index:
            self.part_idx = pidx

        if aborted_at is not None:
            # mid-stream death: the epoch can never commit; the caller
            # reverts, which discards the slabs already consumed
            return {"aborted_at_slab": aborted_at,
                    "slabs_executed": aborted_at + 1,
                    "slabs_consumed": self._slab_hwm}

        # ---- tail ship: the ONLY stream transfer the fence waits on -----
        with tr.span("fence.tail_ship", cat="fence", epoch=self.epoch,
                     slab=S - 1):
            self.changelog.publish_slab(slab_logs[-1], self.epoch)
        plog = self.changelog.epoch_plog()
        p_committed = (committed_chunks[0] if S == 1 else
                       torch.cat(committed_chunks, dim=1))

        # ---- stream byte attribution (the changelog's single source) ----
        vb = 0
        attr = self.changelog.attribute(batch, plog, self.has_index,
                                        lambda a: pad(a, 1))
        vb_alt, ib = attr.value_bytes_alt, attr.index_op_bytes
        ob = attr.total
        ob_head, ob_tail = attr.overlapped, attr.fence

        # ---- fence 1: the per-node commit counters, summed ---------------
        tf0 = time.perf_counter()
        node_counts = p_committed.sum(1).view(self.n_nodes, -1).sum(1)
        n_single = int(node_counts.sum())
        tr.complete("fence.psum", "fence", tf0, time.perf_counter(),
                    epoch=self.epoch, tail_bytes=ob_tail)
        # modeled network: the tail slab drains inside the fence; the head
        # slabs shipped during execution and surface only as un-hidden
        # residue
        t_net1 = repl.fence_net_seconds(self.net, ob_tail, ob_head, t_part)
        t_fence1 = time.perf_counter()

        # ---- single-master phase on the full copy ------------------------
        # B from the RAW batch: padding turns an empty cross batch into
        # invalid lanes, which would run the full OCC program for nothing
        t0 = time.perf_counter()
        B = int(batch["cross"]["row"].shape[0])
        slog = None
        ib_sm = 0
        P, R, C = self.P, self.R, self.C
        if B > 0:
            fv, ft, out, sstats = run_single_master(
                self.full_val.reshape(P * R, C), self.full_tid.reshape(P * R),
                cross, self.epoch, max_rounds=self.max_rounds,
                index=self.full_idx if self.has_index else None)
            self._sync()
            n_cross = int(sstats["committed"])
            self.full_val = fv.view(P, R, C)
            self.full_tid = ft.view(P, R)
            if self.has_index:
                self.full_idx = out["index"]
            # publish the master stream: the subscriber value-replicates
            # the writes back to partition owners and secondary homes and
            # replays the index-op rounds on every partial copy
            slog = out["log"]
            self.changelog.publish_master(slog, kinds=cross["kind"],
                                          delta=cross["delta"])
            if self.has_index:
                ib_sm = repl.index_op_bytes(slog["iwrite"])
            if "c_row_bytes" in batch:
                cw = slog["write"].cpu().numpy()
                crb = np.broadcast_to(pad(batch["c_row_bytes"], 0),
                                      cw.shape[1:])
                vb = int(repl.value_bytes(cw, crb[None]))
            elif batch.get("row_bytes") is not None:
                vb = int(repl.value_bytes(slog["write"],
                                          batch["row_bytes"][None, None, :]))
            c_committed = out["committed"].cpu().numpy()
            starved = int(sstats["starved"])
            retries = int(sstats["retries"])
            aborts = int(sstats["user_aborts"])
            sm_skips = int(sstats["consume_skips"])
            sm_overflow = int(sstats["index_overflow"])
        else:
            n_cross = starved = retries = aborts = 0
            sm_skips = sm_overflow = 0
            c_committed = np.zeros(0, bool)
        t_sm = time.perf_counter() - t0
        t_sm_round = t_sm / self.max_rounds if B > 0 else 0.0
        tr.complete("engine.single_master", "phase", t0, t0 + t_sm,
                    epoch=self.epoch, rounds=self.max_rounds if B else 0)
        if tr.enabled and B > 0:
            # the rounds' device work is not timed one by one; attribute
            # the measured phase time evenly (the same t_sm_round)
            for r in range(self.max_rounds):
                tr.complete("engine.sm_round", "phase",
                            t0 + r * t_sm_round, t0 + (r + 1) * t_sm_round,
                            epoch=self.epoch, round=r)

        # ---- fence 2: epoch boundary + two-version snapshot --------------
        # the fence's contract is "every outstanding stream applied": wait
        # for the tail replay and the value scatter-back HERE (their time
        # is fence time)
        tf2 = time.perf_counter()
        self._sync()
        tr.complete("fence.replay_drain", "fence", tf2,
                    time.perf_counter(), epoch=self.epoch)
        t_net2 = repl.fence_net_seconds(self.net, vb + ib_sm)
        p_committed = p_committed.cpu().numpy()                # (P, T)
        node_c = p_committed.sum(1).reshape(self.n_nodes, -1).sum(1)
        # modeled fence wait: the slowest node's phase time sets the fence;
        # a node's own busy time is proxied by its committed share
        cmax = int(node_c.max()) if node_c.size else 0
        wait = (t_part * (1.0 - node_c / cmax) if cmax > 0
                else np.zeros(self.n_nodes))
        tau_p = tau_s = 0.0
        n_skips, n_overflow, p_aborts = (int(x) for x in extras.cpu())
        n_skips += sm_skips
        n_overflow += sm_overflow
        # partitioned-phase user aborts count too (StarEngine parity)
        aborts += p_aborts
        if commit:
            self.snapshot_commit()
            self.epoch += 1
            self.node_committed += node_c
            self.node_fence_wait_s += wait
            self.controller.observe_fence_wait(float(wait.max()) * 1e3)
            self.controller.observe("partitioned", n_single, t_part)
            self.controller.observe("single", n_cross, t_sm,
                                    frac_cross=n_cross
                                    / max(n_cross + n_single, 1))
            tau_p, tau_s = self.controller.plan()
        t_fence2 = time.perf_counter()
        tr.complete("engine.fence", "fence", tf2, t_fence2, which=2,
                    epoch=self.epoch - (1 if commit else 0), commit=commit)
        if commit:
            s = self.stats
            s.epochs += 1
            s.committed_single += n_single
            s.committed_cross += n_cross
            s.user_aborts += aborts
            s.consume_skips += n_skips
            s.index_overflow += n_overflow
            s.retries += retries
            s.part_time_s += t_part
            s.sm_time_s += t_sm
            s.sm_rounds += self.max_rounds if B > 0 else 0
            s.fences += 2
            s.fence_time_s += (t_fence1 - tf0) + (t_fence2 - tf2)
            s.fence_net_s += t_net1 + t_net2
            s.value_bytes += vb
            s.op_bytes_hybrid += ob
            s.value_bytes_if_not_hybrid += vb_alt
            s.index_op_bytes += ib + ib_sm
            s.op_bytes_overlapped += ob_head
            s.op_bytes_fence += ob_tail

        m = {"committed_single": n_single, "committed_cross": n_cross,
             "tau_p_ms": tau_p, "tau_s_ms": tau_s,
             "t_part_s": t_part, "t_sm_s": t_sm,
             "t_sm_round_s": t_sm_round, "t_ingest_s": t_ingest,
             "t_fence1_s": t_fence1, "t_fence2_s": t_fence2,
             "t_fence_net_s": t_net1 + t_net2,
             "op_bytes_overlapped": ob_head, "op_bytes_fence": ob_tail,
             "slabs": S,
             "p_committed": p_committed, "c_committed": c_committed,
             "index_overflow": n_overflow,
             "starved": starved,
             "node_committed": node_c,
             "node_fence_wait_s": wait}
        if self.has_index:
            m["p_cskip"] = plog["cskip"].cpu().numpy()          # (P, T, K)
            m["c_cskip"] = (slog["cskip"].any(0).cpu().numpy()
                            if B > 0 else None)                # (B_pad, K)
        tr.complete("engine.epoch", "epoch", t_ep0, time.perf_counter(),
                    epoch=self.epoch - (1 if commit else 0),
                    committed=n_single + n_cross, commit=commit)
        return m

    # ------------------------------------------------------------------
    # two-version snapshots + node-granular state surgery (§4.5)
    # ------------------------------------------------------------------
    def _names(self):
        names = ["part_val", "part_tid", "part_idx",
                 "full_val", "full_tid", "full_idx"]
        if self.secondary:
            names += ["sec_val", "sec_tid", "sec_idx"]
        return names

    def _state(self):
        """The working arrays (not copies)."""
        return {n: getattr(self, n) for n in self._names()}

    def _load_state(self, st):
        """Make copies of ``st`` the working arrays."""
        for n in self._names():
            setattr(self, n, _clone(st[n]))

    def snapshot_commit(self):
        _copy_into(self._snap, self._state())
        self.committed_epoch = self.epoch
        # the in-flight slabs are now committed state: the changelog
        # retires them into its ledger and fires on_commit (WAL sink, MV
        # stamping) inside the fence.  slabs_shipped counts COMMITTED
        # slabs only — doomed epochs' ships land in slabs_discarded
        shipped, dropped = self.changelog.commit(self.epoch)
        self.stats.slabs_shipped += shipped
        self.stats.ledger_dropped += dropped

    def revert_to_snapshot(self):
        """Discard the in-flight epoch on every replica (two-version
        records, §4.5.2) — including every stream slab the subscribers
        consumed mid-phase (changelog revert: the re-executed epoch
        re-publishes from slab 0 onto the reverted base, so each slab
        applies to committed state exactly once)."""
        self._load_state(self._snap)
        self.stats.slabs_discarded += self.changelog.revert(self.epoch)

    def node_slice(self, node: int) -> slice:
        return slice(node * self.ppn, (node + 1) * self.ppn)

    def sec_home(self, node: int) -> int:
        """The node holding the physical secondary copy of ``node``'s
        block (round-robin: the next node)."""
        return (node + 1) % self.n_nodes

    def read_views(self):
        """Committed snapshot views for the read tier's SnapshotCatalog —
        one per physical replica copy: the master's full copy (covers
        every partition, identity row mapping) and each node's hosted
        secondary block (home-major rolled layout: partition p lives at
        array row (p + ppn) mod P; node m's view covers node m-1's
        partitions).  Always the COMMITTED snapshot buffers, so an
        in-flight or reverted epoch is never visible to a read; the
        secondary views of one fence hold the same tensors, which the
        catalog copies once for all of them."""
        wm = self.changelog.watermark(self.committed_epoch)
        P = self.P
        snap = self._snap
        views = [{
            "id": "full", "kind": "full", "node": 0,
            "epoch": self.committed_epoch, "watermark": wm,
            "cover": np.ones(P, bool),
            "row_of_partition": np.arange(P, dtype=np.int64),
            "val": snap["full_val"], "tid": snap["full_tid"],
            "idx": snap["full_idx"],
        }]
        if self.secondary:
            rop = (np.arange(P, dtype=np.int64) + self.ppn) % P
            for m in range(self.n_nodes):
                owner = (m - 1) % self.n_nodes
                cover = np.zeros(P, bool)
                cover[self.node_slice(owner)] = True
                views.append({
                    "id": f"sec{m}", "kind": "secondary", "node": m,
                    "epoch": self.committed_epoch, "watermark": wm,
                    "cover": cover, "row_of_partition": rop,
                    "val": snap["sec_val"], "tid": snap["sec_tid"],
                    "idx": snap["sec_idx"],
                })
        return views

    def scribble_node(self, node: int):
        """Simulate the node's memory dying with it: its primary partition
        block AND the secondary copy it hosted (of its predecessor's
        block), in BOTH the working state and the snapshot — so recovery
        is only correct if it really restores from a surviving source
        (secondary home, full replica, or disk)."""
        sl = self.node_slice(node)
        names = ["part_val", "part_tid", "part_idx"]
        if self.secondary:
            names += ["sec_val", "sec_tid", "sec_idx"]
        for name in names:
            _scribble(getattr(self, name), sl)
            _scribble(self._snap[name], sl)

    def scribble_full(self):
        """Simulate loss of every full replica (all f holders dead)."""
        for name in ("full_val", "full_tid", "full_idx"):
            _scribble(getattr(self, name), slice(None))
            _scribble(self._snap[name], slice(None))

    # -- recovery-time restores (all from the COMMITTED snapshot) --------
    def _restore_blocks(self, nodes, src: str, src_slice_fn):
        """Rebuild the nodes' primary partition blocks (records + index
        segments) from a surviving source (``src`` = "full" or "sec") in
        the committed snapshot, make that the committed version
        everywhere, and resync the rejoining secondary homes.  A copy on
        the card: source and destination are blocks of tensors there."""
        snap = self._snap
        for n in nodes:
            sl, ssl = self.node_slice(n), src_slice_fn(n)
            for f in ("val", "tid"):
                snap[f"part_{f}"][sl] = snap[f"{src}_{f}"][ssl]
            for pi, si in zip(snap["part_idx"], snap[f"{src}_idx"]):
                for k in FIELDS:
                    pi[k][sl] = si[k][ssl]
        self._resync_secondary()
        self._load_state(snap)

    def restore_nodes_from_full(self, nodes):
        """§4.5.3 case-1/3 donor copy: rebuild the nodes' partition blocks
        from the (surviving) full replica's committed snapshot, then make
        that the nodes' own committed version."""
        self._restore_blocks(nodes, "full", self.node_slice)

    def restore_blocks_from_secondary(self, nodes):
        """The surviving-copy restore: a dead node's primary block is
        rebuilt from the PHYSICAL secondary copy its neighbor holds — the
        copy itself, not an un-scribbled convenience alias.  Block n's
        secondary copy sits in its sec home's slice rows."""
        assert self.secondary, "no physical secondary replicas configured"
        self._restore_blocks(nodes, "sec",
                             lambda n: self.node_slice(self.sec_home(n)))

    def rebuild_full_from_partials(self):
        """§4.5.3 case 2: every partition still has a live partial copy
        but no full replica survives — re-replicate a full copy by
        gathering the committed partial set, index segments included."""
        snap = self._snap
        for f in ("val", "tid", "idx"):
            _copy_into(snap[f"full_{f}"], snap[f"part_{f}"])
        self._resync_secondary()
        self._load_state(snap)

    def _resync_secondary(self):
        """§4.5.3 catch-up for rejoining secondary homes: rebuild the
        home-major secondary copies from the committed primary set (the
        recovering node re-copies its hosted block)."""
        if not self.secondary:
            return
        snap = self._snap
        for f in ("val", "tid", "idx"):
            _copy_into(snap[f"sec_{f}"], self._roll_home(snap[f"part_{f}"]))

    def load_committed(self, val, tid, indexes=None):
        """§4.5.1 UNAVAILABLE reload: install a recovered committed state
        (checkpoint + replayed logs, index segments included) on every
        replica.  TID words arrive int64 (``db.wal.recover_full``)."""
        dev = self.device
        val = torch.as_tensor(val, device=dev).to(torch.int32).reshape(
            self.P, self.R, self.C)
        tid = torch.as_tensor(tid, device=dev).to(torch.int64).reshape(
            self.P, self.R)
        self.part_val, self.part_tid = val.clone(), tid.clone()
        self.full_val, self.full_tid = val.clone(), tid.clone()
        if self.has_index:
            # a recovered state MUST carry index arrays — silently keeping
            # the (scribbled) in-memory segments would commit garbage
            if indexes is None:
                raise ValueError(
                    "recovery returned no index arrays for an index engine "
                    "(checkpoint predates index durability?)")
            if len(indexes) != len(self.index_specs):
                raise ValueError((len(indexes), len(self.index_specs)))
            idx = [{k: torch.as_tensor(ix[k], device=dev) for k in FIELDS}
                   for ix in indexes]
            self.part_idx = _clone(idx)
            self.full_idx = _clone(idx)
        if self.secondary:
            self.sec_val = self._roll_home(val)
            self.sec_tid = self._roll_home(tid)
            self.sec_idx = self._roll_home(self.part_idx)
        # the reloaded state is the LAST COMMITTED epoch's — the in-flight
        # epoch (self.epoch) re-executes on top of it after recovery.
        # Deliberately NOT a changelog.commit: a commit here would hand
        # the WAL sink epoch-(e-1) state labeled epoch e.  The stream
        # history is gone — subscribers reset from the recovered arrays
        _copy_into(self._snap, self._state())
        self.committed_epoch = self.epoch - 1
        self.changelog.reset_from_state(self._snap["full_val"],
                                        self._snap["full_tid"],
                                        self.committed_epoch)

    # ------------------------------------------------------------------
    def consistent(self) -> bool:
        """Partial replicas == full replica (master copy) == physical
        secondary copies (rolled home-major layout), records AND every
        index segment."""
        part = (self.part_val, self.part_tid, self.part_idx)
        if not _equal(part, (self.full_val, self.full_tid, self.full_idx)):
            return False
        if self.secondary:
            return _equal(self._roll_home(part),
                          (self.sec_val, self.sec_tid, self.sec_idx))
        return True

    def partitioned_phase_has_no_collectives(self, batch) -> bool:
        """The §4.1 zero-coordination claim, checked on data: the
        reference proves it on the compiled program (no collective op in
        the partitioned phase's HLO); the port has no HLO, and its
        partitioned phase is one call over every node's block on one
        card.  So run the batch's first slab on copies and check that
        every record row and every index key node n's slab log writes
        lies inside node n's own block — a partitioned phase that needs
        nothing from another node needs no collective."""
        ptxn = self._to_device(StarEngine._pad_axis(batch["ptxn"], 1))
        bounds = self._slab_bounds(ptxn["row"].shape[1])
        slab = {k: v[:, bounds[0]:bounds[1]] for k, v in ptxn.items()}
        _, _, out, _ = run_partitioned(
            self.part_val, self.part_tid, slab, self.epoch, seq0=self._seq0,
            index=_clone(self.part_idx) if self.has_index else None)
        log = out["log"]
        P, R = self.P, self.R
        home = (torch.arange(P, device=self.device) // self.ppn)[:, None, None]
        rows = torch.arange(P, device=self.device)[:, None, None] * R \
            + log["row"].long()
        if not bool(((rows // (self.ppn * R) == home) | ~log["write"]).all()):
            return False
        if self.has_index:
            K = log["iwrite"].shape[-1]
            part = key_partition(log["delta"][:, :, :K, IX_KEY].long())
            if not bool(((part // self.ppn == home)
                         | ~log["iwrite"]).all()):
                return False
        return True


# ---------------------------------------------------------------------------
# one process a node: the cluster over a torch.distributed process group
# ---------------------------------------------------------------------------
def _pack(tree: dict):
    """A dict of tensors -> (one uint8 buffer, layout): the wire form of a
    log or a block.  Every dtype crosses as its bytes."""
    keys = sorted(tree)
    layout = [(k, tree[k].dtype, tuple(tree[k].shape)) for k in keys]
    parts = [tree[k].contiguous().reshape(-1).view(torch.uint8)
             for k in keys]
    return (torch.cat(parts) if parts else torch.empty(
        0, dtype=torch.uint8)), layout


def _unpack(buf, layout) -> dict:
    out, o = {}, 0
    for k, dtype, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[k] = buf[o:o + n].view(dtype).reshape(shape)
        o += n
    return out


def _flat_tree(tree, prefix=""):
    """Nested dicts/lists of tensors -> {dotted name: tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


class _Sent:
    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()
        self.buf = None


class _PendingObj:
    def __init__(self, comm, src: int, tag: int):
        self.comm, self.src, self.tag = comm, src, tag
        self.head = comm.irecv(8, src, tag)

    def done(self) -> bool:
        return self.head[0].is_completed()

    def take(self):
        c = self.comm
        n = int(c.take(self.head).cpu().view(torch.int64)[0])
        body = c.take(c.irecv(n, self.src, self.tag + 1))
        return pickle.loads(body.cpu().numpy().tobytes())


class _Comm:
    """The engine's calls on its process group, counted by kind (``calls``)
    with the bytes each rank put on the wire (``bytes_sent``).  With gloo a
    CUDA tensor crosses through host memory (gloo's point-to-point calls
    take host memory); NCCL moves device memory."""

    COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "barrier")

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = device
        self.stage = device.type == "cuda" and dist.get_backend() != "nccl"
        self.calls = dict.fromkeys(self.COLLECTIVES + ("send", "recv"), 0)
        self.bytes_sent = 0

    def collectives(self) -> int:
        return sum(self.calls[k] for k in self.COLLECTIVES)

    def _wire(self, t):
        return t.cpu() if self.stage else t

    def _home(self, t):
        return t.to(self.device) if self.stage else t

    # -- point to point -------------------------------------------------
    def isend(self, buf, dst: int, tag: int):
        """An asynchronous send; ``.wait()`` the result.  The wire copy
        stays referenced until then."""
        self.calls["send"] += 1
        self.bytes_sent += buf.numel() * buf.element_size()
        wire = self._wire(buf)
        return _Sent(self.dist.isend(wire, dst, tag=tag), wire)

    def irecv(self, nbytes: int, src: int, tag: int):
        """(work, buffer): the buffer holds the message once work is
        done (take it with :meth:`take`)."""
        self.calls["recv"] += 1
        buf = torch.empty(nbytes, dtype=torch.uint8,
                          device="cpu" if self.stage else self.device)
        return self.dist.irecv(buf, src, tag=tag), buf

    def take(self, pending):
        work, buf = pending
        work.wait()
        return self._home(buf)

    def send_tree(self, tree: dict, dst: int, tag: int):
        buf, _ = _pack(tree)
        self.isend(buf, dst, tag).wait()

    def recv_like(self, like: dict, src: int, tag: int) -> dict:
        """Receive a tree laid out as ``like`` (same keys, dtypes and
        shapes) from ``src``."""
        buf, layout = _pack(like)
        got = self.take(self.irecv(buf.numel(), src, tag))
        return _unpack(got, layout)

    def _out(self, t):
        return t if self.stage else t.to(self.device)

    def send_obj(self, obj, dst: int, tag: int):
        """A picklable object to ``dst``: its length (``tag``), then its
        bytes (``tag + 1``)."""
        raw = pickle.dumps(obj)
        head = torch.tensor([len(raw)], dtype=torch.int64).view(torch.uint8)
        body = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        sent = [self.isend(self._out(head), dst, tag),
                self.isend(self._out(body), dst, tag + 1)]
        for w in sent:
            w.wait()

    def post_obj(self, src: int, tag: int) -> "_PendingObj":
        """Listen for :meth:`send_obj`'s object from ``src``: ``.done()``
        polls for its length, ``.take()`` waits for the object."""
        return _PendingObj(self, src, tag)

    def recv_obj(self, src: int, tag: int):
        return self.post_obj(src, tag).take()

    # -- collectives ----------------------------------------------------
    def all_reduce(self, t, op="sum"):
        self.calls["all_reduce"] += 1
        w = self._wire(t)
        self.dist.all_reduce(w, op=getattr(self.dist.ReduceOp, op.upper()))
        return self._home(w)

    def broadcast_object(self, obj, src: int = 0):
        self.calls["broadcast"] += 1
        box = [obj]
        self.dist.broadcast_object_list(box, src=src)
        return box[0]

    def broadcast_buf(self, buf, nbytes: int, src: int = 0):
        """Broadcast a uint8 buffer of ``nbytes`` from ``src`` (``buf`` is
        read there only)."""
        self.calls["broadcast"] += 1
        if self.rank == src:
            w = self._wire(buf)
            self.bytes_sent += nbytes * (self.size - 1)
        else:
            w = torch.empty(nbytes, dtype=torch.uint8,
                            device="cpu" if self.stage else self.device)
        self.dist.broadcast(w, src=src)
        return buf if self.rank == src else self._home(w)

    def all_gather_cat(self, t, dim: int = 0):
        """Every rank's ``t`` concatenated along ``dim`` in rank order, bit
        for bit."""
        self.calls["all_gather"] += 1
        raw = self._wire(t.contiguous().reshape(-1).view(torch.uint8))
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        self.dist.all_gather(parts, raw)
        return torch.cat([self._home(p).view(t.dtype).reshape(t.shape)
                          for p in parts], dim=dim)

    def barrier(self):
        self.calls["barrier"] += 1
        self.dist.barrier()


class _DistShip:
    """ChangeLog subscriber of one rank: on the master (rank 0) each
    published slab — every node's committed log, received — replays in
    order on the full replica; on every rank the predecessor's slab
    replays on the physical secondary copy this rank hosts; the master's
    stream (broadcast) scatters back to this rank's primary and secondary
    blocks under the Thomas write rule (one ``thomas_merge`` launch a
    copy), and its index rounds replay on them with the blocks' own
    partition ids."""

    def __init__(self, eng):
        self.eng = eng

    def on_slab(self, log, info):
        eng = self.eng
        if eng.is_master:
            with obs.span("replica.replay_full", cat="replay",
                          epoch=info["epoch"], slab=info["slab"]):
                eng.full_val, eng.full_tid, fidx = repl.replay_partitioned(
                    eng.full_val, eng.full_tid, log,
                    eng.full_idx if eng.has_index else None)
                if eng.has_index:
                    eng.full_idx = fidx
        if eng.secondary:
            with obs.span("replica.replay_secondary", cat="replay",
                          epoch=info["epoch"], slab=info["slab"]):
                eng.sec_val, eng.sec_tid, sidx = repl.replay_partitioned(
                    eng.sec_val, eng.sec_tid, eng._pred_slab,
                    eng.sec_idx if eng.has_index else None,
                    part_ids=eng._sec_ids)
                if eng.has_index:
                    eng.sec_idx = sidx

    def on_master(self, stream):
        eng = self.eng
        ppn, R, C = eng.ppn, eng.R, eng.C
        with obs.span("replica.scatter_back", cat="replay"):
            slog = stream["log"]
            rows = slog["row"].reshape(-1)
            vals = slog["val"].reshape(-1, C)
            tids = slog["tid"].reshape(-1)
            blocks = [(eng.part_val, eng.part_tid, eng.rank)]
            if eng.secondary:
                blocks.append((eng.sec_val, eng.sec_tid, eng.pred))
            for v, t, node in blocks:
                # each rank filters the global stream to its own rows
                lo = node * ppn * R
                local = (rows >= lo) & (rows < lo + ppn * R)
                lrows = torch.where(local, rows - lo, -1).to(rows.dtype)
                repl.thomas_apply(v.view(ppn * R, C), t.view(ppn * R),
                                  lrows, vals, tids)
            if eng.has_index:
                kinds, delta = stream["kinds"], stream["delta"]
                eng.part_idx = repl.replay_index_rounds(
                    eng.part_idx, kinds, delta, slog["iwrite"], slog["tid"],
                    part_ids=eng._part_ids)
                if eng.secondary:
                    eng.sec_idx = repl.replay_index_rounds(
                        eng.sec_idx, kinds, delta, slog["iwrite"],
                        slog["tid"], part_ids=eng._sec_ids)


class DistClusterStarEngine(ClusterStarEngine):
    """The cluster engine with one process a node: rank n of the default
    process group is node n.  Rank n holds node n's block of the partial
    copy (``node_slice(n)``) and, with ``secondary``, the physical
    secondary copy of node n-1's block; the master (rank 0) also holds the
    full copy.  The epoch:

    * the master pads the batch and sends each rank its node's block of
      the partitioned queues (``ptxn``);
    * **partitioned phase**: each rank runs ``run_partitioned`` on its own
      ``ppn`` partitions (``part_ids`` its global ids) in ``n_slabs``
      slabs, with no collective call (``comm.calls`` shows it); each
      slab's committed log goes to the master and to the secondary home
      (n + 1) mod N with an asynchronous send while the next slab
      executes, so fence 1 waits only on the tail slab;
    * **fence 1**: an ``all_reduce`` of the per-node commit counters (and
      the phase's statistics and bytes shipped);
    * **single-master phase** on the master's full copy; its stream is
      broadcast and each rank applies it to its own rows (one
      ``thomas_merge`` launch a copy) and replays its index rounds;
    * **fence 2** and the two-version snapshot, per rank.

    ``run_epoch`` keeps the single-process metric surface (every rank
    returns the same metrics: the commit masks are gathered at fence 2)
    and adds the real bytes the epoch put on the group.  Every method is
    called on every rank with the same arguments, as a collective is;
    ``batch`` and ``load_committed``'s arrays are read on the master only.
    The node surgery of §4.5 moves blocks between ranks: the donor copy,
    the surviving secondary copy, the re-replication of the full copy, the
    secondary resync and ``consistent()`` are sends and receives of whole
    blocks.

    **The read round** (``reads/remote.py``): ``read_views`` gives the
    single-process views with each copy where it lives, so the read tier
    on the master serves the full copy and node 0's secondary copy itself
    and sends a group for ``sec{m}`` to rank m, which answers from the
    snapshots it keeps of its own secondary copy (``read_host``).  Between
    epochs a rank waiting in :meth:`_scatter_batch` answers the rounds the
    master opens; during a partitioned phase whose epoch carries an ingest
    hook (once :meth:`attach_read_peers` was called) it answers at each
    slab boundary and after its last slab until the master's END, with
    point-to-point messages only (``partitioned_collectives`` counts what the phases
    called: 0)."""

    def __init__(self, n_partitions: int, rows_per_partition: int,
                 n_cols: int = 10, init_val=None, max_rounds: int = 16,
                 iteration_ms: float = 10.0, adaptive_epoch: bool = False,
                 indexes: list[IndexSpec] | None = None,
                 net: Network | None = None, n_slabs: int = 4,
                 secondary: bool | None = None, device=None):
        """The node count is the group's size; ``init_val`` is read on the
        master.  device: ``None``/``"cuda"`` (this rank's card; raises
        without one) or ``"cpu"``."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistClusterStarEngine needs an initialised "
                               "process group (launch.mesh)")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.comm = _Comm(dev)
        self.rank, self.n_nodes = self.comm.rank, self.comm.size
        self.is_master = self.rank == 0
        N = self.n_nodes
        assert n_partitions % N == 0, (n_partitions, N)
        self.ppn = n_partitions // N
        self.P, self.R, self.C = n_partitions, rows_per_partition, n_cols
        self.index_specs = list(indexes or [])
        self.has_index = bool(self.index_specs)
        self.net = net or Network()
        assert n_slabs >= 1, n_slabs
        self.n_slabs = n_slabs
        self.secondary = (N > 1 if secondary is None
                          else (secondary and N > 1))
        self.pred = (self.rank - 1) % N
        P, R, C, ppn = self.P, self.R, self.C, self.ppn
        val = (torch.tensor(np.asarray(init_val, np.int32), device=dev)
               if init_val is not None and self.is_master else None)
        sl, psl = self.node_slice(self.rank), self.node_slice(self.pred)
        idx_full = [make_index(s, P, dev) for s in self.index_specs]
        if self.comm.broadcast_object(init_val is not None):
            # the master holds the initial table; each rank takes its blocks
            full = val if self.is_master else None
            self.part_val = self._from_master(full, sl, (ppn, R, C))
            sec = (self._from_master(full, psl, (ppn, R, C), tag=1)
                   if self.secondary else None)
        else:
            self.part_val = torch.zeros((ppn, R, C), dtype=torch.int32,
                                        device=dev)
            sec = self.part_val.clone()
        self.part_tid = torch.zeros((ppn, R), dtype=torch.int64, device=dev)
        self.part_idx = [{k: ix[k][sl].clone() for k in FIELDS}
                         for ix in idx_full]
        if self.is_master:
            self.full_val = (val.clone() if val is not None else
                             torch.zeros((P, R, C), dtype=torch.int32,
                                         device=dev))
            self.full_tid = torch.zeros((P, R), dtype=torch.int64,
                                        device=dev)
            self.full_idx = _clone(idx_full)
        if self.secondary:
            self.sec_val = sec
            self.sec_tid = self.part_tid.clone()
            self.sec_idx = [{k: ix[k][psl].clone() for k in FIELDS}
                            for ix in idx_full]
        else:
            self.sec_val = self.sec_tid = None
            self.sec_idx = []
        ar = lambda lo: torch.arange(lo, lo + ppn, dtype=torch.int32,
                                     device=dev)
        self._part_ids = ar(sl.start)
        self._sec_ids = ar(psl.start)
        self._seq0 = torch.zeros(ppn, dtype=torch.int64, device=dev)
        self._pred_slab = None
        self.epoch = 1
        self.max_rounds = max_rounds
        self.controller = PhaseController(e_ms=iteration_ms,
                                          adaptive=adaptive_epoch)
        self.stats = EngineStats()
        self.node_committed = np.zeros(N, np.int64)
        self.node_fence_wait_s = np.zeros(N)
        # bytes this engine's epochs put on the group (every rank's sends,
        # summed at fence 1): the ptxn blocks, the slab ships, the
        # single-master broadcast
        self.net_bytes = {"batch": 0, "slab_ship": 0, "master_stream": 0}
        self.changelog = ChangeLog(n_slabs, ledger_cap=self.LEDGER_CAP)
        self.changelog.subscribe(_DistShip(self))
        self.committed_epoch = 0
        self._snap = _clone(self._state())
        # the read round: the master's transport, this rank's serving side
        self._peers = self._host = None
        self._in_phase = self._phase_reads = False
        # collective calls made inside every partitioned phase run, doomed
        # epochs and mid-epoch reads included (the §4.1 claim: 0)
        self.partitioned_collectives = 0

    # -- layout -----------------------------------------------------------
    def _names(self):
        names = ["part_val", "part_tid", "part_idx"]
        if self.is_master:
            names += ["full_val", "full_tid", "full_idx"]
        if self.secondary:
            names += ["sec_val", "sec_tid", "sec_idx"]
        return names

    def _from_master(self, full, sl, shape, tag=0):
        """This rank's block ``sl`` of a tensor the master holds whole."""
        c = self.comm
        like = {"t": torch.empty(shape, dtype=torch.int32,
                                 device=self.device)}
        if self.is_master:
            for r in range(1, self.n_nodes):
                rs = (self.node_slice(r) if tag == 0 else
                      self.node_slice((r - 1) % self.n_nodes))
                c.send_tree({"t": full[rs]}, r, tag)
            return full[sl].clone()
        return c.recv_like(like, 0, tag)["t"].clone()

    def _ship_dests(self) -> list:
        d = {0, (self.rank + 1) % self.n_nodes} if self.secondary else {0}
        return sorted(d - {self.rank})

    def _ship_srcs(self) -> list:
        s = set(range(1, self.n_nodes)) if self.is_master else set()
        if self.secondary:
            s.add(self.pred)
        return sorted(s - {self.rank})

    # -- the batch: each rank its node's queues ---------------------------
    def _scatter_batch(self, batch, stop=False, reads=False):
        """The master pads ``batch`` and sends rank n its node's block of
        the partitioned queues; ``reads``: the master may send read
        requests during the phase.  Another rank first answers the read
        rounds the master opens before the epoch.  Returns (this rank's
        ptxn block, cross on the master / None, stop, reads)."""
        c, pad = self.comm, StarEngine._pad_axis
        if self.is_master:
            if stop:
                c.broadcast_object({"op": "stop"})
                return None, None, True, False
            ptxn = self._to_device(pad(batch["ptxn"], 1))
            cross = self._to_device(pad(batch["cross"], 0))
            _, layout = _pack({k: v[self.node_slice(0)]
                               for k, v in ptxn.items()})
            c.broadcast_object({"op": "epoch", "layout": layout,
                                "reads": reads})
            works = []
            for r in range(1, self.n_nodes):
                buf, _ = _pack({k: v[self.node_slice(r)]
                                for k, v in ptxn.items()})
                self.net_bytes["batch"] += buf.numel()
                works.append(c.isend(buf, r, tag=2))
            for w in works:
                w.wait()
            return ({k: v[self.node_slice(0)] for k, v in ptxn.items()},
                    cross, False, reads)
        while True:
            meta = c.broadcast_object(None)
            if meta["op"] != "reads":
                break
            self._read_host().answer_round()
        if meta["op"] == "stop":
            return None, None, True, False
        layout = meta["layout"]
        n = sum(int(np.prod(s, dtype=np.int64)) * d.itemsize
                for _, d, s in layout)
        got = c.take(c.irecv(n, 0, tag=2))
        return _unpack(got, layout), None, False, meta["reads"]

    # -- the read round (reads/remote.py) ---------------------------------
    def _read_host(self):
        """This rank's serving side: the ring of its secondary snapshots."""
        if self._host is None:
            from repro_torch.reads.remote import ReadHost
            self._host = ReadHost(self)
        return self._host

    @property
    def read_host(self):
        """This rank's :class:`~repro_torch.reads.remote.ReadHost` (None
        until the master's read tier first reached it, and on the
        master)."""
        return self._host

    @property
    def read_peers(self):
        """The master's :class:`~repro_torch.reads.remote.RemoteReads`
        once :meth:`attach_read_peers` made it, else None."""
        return self._peers

    def attach_read_peers(self):
        """Master only: make (once) and return the transport to the copies
        on other ranks.  From then on an epoch run with ``ingest`` lets the
        ingest hook send read requests during the partitioned phase (the
        other ranks poll for them at their slab boundaries)."""
        assert self.is_master
        if self._peers is None:
            from repro_torch.reads.remote import RemoteReads
            self._peers = RemoteReads(self)
        return self._peers

    def read_mode(self) -> str:
        """Master: the round a read request now belongs to, "mid_epoch"
        (in a partitioned phase whose other ranks serve reads) or "fence"
        (between epochs).  Raises inside a phase whose other ranks do not
        serve reads (the read tier reached the engine after the epoch
        began)."""
        if self._phase_reads:
            return "mid_epoch"
        if self._in_phase:
            raise RuntimeError("a read request inside a partitioned phase "
                               "whose epoch the other ranks do not serve "
                               "reads in")
        return "fence"

    def open_read_round(self):
        """Master, between epochs: the other ranks, waiting in
        :meth:`_scatter_batch`, answer read requests until an END."""
        self.comm.broadcast_object({"op": "reads"})

    def secondary_snapshot(self):
        """(val, tid, idx) of this rank's committed secondary copy (node
        ``pred``'s partitions, as of ``committed_epoch``)."""
        snap = self._snap
        return snap["sec_val"], snap["sec_tid"], snap["sec_idx"]

    def stop_followers(self):
        """Master only, in step with the other ranks' :meth:`follow`: end
        their loop."""
        assert self.is_master
        self._scatter_batch(None, stop=True)

    # ------------------------------------------------------------------
    def run_epoch(self, batch, ingest=None, commit=True,
                  abort_check=None) -> dict | None:
        """The single-process engine's epoch (class docstring), every rank
        in step.  ``batch`` is read on the master; a rank whose master
        called :meth:`stop_followers` instead gets None."""
        tr = obs.get_tracer()
        t_ep0 = time.perf_counter()
        c = self.comm
        pad = StarEngine._pad_axis
        sent0 = c.bytes_sent
        ptxn, cross, stop, reads = self._scatter_batch(
            batch, reads=self.is_master and ingest is not None
            and self._peers is not None)
        if stop:
            return None
        N, ppn = self.n_nodes, self.ppn
        host = self._read_host() if reads and not self.is_master else None
        if host is not None:
            host.phase_begin()

        # ---- partitioned phase: slab-chained execution + streaming ------
        T = ptxn["row"].shape[1]
        bounds = self._slab_bounds(T)
        S = len(bounds) - 1
        t0 = time.perf_counter()
        coll0 = c.collectives()
        pv, pt, seq = self.part_val, self.part_tid, self._seq0
        pidx = self.part_idx if self.has_index else None
        slab_logs, committed_chunks, pending, sends = [], [], {}, []
        extras = None
        aborted_at = None
        ship0 = c.bytes_sent

        def post(s, log):
            buf, _ = _pack(log)
            for d in self._ship_dests():
                sends.append(c.isend(buf, d, tag=16 + s))
            pending[s] = {src: c.irecv(buf.numel(), src, tag=16 + s)
                          for src in self._ship_srcs()}

        def publish(s):
            own = slab_logs[s]
            _, layout = _pack(own)
            got = {src: _unpack(c.take(w), layout)
                   for src, w in pending.pop(s).items()}
            got[self.rank] = own
            if self.secondary:
                self._pred_slab = got[self.pred]
            log = (own if not self.is_master else
                   {k: torch.cat([got[n][k] for n in range(N)], dim=0)
                    for k in own})
            self.changelog.publish_slab(log, self.epoch)

        for s in range(S):
            slab = {k: v[:, bounds[s]:bounds[s + 1]] for k, v in ptxn.items()}
            with tr.span("cluster.slab_execute", cat="phase",
                         epoch=self.epoch, slab=s,
                         txns=bounds[s + 1] - bounds[s]):
                pv, pt, out, st = run_partitioned(
                    pv, pt, slab, self.epoch, seq0=seq, index=pidx,
                    part_ids=self._part_ids)
            seq = out["seq"]
            if self.has_index:
                pidx = out["index"]
            if s > 0:
                # previous slab's stream ships while THIS slab executes
                publish(s - 1)
            slab_logs.append(out["log"])
            committed_chunks.append(out["committed"])
            x = torch.stack([st["consume_skips"], st["index_overflow"],
                             st["user_aborts"]])
            extras = x if extras is None else extras + x
            if abort_check is not None and abort_check(s):
                aborted_at = s
                break
            post(s, out["log"])
            if host is not None:     # a slab boundary: answer reads
                host.poll()
        if host is not None:
            host.poll(wait=True)
        t_ingest = 0.0
        if ingest is not None:       # host ingest while the card executes
            ti = time.perf_counter()
            self._in_phase, self._phase_reads = True, reads
            try:
                ingest()
            finally:
                self._in_phase = self._phase_reads = False
            if reads:
                self._peers.end_phase()
            t_ingest = time.perf_counter() - ti
            tr.complete("service.ingest_overlap", "service", ti,
                        ti + t_ingest, epoch=self.epoch)
        tb = time.perf_counter()
        self._sync()
        t1 = time.perf_counter()
        t_part = max(t1 - t0 - t_ingest, t1 - tb)
        coll_phase = c.collectives() - coll0
        self.partitioned_collectives += coll_phase
        tr.complete("engine.partitioned", "phase", t0, t1,
                    epoch=self.epoch, slabs=S)
        self.part_val, self.part_tid = pv, pt
        if self.has_index:
            self.part_idx = pidx

        if aborted_at is not None:
            for w in sends:
                w.wait()
            return {"aborted_at_slab": aborted_at,
                    "slabs_executed": aborted_at + 1,
                    "slabs_consumed": self._slab_hwm,
                    "collectives_in_partitioned_phase": coll_phase}

        # ---- tail ship: the ONLY stream transfer the fence waits on -----
        tt0 = time.perf_counter()
        with tr.span("fence.tail_ship", cat="fence", epoch=self.epoch,
                     slab=S - 1):
            publish(S - 1)
            for w in sends:
                w.wait()
        t_tail = time.perf_counter() - tt0
        ship_bytes = c.bytes_sent - ship0
        plog = self.changelog.epoch_plog()
        p_committed = (committed_chunks[0] if S == 1 else
                       torch.cat(committed_chunks, dim=1))

        # ---- fence 1: the per-node commit counters, all-reduced ----------
        tf0 = time.perf_counter()
        counts = torch.zeros(N + 4, dtype=torch.int64, device=self.device)
        counts[self.rank] = p_committed.sum()
        counts[N:N + 3] = extras
        counts[N + 3] = ship_bytes
        counts = c.all_reduce(counts)
        t_allreduce = time.perf_counter() - tf0
        node_counts = counts[:N]
        n_single = int(node_counts.sum())
        n_skips, n_overflow, p_aborts = (int(x) for x in counts[N:N + 3])
        group_ship_bytes = int(counts[N + 3])
        tr.complete("fence.psum", "fence", tf0, time.perf_counter(),
                    epoch=self.epoch)

        # ---- single-master phase on the master's full copy ---------------
        t0 = time.perf_counter()
        P, R, C = self.P, self.R, self.C
        if self.is_master:
            attr = self.changelog.attribute(batch, plog, self.has_index,
                                            lambda a: pad(a, 1))
            t_net1 = repl.fence_net_seconds(self.net, attr.fence,
                                            attr.overlapped, t_part)
            B = int(batch["cross"]["row"].shape[0])
            meta = {"B": B, "vb_alt": attr.value_bytes_alt,
                    "ib": attr.index_op_bytes, "ob": attr.total,
                    "ob_head": attr.overlapped, "ob_tail": attr.fence,
                    "t_net1": t_net1}
            slog = None
            if B > 0:
                fv, ft, out, sstats = run_single_master(
                    self.full_val.reshape(P * R, C),
                    self.full_tid.reshape(P * R), cross, self.epoch,
                    max_rounds=self.max_rounds,
                    index=self.full_idx if self.has_index else None)
                self._sync()
                self.full_val = fv.view(P, R, C)
                self.full_tid = ft.view(P, R)
                if self.has_index:
                    self.full_idx = out["index"]
                slog = out["log"]
                vb = 0
                if "c_row_bytes" in batch:
                    cw = slog["write"].cpu().numpy()
                    crb = np.broadcast_to(pad(batch["c_row_bytes"], 0),
                                          cw.shape[1:])
                    vb = int(repl.value_bytes(cw, crb[None]))
                elif batch.get("row_bytes") is not None:
                    vb = int(repl.value_bytes(
                        slog["write"], batch["row_bytes"][None, None, :]))
                stream = dict(slog)
                stream["_kinds"], stream["_delta"] = (cross["kind"],
                                                      cross["delta"])
                buf, layout = _pack(stream)
                meta.update(
                    vb=vb, layout=layout, nbytes=buf.numel(),
                    n_cross=int(sstats["committed"]),
                    starved=int(sstats["starved"]),
                    retries=int(sstats["retries"]),
                    aborts=int(sstats["user_aborts"]),
                    sm_skips=int(sstats["consume_skips"]),
                    sm_overflow=int(sstats["index_overflow"]),
                    ib_sm=(repl.index_op_bytes(slog["iwrite"])
                           if self.has_index else 0),
                    c_committed=out["committed"].cpu().numpy())
            meta = c.broadcast_object(meta)
        else:
            meta = c.broadcast_object(None)
            buf = None
        B = meta["B"]
        tr.complete("engine.single_master", "phase", t0,
                    time.perf_counter(), epoch=self.epoch,
                    rounds=self.max_rounds if B else 0)
        # ---- the master's stream, broadcast, applied by every rank ------
        slog = None
        if B > 0:
            mb0 = c.bytes_sent
            got = c.broadcast_buf(buf, meta["nbytes"])
            self.net_bytes["master_stream"] += c.bytes_sent - mb0
            stream = _unpack(got, meta["layout"])
            kinds, delta = stream.pop("_kinds"), stream.pop("_delta")
            slog = stream
            self.changelog.publish_master(slog, kinds=kinds, delta=delta)
            n_cross, starved = meta["n_cross"], meta["starved"]
            retries, aborts = meta["retries"], meta["aborts"]
            sm_skips, sm_overflow = meta["sm_skips"], meta["sm_overflow"]
            c_committed, vb, ib_sm = (meta["c_committed"], meta["vb"],
                                      meta["ib_sm"])
        else:
            n_cross = starved = retries = aborts = 0
            sm_skips = sm_overflow = vb = ib_sm = 0
            c_committed = np.zeros(0, bool)
        t_sm = time.perf_counter() - t0
        t_sm_round = t_sm / self.max_rounds if B > 0 else 0.0
        t_fence1 = tf0 + t_allreduce

        # ---- fence 2: epoch boundary + two-version snapshot --------------
        tf2 = time.perf_counter()
        self._sync()
        tr.complete("fence.replay_drain", "fence", tf2,
                    time.perf_counter(), epoch=self.epoch)
        t_net2 = repl.fence_net_seconds(self.net, vb + ib_sm)
        pc = p_committed.to(torch.uint8)
        p_committed = c.all_gather_cat(pc).bool().cpu().numpy()   # (P, T)
        if self.has_index:                  # this rank's own slabs
            own = torch.cat([lg["cskip"] for lg in slab_logs], dim=1)
            p_cskip = c.all_gather_cat(own.to(torch.uint8)).bool()\
                .cpu().numpy()
        node_c = p_committed.sum(1).reshape(N, -1).sum(1)
        cmax = int(node_c.max()) if node_c.size else 0
        wait = (t_part * (1.0 - node_c / cmax) if cmax > 0
                else np.zeros(N))
        tau_p = tau_s = 0.0
        n_skips += sm_skips
        n_overflow += sm_overflow
        aborts += p_aborts
        if commit:
            self.snapshot_commit()
            self.epoch += 1
            self.node_committed += node_c
            self.node_fence_wait_s += wait
            self.controller.observe_fence_wait(float(wait.max()) * 1e3)
            self.controller.observe("partitioned", n_single, t_part)
            self.controller.observe("single", n_cross, t_sm,
                                    frac_cross=n_cross
                                    / max(n_cross + n_single, 1))
            tau_p, tau_s = self.controller.plan()
        t_fence2 = time.perf_counter()
        tr.complete("engine.fence", "fence", tf2, t_fence2, which=2,
                    epoch=self.epoch - (1 if commit else 0), commit=commit)
        self.net_bytes["slab_ship"] += group_ship_bytes
        if commit:
            s = self.stats
            s.epochs += 1
            s.committed_single += n_single
            s.committed_cross += n_cross
            s.user_aborts += aborts
            s.consume_skips += n_skips
            s.index_overflow += n_overflow
            s.retries += retries
            s.part_time_s += t_part
            s.sm_time_s += t_sm
            s.sm_rounds += self.max_rounds if B > 0 else 0
            s.fences += 2
            s.fence_time_s += t_allreduce + t_tail + (t_fence2 - tf2)
            s.fence_net_s += meta["t_net1"] + t_net2
            s.value_bytes += vb
            s.op_bytes_hybrid += meta["ob"]
            s.value_bytes_if_not_hybrid += meta["vb_alt"]
            s.index_op_bytes += meta["ib"] + ib_sm
            s.op_bytes_overlapped += meta["ob_head"]
            s.op_bytes_fence += meta["ob_tail"]

        m = {"committed_single": n_single, "committed_cross": n_cross,
             "tau_p_ms": tau_p, "tau_s_ms": tau_s,
             "t_part_s": t_part, "t_sm_s": t_sm,
             "t_sm_round_s": t_sm_round, "t_ingest_s": t_ingest,
             "t_fence1_s": t_fence1, "t_fence2_s": t_fence2,
             "t_fence_net_s": meta["t_net1"] + t_net2,
             "t_tail_ship_s": t_tail, "t_allreduce_s": t_allreduce,
             "op_bytes_overlapped": meta["ob_head"],
             "op_bytes_fence": meta["ob_tail"],
             "slabs": S,
             "p_committed": p_committed, "c_committed": c_committed,
             "index_overflow": n_overflow,
             "starved": starved,
             "node_committed": node_c,
             "node_fence_wait_s": wait,
             "net_slab_ship_bytes": group_ship_bytes,
             "net_rank_bytes": c.bytes_sent - sent0,
             "collectives_in_partitioned_phase": coll_phase}
        if self.has_index:
            m["p_cskip"] = p_cskip                               # (P, T, K)
            m["c_cskip"] = (slog["cskip"].any(0).cpu().numpy()
                            if B > 0 else None)                # (B_pad, K)
        tr.complete("engine.epoch", "epoch", t_ep0, time.perf_counter(),
                    epoch=self.epoch - (1 if commit else 0),
                    committed=n_single + n_cross, commit=commit)
        return m

    # ------------------------------------------------------------------
    # node surgery (§4.5) as moves between ranks
    # ------------------------------------------------------------------
    def _block(self, st, copy: str):
        """{"val","tid","idx"} of this rank's ``copy`` ("part" / "sec")
        in the state dict ``st``."""
        return {"val": st[f"{copy}_val"], "tid": st[f"{copy}_tid"],
                "idx": st[f"{copy}_idx"]}

    def _move(self, src: int, dst: int, tree, tag: int):
        """``tree`` (read on ``src``) delivered to ``dst``: returns it there
        (None elsewhere).  ``tree`` must have the shape the receiver's own
        blocks have."""
        if src == dst:
            return _clone(tree) if self.rank == src else None
        if self.rank == src:
            self.comm.send_tree(_flat_tree(tree), dst, tag)
        elif self.rank == dst:
            like = _flat_tree(self._block(self._snap, "part"))
            flat = self.comm.recv_like(like, src, tag)
            return {"val": flat["val"], "tid": flat["tid"],
                    "idx": [{k: flat[f"idx.{i}.{k}"] for k in FIELDS}
                            for i in range(len(self.index_specs))]}
        return None

    def _set_block(self, st, copy: str, blk):
        st[f"{copy}_val"].copy_(blk["val"])
        st[f"{copy}_tid"].copy_(blk["tid"])
        _copy_into(st[f"{copy}_idx"], blk["idx"])

    def _full_block(self, st, node: int):
        sl = self.node_slice(node)
        return {"val": st["full_val"][sl], "tid": st["full_tid"][sl],
                "idx": [{k: ix[k][sl] for k in FIELDS}
                        for ix in st["full_idx"]]}

    def scribble_node(self, node: int):
        """The rank of ``node`` loses its memory: its primary block and the
        secondary copy it hosts, working state and snapshot."""
        if self.rank != node:
            return
        names = ["part_val", "part_tid", "part_idx"]
        if self.secondary:
            names += ["sec_val", "sec_tid", "sec_idx"]
        for name in names:
            _scribble(getattr(self, name), slice(None))
            _scribble(self._snap[name], slice(None))

    def scribble_full(self):
        if self.is_master:
            for name in ("full_val", "full_tid", "full_idx"):
                _scribble(getattr(self, name), slice(None))
                _scribble(self._snap[name], slice(None))

    def _exchange(self, tree, dests, srcs, tag: int) -> dict:
        """One round: this rank's ``tree`` sent to every rank of ``dests``
        while the trees of ``srcs`` (laid out as this rank's) arrive.
        Returns {rank: flat tree} for ``srcs`` and this rank."""
        c = self.comm
        mine = _flat_tree(tree)
        buf, layout = _pack(mine)
        sends = [c.isend(buf, d, tag) for d in dests]
        pend = {s: c.irecv(buf.numel(), s, tag) for s in srcs}
        got = {s: _unpack(c.take(w), layout) for s, w in pend.items()}
        for w in sends:
            w.wait()
        got[self.rank] = mine
        return got

    def _resync_secondary(self):
        """Every rank sends its committed primary block to its secondary
        home, which takes it as its secondary copy."""
        if not self.secondary:
            return
        N, snap = self.n_nodes, self._snap
        home = (self.rank + 1) % N
        got = self._exchange(self._block(snap, "part"), [home], [self.pred],
                             tag=32)[self.pred]
        _copy_into(_flat_tree(self._block(snap, "sec")), got)

    def _restore_blocks(self, nodes, src: str, src_slice_fn=None):
        """Rebuild the nodes' primary blocks in the committed snapshot from
        the master's full copy (``src`` "full") or from the secondary home's
        physical copy (``src`` "sec"), resync the secondary homes, and make
        the snapshot the working state."""
        snap = self._snap
        for n in nodes:
            if src == "full":
                owner = 0
                blk = self._full_block(snap, n) if self.is_master else None
            else:
                owner = self.sec_home(n)
                blk = (self._block(snap, "sec") if self.rank == owner
                       else None)
            got = self._move(owner, n, blk, tag=64 + n)
            if got is not None:
                self._set_block(snap, "part", got)
        self._resync_secondary()
        self._load_state(snap)

    def restore_nodes_from_full(self, nodes):
        self._restore_blocks(sorted(nodes), "full")

    def restore_blocks_from_secondary(self, nodes):
        assert self.secondary, "no physical secondary replicas configured"
        self._restore_blocks(sorted(nodes), "sec")

    def rebuild_full_from_partials(self):
        """Re-replicate the master's full copy by gathering every rank's
        committed primary block."""
        snap = self._snap
        for n in range(self.n_nodes):
            got = self._move(n, 0, self._block(snap, "part")
                             if self.rank == n else None, tag=96 + n)
            if got is not None:
                self._write_full(snap, n, got)
        self._resync_secondary()
        self._load_state(snap)

    def _write_full(self, st, node, blk):
        sl = self.node_slice(node)
        st["full_val"][sl] = blk["val"]
        st["full_tid"][sl] = blk["tid"]
        for d, s in zip(st["full_idx"], blk["idx"]):
            for k in FIELDS:
                d[k][sl] = s[k]

    def load_committed(self, val, tid, indexes=None):
        """§4.5.1 UNAVAILABLE reload: the master's recovered committed state
        (``val``/``tid``/``indexes`` read there) installed on every copy:
        the master keeps it whole and sends each rank its blocks."""
        dev = self.device
        if self.is_master:
            val = torch.as_tensor(val, device=dev).to(torch.int32).reshape(
                self.P, self.R, self.C)
            tid = torch.as_tensor(tid, device=dev).to(torch.int64).reshape(
                self.P, self.R)
            if self.has_index:
                if indexes is None:
                    raise ValueError(
                        "recovery returned no index arrays for an index "
                        "engine (checkpoint predates index durability?)")
                if len(indexes) != len(self.index_specs):
                    raise ValueError((len(indexes), len(self.index_specs)))
                idx = [{k: torch.as_tensor(ix[k], device=dev)
                        for k in FIELDS} for ix in indexes]
            else:
                idx = []
            self.full_val, self.full_tid = val.clone(), tid.clone()
            self.full_idx = _clone(idx)
            whole = {"full_val": val, "full_tid": tid, "full_idx": idx}
        N = self.n_nodes
        for copy, node_of in (("part", lambda r: r),
                              ("sec", lambda r: (r - 1) % N)):
            if copy == "sec" and not self.secondary:
                continue
            for r in range(N):
                blk = (self._full_block(whole, node_of(r))
                       if self.is_master else None)
                got = self._move(0, r, blk, tag=128 + r)
                if got is not None:
                    setattr(self, f"{copy}_val", got["val"].clone())
                    setattr(self, f"{copy}_tid", got["tid"].clone())
                    setattr(self, f"{copy}_idx", _clone(got["idx"]))
        _copy_into(self._snap, self._state())
        self.committed_epoch = self.epoch - 1
        vt = (self._snap["full_val"], self._snap["full_tid"]) \
            if self.is_master else (self._snap["part_val"],
                                    self._snap["part_tid"])
        self.changelog.reset_from_state(*vt, self.committed_epoch)

    # ------------------------------------------------------------------
    def consistent(self) -> bool:
        """Every rank's primary block == the master's full copy there ==
        the physical secondary copy its home holds, records AND every index
        segment: each rank sends its working primary block to the master
        and to its secondary home in one round, and the verdicts are
        all-reduced."""
        st = self._state()
        got = self._exchange(self._block(st, "part"), self._ship_dests(),
                             self._ship_srcs(), tag=160)
        ok = True
        if self.is_master:
            ok &= all(_equal(got[n], _flat_tree(self._full_block(st, n)))
                      for n in range(self.n_nodes))
        if self.secondary:
            ok &= _equal(got[self.pred], _flat_tree(self._block(st, "sec")))
        bad = torch.tensor([0 if ok else 1], dtype=torch.int64,
                           device=self.device)
        return int(self.comm.all_reduce(bad)) == 0

    def gather_copies(self):
        """Every copy assembled on the master in the single-process
        engine's layout (``part_*`` and ``sec_*`` of all P partitions,
        ``full_*``) — None on the other ranks.  A check, not a path."""
        N, out = self.n_nodes, {}
        for copy in ("part", "sec") if self.secondary else ("part",):
            blocks = []
            for n in range(N):
                got = self._move(n, 0, self._block(self._state(), copy)
                                 if self.rank == n else None, tag=224 + n)
                blocks.append(got)
            if self.is_master:
                out[f"{copy}_val"] = torch.cat([b["val"] for b in blocks])
                out[f"{copy}_tid"] = torch.cat([b["tid"] for b in blocks])
                out[f"{copy}_idx"] = [
                    {k: torch.cat([b["idx"][i][k] for b in blocks])
                     for k in FIELDS} for i in range(len(self.index_specs))]
        if not self.is_master:
            return None
        out.update(full_val=self.full_val.clone(),
                   full_tid=self.full_tid.clone(),
                   full_idx=_clone(self.full_idx))
        return out

    def committed_state(self):
        """The master's committed full copy (None on the other ranks)."""
        if not self.is_master:
            return None
        return self._snap["full_val"], self._snap["full_tid"]

    def read_views(self):
        """The single-process engine's views (same ids, kinds, nodes,
        epochs, watermarks and covers) with each copy where it lives: the
        full copy on the master, ``sec{m}`` (node m-1's partitions) on
        rank m, whose ``ppn`` rows hold them in order, so
        ``row_of_partition`` maps a covered partition to its row there
        (-1 elsewhere).  A view of a copy on another rank carries
        ``val``/``tid``/``idx`` None: the read tier sends its groups to
        that rank (``reads/remote.py``)."""
        wm = self.changelog.watermark(self.committed_epoch)
        P, ppn, snap = self.P, self.ppn, self._snap
        parts = np.arange(P, dtype=np.int64)

        def copy(view, node, which):
            mine = self.rank == node
            view.update({k: snap[f"{which}_{k}"] if mine else None
                         for k in ("val", "tid", "idx")})
            return view
        views = [copy({
            "id": "full", "kind": "full", "node": 0,
            "epoch": self.committed_epoch, "watermark": wm,
            "cover": np.ones(P, bool), "row_of_partition": parts}, 0, "full")]
        if self.secondary:
            for m in range(self.n_nodes):
                owner = (m - 1) % self.n_nodes
                cover = np.zeros(P, bool)
                cover[self.node_slice(owner)] = True
                views.append(copy({
                    "id": f"sec{m}", "kind": "secondary", "node": m,
                    "epoch": self.committed_epoch, "watermark": wm,
                    "cover": cover,
                    "row_of_partition": np.where(cover, parts - owner * ppn,
                                                 -1)}, m, "sec"))
        return views

    def partitioned_phase_has_no_collectives(self, batch) -> bool:
        """The §4.1 zero-coordination claim, counted: run this rank's first
        slab on copies (its own block, its global partition ids) and check
        that no collective call reached the group meanwhile; all ranks'
        verdicts are all-reduced.  ``batch`` is read on the master."""
        ptxn = self._scatter_batch(batch)[0]
        bounds = self._slab_bounds(ptxn["row"].shape[1])
        slab = {k: v[:, bounds[0]:bounds[1]] for k, v in ptxn.items()}
        before = self.comm.collectives()
        run_partitioned(self.part_val, self.part_tid, slab, self.epoch,
                        seq0=self._seq0,
                        index=_clone(self.part_idx) if self.has_index
                        else None, part_ids=self._part_ids)
        self._sync()
        ok = self.comm.collectives() == before
        bad = torch.tensor([0 if ok else 1], dtype=torch.int64,
                           device=self.device)
        return int(self.comm.all_reduce(bad)) == 0
