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
"""
from __future__ import annotations

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

