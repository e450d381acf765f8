"""PyTorch port: the cluster runtime (``repro_torch.cluster``) on the CPU,
the checks of the reference's cluster tests held against the JAX
single-host ``StarEngine`` fed the same batches.

The JAX multi-node runtime does not run here (its physical secondary
copies fail to trace on a CPU mesh; see tests/test_torch_cluster.py), so
every test below runs the port's ``ClusterRuntime(4, ...,
device="cpu")`` — 4 simulated nodes with physical secondary copies — and
feeds copies of the same batches to ``repro.core.engine.StarEngine``:
after the failure epochs the port's full copy (records and every index
segment) must be bit-equal to it (tolerance 0; TID words by value).
Ported checks: tests/test_cluster_runtime.py (3),
tests/test_cluster_streaming.py (4), tests/test_cluster_router.py's two
cluster tests, the cluster MV property of tests/test_changelog.py, the
cluster read property of tests/test_reads.py, the recovery span tree of
tests/test_obs.py, and the counterpart of
tests/test_multidevice.py::test_star_partitioned_phase_shard_map_8dev.
The pure-Python ``Coordinator``, ``FaultInjector`` and ``catch_up`` are
held against the JAX modules in-process.
"""
import copy
import json
from collections import Counter

import numpy as np
import pytest
import torch

from repro.cluster.coordinator import Coordinator as JCoordinator
from repro.core import fault as jfault
from repro.core.engine import StarEngine as JEngine
from repro.core.phase_switch import PhaseController as JController
from repro.core.replication import thomas_apply as jthomas_apply
from repro_torch.changelog import AnalyticsLane
from repro_torch.cluster import ClusterRuntime, ClusterTxnService
from repro_torch.cluster.coordinator import Coordinator
from repro_torch.core import fault
from repro_torch.core.cluster import ClusterStarEngine
from repro_torch.core.engine import StarEngine
from repro_torch.core.fault import FaultInjector, RecoveryCase
from repro_torch.core.partitioned import run_partitioned
from repro_torch.core.phase_switch import PhaseController
from repro_torch.core.replication import thomas_apply
from repro_torch.db import tpcc, ycsb
from repro_torch.db.wal import Durability
from repro_torch.obs.trace import Tracer, set_tracer
from repro_torch.reads import ReadTier, reference_read
from repro_torch.service import (AdmissionConfig, AdmissionController,
                                 OpenLoopClient, YCSBSource)

TPCC4 = dict(n_partitions=4, n_items=400, cust_per_district=40,
             order_ring=64, mix="full", delivery_gen_lag=256)
TPCC8 = dict(n_partitions=8, n_items=400, cust_per_district=40,
             order_ring=64, mix="full", delivery_gen_lag=96)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers at once, whose thread pools would otherwise contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ycsb(P=8, R=128):
    return ycsb.YCSBConfig(n_partitions=P, records_per_partition=R)


def _tpcc(kw, seed=7):
    cfg = tpcc.TPCCConfig(**kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(seed), state=state)
    return cfg, state, init


def _jstar(P, R, init=None, cfg=None):
    return JEngine(P, R, init_val=init,
                   indexes=tpcc.index_specs(cfg) if cfg is not None else None)


def _assert_full_equals_jax(eng, jeng, what=""):
    """The port cluster's full copy (records + every index segment) equal
    to the JAX single-host engine's master."""
    assert np.array_equal(eng.full_val.numpy(),
                          np.asarray(jeng.master["val"])), what
    assert np.array_equal(eng.full_tid.numpy(),
                          np.asarray(jeng.master["tid"]).astype(np.int64)), \
        what
    for i, (a, b) in enumerate(zip(eng.full_idx, jeng.store.indexes)):
        for k in ("key", "prow", "tid"):
            assert np.array_equal(a[k].numpy(),
                                  np.asarray(b[k]).astype(np.int64)), \
                (what, i, k)


# ---------------------------------------------------------------------------
# tests/test_cluster_runtime.py
# ---------------------------------------------------------------------------
def test_runtime_parity_and_case1_failover():
    """ClusterRuntime (ppn=2) matches the JAX StarEngine's commit counts;
    killing one partial node classifies PHASE_SWITCHING, restores the
    node's block from the full replica (a real donor copy — the block was
    scribbled), and the replicas are bit-identical at the next fence."""
    cfg = _ycsb()
    inj = FaultInjector()
    inj.schedule_kill(2, epoch=3)
    rt = ClusterRuntime(4, 8, 128, injector=inj, device="cpu")
    jeng = _jstar(8, 128)
    events = []
    for ep in range(5):
        batch = ycsb.make_batch(cfg, 128, seed=ep)
        mc = rt.run_epoch(copy.deepcopy(batch))
        ms = jeng.run_epoch(batch)
        assert mc["committed_single"] == ms["committed_single"], ep
        assert mc["committed_cross"] == ms["committed_cross"], ep
        assert rt.replica_consistent(), ep
        if "recovery" in mc:
            events.append(mc["recovery"])
    _assert_full_equals_jax(rt.eng, jeng)
    [ev] = events
    assert ev.case is RecoveryCase.PHASE_SWITCHING, ev
    assert ev.run_mode == "star" and ev.failed == (2,)
    assert ev.t_recovery_s > 0 and ev.reverted_to == 2
    assert rt.coordinator.view >= 3
    assert inj.killed == set()


def test_runtime_unavailable_reloads_from_disk(tmp_path):
    """Full-replica node plus both homes of a block killed: UNAVAILABLE.
    The runtime reloads checkpoint + per-node logs from disk (the blocks
    and the full copy were scribbled) and resumes bit-identical."""
    cfg = _ycsb()
    inj = FaultInjector()
    for n in (0, 1, 2):
        inj.schedule_kill(n, epoch=4)
    dur = Durability(str(tmp_path), n_workers=4, checkpoint_every=2)
    rt = ClusterRuntime(4, 8, 128, injector=inj, durability=dur,
                        device="cpu")
    jeng = _jstar(8, 128)
    events = []
    for ep in range(6):
        b = ycsb.make_batch(cfg, 128, seed=ep)
        m = rt.run_epoch(copy.deepcopy(b))
        jeng.run_epoch(b)
        assert rt.replica_consistent(), ep
        if "recovery" in m:
            events.append(m["recovery"])
    _assert_full_equals_jax(rt.eng, jeng)
    [ev] = events
    assert ev.case is RecoveryCase.UNAVAILABLE, ev
    assert ev.reloaded_from_disk and ev.run_mode == "halt"
    assert set(ev.lost_blocks) == {0, 1}
    assert dur.checkpoints >= 1 and dur.entries_logged > 0
    dur.close()


def _recording(rt):
    """Wrap ``rt.run_epoch`` to keep a copy of every batch it runs."""
    rec = []
    run = rt.run_epoch

    def recorded(batch, ingest=None):
        rec.append(copy.deepcopy(batch))
        return run(batch, ingest=ingest)
    rt.run_epoch = recorded
    return rec


def test_cluster_service_node_sharded_with_failure():
    """The online service over the cluster: node-sharded admission
    (per-node queue caps), double-buffered batching, a mid-run node kill
    recovered live, and per-node telemetry; the batches it ran, replayed
    through the JAX StarEngine, give the same state."""
    cfg = _ycsb()
    inj = FaultInjector()
    inj.schedule_kill(3, epoch=6)
    rt = ClusterRuntime(4, 8, 128, injector=inj, device="cpu")
    batches = _recording(rt)
    client = OpenLoopClient(YCSBSource(cfg, seed=1), rate_txn_s=800.0,
                            seed=7)
    svc = ClusterTxnService(rt, [client],
                            AdmissionConfig(64, 64, node_queue_cap=96),
                            slots_per_partition=16, master_lanes=16)
    out = svc.run(duration_s=1.0)
    assert rt.replica_consistent()
    assert out["committed"] > 0
    assert out["recoveries"] == 1 and out["recovery_latency_s"][0] > 0
    assert len(out["node_committed"]) == 4
    assert sum(out["node_committed"]) == rt.stats.committed_single
    assert len(out["node_queue_depth_max"]) == 4
    assert len(out["node_fence_wait_s"]) == 4
    assert len(out["node_shed"]) == 4
    snap = svc.metrics.snapshot(rt.committed_epoch)
    assert snap["cluster.recoveries"] == 1
    assert sum(snap[f"cluster.node{k}.committed"] for k in range(4)) \
        == rt.stats.committed_single
    jeng = _jstar(8, 128)
    for b in batches:
        jeng.run_epoch(b)
    _assert_full_equals_jax(rt.eng, jeng, "service replay")


# ---------------------------------------------------------------------------
# tests/test_cluster_streaming.py
# ---------------------------------------------------------------------------
def test_cluster_full_mix_bit_equal_to_star_engine():
    """The five-transaction TPC-C mix on ClusterRuntime: commit counts
    match the JAX StarEngine, and records AND every index segment are
    bit-equal across the full replica, the partials, the physical
    secondaries, and the JAX engine at every fence."""
    cfg, s1, init1 = _tpcc(TPCC4)
    rt = ClusterRuntime(4, 4, cfg.rows_per_partition, init_val=init1,
                        indexes=tpcc.index_specs(cfg), device="cpu")
    jeng = _jstar(4, cfg.rows_per_partition, init1, cfg)
    assert rt.eng.secondary
    for ep in range(4):
        b = tpcc.make_batch(cfg, s1, 192, seed=ep)
        mc = rt.run_epoch(copy.deepcopy(b))
        ms = jeng.run_epoch(b)
        tpcc.apply_consume_feedback(s1, b, mc)
        assert mc["committed_single"] == ms["committed_single"], ep
        assert mc["committed_cross"] == ms["committed_cross"], ep
        assert rt.replica_consistent(), ep
        _assert_full_equals_jax(rt.eng, jeng, ep)
    assert rt.stats.index_op_bytes > 0
    assert rt.stats.op_bytes_overlapped > 0


def test_midstream_kill_discards_and_restreams_exactly_once():
    """A node killed MID-STREAM (at slab 1): the revert discards exactly
    the consumed slabs and the re-executed epoch re-streams from slab 0 —
    every committed epoch's slabs applied exactly once."""
    cfg = _ycsb()
    inj = FaultInjector()
    inj.schedule_kill(2, epoch=3, slab=1)
    rt = ClusterRuntime(4, 8, 128, injector=inj, device="cpu")
    jeng = _jstar(8, 128)
    events = []
    for ep in range(5):
        b = ycsb.make_batch(cfg, 128, seed=ep)
        m = rt.run_epoch(copy.deepcopy(b))
        jeng.run_epoch(b)
        assert rt.replica_consistent(), ep
        if "recovery" in m:
            events.append(m["recovery"])
    [ev] = events
    assert ev.case is RecoveryCase.PHASE_SWITCHING, ev
    assert ev.aborted_at_slab == 1, ev
    assert ev.slabs_discarded >= 1, ev
    counts = Counter(rt.eng.slab_ledger)
    assert max(counts.values()) == 1, counts
    epochs = sorted({e for e, _ in rt.eng.slab_ledger})
    per_epoch = Counter(e for e, _ in rt.eng.slab_ledger)
    assert all(per_epoch[e] == per_epoch[epochs[0]] for e in epochs)
    assert rt.stats.slabs_discarded == ev.slabs_discarded
    _assert_full_equals_jax(rt.eng, jeng)


def test_case2_restores_block_from_physical_secondary():
    """Killing the full-replica holder (node 0): FALLBACK_DIST_CC.  Node
    0's primary block is scribbled and must come back from the PHYSICAL
    secondary copy node 1 hosts."""
    cfg = _ycsb()
    inj = FaultInjector()
    inj.schedule_kill(0, epoch=3)
    rt = ClusterRuntime(4, 8, 128, injector=inj, device="cpu")
    jeng = _jstar(8, 128)
    events = []
    for ep in range(5):
        b = ycsb.make_batch(cfg, 128, seed=10 + ep)
        m = rt.run_epoch(copy.deepcopy(b))
        jeng.run_epoch(b)
        assert rt.replica_consistent(), ep
        if "recovery" in m:
            events.append(m["recovery"])
    [ev] = events
    assert ev.case is RecoveryCase.FALLBACK_DIST_CC, ev
    assert ev.run_mode == "dist_cc"
    assert ev.restored_from_secondary == (0,), ev
    _assert_full_equals_jax(rt.eng, jeng)


def test_full_mix_wal_index_crash_recovery_bit_equal(tmp_path):
    """UNAVAILABLE under the full TPC-C mix: recover from the per-node WAL
    + checkpoint (records AND ordered index-op streams), bit-equal to the
    JAX StarEngine fed the same batches at every fence."""
    cfg, s1, init1 = _tpcc(TPCC4)
    inj = FaultInjector()
    for n in (0, 1, 2):
        inj.schedule_kill(n, epoch=4)
    jeng = _jstar(4, cfg.rows_per_partition, init1, cfg)
    dur = Durability(str(tmp_path), n_workers=4, checkpoint_every=2)
    rt = ClusterRuntime(4, 4, cfg.rows_per_partition, init_val=init1,
                        indexes=tpcc.index_specs(cfg), injector=inj,
                        durability=dur, device="cpu")
    events = []
    for ep in range(6):
        b = tpcc.make_batch(cfg, s1, 160, seed=ep)
        m = rt.run_epoch(copy.deepcopy(b))
        jeng.run_epoch(b)
        assert rt.replica_consistent(), ep
        _assert_full_equals_jax(rt.eng, jeng, ep)
        if "recovery" in m:
            events.append(m["recovery"])
    [ev] = events
    assert ev.case is RecoveryCase.UNAVAILABLE, ev
    assert ev.reloaded_from_disk and ev.run_mode == "halt"
    assert dur.checkpoints >= 1 and dur.entries_logged > 0
    dur.close()


# ---------------------------------------------------------------------------
# tests/test_cluster_router.py's cluster tests, test_multidevice's
# partitioned phase
# ---------------------------------------------------------------------------
def test_cluster_engine_8dev_matches_single_process():
    cfg = ycsb.YCSBConfig(n_partitions=8, records_per_partition=256)
    eng_c = ClusterStarEngine(8, 8, 256, device="cpu")
    eng_s = _jstar(8, 256)
    for ep in range(2):
        batch = ycsb.make_batch(cfg, 192, seed=ep)
        mc = eng_c.run_epoch(copy.deepcopy(batch))
        ms = eng_s.run_epoch(batch)
        assert mc["committed_single"] == ms["committed_single"], (mc, ms)
        assert mc["committed_cross"] == ms["committed_cross"], (mc, ms)
    assert eng_c.consistent(), "partial vs full replica mismatch"
    _assert_full_equals_jax(eng_c, eng_s)


@pytest.mark.parametrize("name", ["ycsb", "tpcc"])
def test_partitioned_phase_zero_collectives_8dev(name):
    """The §4.1 claim, checked on data: every row and index key node n's
    partitioned log writes lies in node n's block."""
    if name == "ycsb":
        cfg = _ycsb(8, 128)
        eng = ClusterStarEngine(8, 8, 128, device="cpu")
        batch = ycsb.make_batch(cfg, 128, seed=0)
    else:
        cfg, st, init = _tpcc(TPCC8)
        eng = ClusterStarEngine(4, 8, cfg.rows_per_partition, init_val=init,
                                indexes=tpcc.index_specs(cfg), device="cpu")
        batch = tpcc.make_batch(cfg, st, 96, seed=0)
    before = eng.part_val.clone()
    assert eng.partitioned_phase_has_no_collectives(batch)
    assert torch.equal(eng.part_val, before)          # a dry run
    # a log that writes a foreign block breaks the claim
    if name == "tpcc":
        # an index insert of the first slab re-keyed into another node's
        # partition: its log writes a foreign block
        from repro_torch.core.ops import INSERT_IDX, IX_KEY
        from repro_torch.storage.index import PART_SHIFT
        bad = copy.deepcopy(batch)
        pt = bad["ptxn"]
        first = eng._slab_bounds(
            StarEngine._pad_axis(pt, 1)["row"].shape[1])[1]
        hits = np.argwhere(pt["valid"][:, :first, None]
                           & (pt["kind"][:, :first] == INSERT_IDX))
        assert hits.size, "no index insert in the first slab"
        p, t, k = hits[0]
        key = int(pt["delta"][p, t, k, IX_KEY])
        foreign = (p + eng.ppn) % eng.P
        pt["delta"][p, t, k, IX_KEY] = \
            (foreign << PART_SHIFT) | (key & ((1 << PART_SHIFT) - 1))
        assert not eng.partitioned_phase_has_no_collectives(bad)


@pytest.mark.parametrize("n_nodes", [2, 4, 8])
def test_partitioned_phase_one_call_equals_one_run_per_node_block(n_nodes):
    """The counterpart of test_star_partitioned_phase_shard_map_8dev: the
    one call over all partitions equals one run per node block with that
    block's global ``part_ids`` (what each device of the reference's
    shard_map runs), records, logs and indexes."""
    cfg, st, init = _tpcc(TPCC8)
    batch = tpcc.make_batch(cfg, st, 96, seed=1)
    ptxn = {k: torch.as_tensor(v) for k, v in
            StarEngine._pad_axis(batch["ptxn"], 1).items()}
    eng = ClusterStarEngine(n_nodes, 8, cfg.rows_per_partition,
                            init_val=init, indexes=tpcc.index_specs(cfg),
                            device="cpu")
    v1, t1, o1, _ = run_partitioned(eng.part_val, eng.part_tid, ptxn, 1,
                                    index=eng.part_idx)
    ppn = eng.ppn
    for n in range(n_nodes):
        sl = eng.node_slice(n)
        v2, t2, o2, _ = run_partitioned(
            eng.part_val[sl], eng.part_tid[sl],
            {k: v[sl] for k, v in ptxn.items()}, 1,
            index=[{k: a[sl] for k, a in ix.items()} for ix in eng.part_idx],
            part_ids=torch.arange(n * ppn, (n + 1) * ppn, dtype=torch.int32))
        assert torch.equal(v1[sl], v2) and torch.equal(t1[sl], t2)
        for k in o2["log"]:
            assert torch.equal(o1["log"][k][sl], o2["log"][k]), k
        assert torch.equal(o1["committed"][sl], o2["committed"])
        for a, b in zip(o1["index"], o2["index"]):
            assert all(torch.equal(a[k][sl], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the cluster MV property (tests/test_changelog.py) and read property
# (tests/test_reads.py) across a mid-stream case-2 kill
# ---------------------------------------------------------------------------
def _case2_runtime():
    cfg, state, init = _tpcc(TPCC8, seed=0)
    inj = FaultInjector()
    inj.schedule_kill(0, epoch=3, slab=1)      # full holder, mid-stream
    rt = ClusterRuntime(4, 8, cfg.rows_per_partition, init_val=init,
                        indexes=tpcc.index_specs(cfg), injector=inj,
                        device="cpu")
    return cfg, state, init, rt


def test_cluster_mv_bit_equal_across_midstream_kill_case2():
    cfg, state, init, rt = _case2_runtime()
    jeng = _jstar(8, cfg.rows_per_partition, init, cfg)
    lane = AnalyticsLane(cfg, stock_threshold=40, retain=4)
    assert lane.ensure_attached(rt)
    views = lane.views
    oracle = {rt.committed_epoch: views.recompute(rt.committed_state()[0])}
    events = []
    for ep in range(6):
        batch = tpcc.make_batch(cfg, state, 96, seed=ep)
        jb = copy.deepcopy(batch)
        m = rt.run_epoch(batch)
        jeng.run_epoch(jb)
        tpcc.apply_consume_feedback(state, batch, m)
        if "recovery" in m:
            events.append(m["recovery"])
        out = lane.serve(rt.committed_epoch)
        epoch, aggs = views.latest()
        assert epoch == rt.committed_epoch, (epoch, rt.committed_epoch)
        want = views.recompute(rt.committed_state()[0])
        for k in ("revenue", "stock_low", "undelivered", "order_latency"):
            assert np.array_equal(aggs[k], want[k]), (ep, k)
        oracle[epoch] = {k: v.copy() for k, v in want.items()}
        assert out["epoch"] == epoch
        assert out["stock_low"]["total"] == int(want["stock_low"].sum())
        assert out["undelivered"]["total"] == int(want["undelivered"].sum())
        assert out["top_revenue"][0][2] == int(want["revenue"].max())
        assert rt.replica_consistent(), ep
        _assert_full_equals_jax(rt.eng, jeng, ep)
    for e in views.retained_epochs():
        tt = views.time_travel(e)
        for k, v in oracle[e].items():
            assert np.array_equal(tt[k], v), (e, k)
    [ev] = events
    assert ev.case is RecoveryCase.FALLBACK_DIST_CC, ev
    assert ev.aborted_at_slab == 1, ev
    assert views.reverts == 1
    assert views.slabs_applied > views.commits
    s = lane.summary()
    assert s["analytics_serves"] == 6
    assert s["analytics_max_epoch_lag"] == 0


def test_cluster_read_property_across_midstream_kill_case2():
    """The killed node's hosted secondary AND the full copy leave the
    catalog until recovery re-materializes them; every read served stays
    bit-equal to a committed fence within the bound.  The secondary views
    of one fence share one copy in the catalog."""
    cfg, state, init, rt = _case2_runtime()
    jeng = _jstar(8, cfg.rows_per_partition, init, cfg)
    tier = ReadTier(max_staleness_epochs=2, sec_refresh_every=2)
    tier.observe_epoch(rt)
    sec = [e.snaps[-1][1]["val"] for r, e in tier.catalog.entries.items()
           if r.startswith("sec")]
    assert len(sec) == 4 and all(v is sec[0] for v in sec)
    recorded, events = {}, []

    def record():
        for v in rt.read_views():
            recorded[(v["id"], int(v["epoch"]))] = {
                "val": v["val"].clone(), "tid": v["tid"].clone(),
                "idx": [{k: ix[k].clone() for k in ("key", "prow", "tid")}
                        for ix in (v.get("idx") or [])]}

    record()
    served = 0
    for ep in range(6):
        raw = tpcc.make_raw(cfg, state, 96, np.random.default_rng(ep))
        batch = tpcc.make_batch(cfg, state, 0, raw=raw)
        jb = copy.deepcopy(batch)
        m = rt.run_epoch(batch)
        jeng.run_epoch(jb)
        tpcc.apply_consume_feedback(state, batch, m)
        if "recovery" in m:
            events.append(m["recovery"])
        tier.observe_epoch(rt, m)
        record()
        _assert_full_equals_jax(rt.eng, jeng, ep)
        sel = np.nonzero(raw["read_only"])[0]
        if not sel.size:
            continue
        adm = AdmissionController(8, cfg.rows_per_partition,
                                  max_ops=raw["rows"].shape[1],
                                  n_cols=raw["deltas"].shape[2],
                                  read_lane=True)
        n = sel.size
        req = {k: raw[k][sel] for k in ("parts", "rows", "kinds", "deltas",
                                        "user_abort", "home", "read_only")}
        req.update(txn_id=np.arange(n, dtype=np.int64),
                   tenant=np.zeros(n, np.int32), arrival_s=np.zeros(n))
        assert not adm.offer(req, 0.0).any()
        results = tier.serve(adm)
        pool = adm.pool
        cur = tier.catalog.current_epoch
        for r in results:
            assert 0 <= r["freshness"] <= 2, r
            assert r["freshness"] == cur - r["epoch"]
            ent = tier.catalog.entries[r["replica"]]
            arow = ent.row_of_partition[pool.home[r["slots"]]
                                        .astype(np.int64)]
            exp = reference_read(
                {k: (v.numpy() if k != "idx" else
                     [{f: t.numpy() for f, t in ix.items()} for ix in v])
                 for k, v in recorded[(r["replica"], r["epoch"])].items()},
                arow, pool.row[r["slots"]], pool.kind[r["slots"]],
                pool.delta[r["slots"]])
            for key, want in exp.items():
                assert np.array_equal(r["out"][key].numpy(), want), \
                    (r["replica"], r["epoch"], key)
            served += int(r["slots"].size)
        assert rt.replica_consistent(), ep
    [ev] = events
    assert ev.case is RecoveryCase.FALLBACK_DIST_CC, ev
    assert ev.aborted_at_slab == 1, ev
    assert tier.stats.replicas_removed >= 2
    assert "full" in tier.catalog.entries
    assert "sec0" in tier.catalog.entries
    assert tier.stats.stale_violations == 0
    assert tier.stats.served > 0 and served == tier.stats.served


# ---------------------------------------------------------------------------
# tests/test_obs.py::test_recovery_span_tree_exported
# ---------------------------------------------------------------------------
def test_recovery_span_tree_exported():
    tracer = Tracer(enabled=True)
    old = set_tracer(tracer)
    try:
        n = 2
        inj = FaultInjector()
        inj.schedule_kill(node=1, epoch=1)
        P = 2 * n
        cfg = ycsb.YCSBConfig(n_partitions=P, records_per_partition=64)
        rt = ClusterRuntime(n, P, 64, injector=inj, device="cpu")
        for ep in range(3):
            rt.run_epoch(ycsb.make_batch(cfg, 64, seed=ep))
        assert rt.replica_consistent()
        evs = json.loads(json.dumps(tracer.to_chrome()))["traceEvents"]
    finally:
        set_tracer(old)
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    for want in ("recovery", "recovery.classify", "recovery.revert",
                 "recovery.restore", "recovery.remaster",
                 "recovery.reexecute"):
        assert want in spans, (want, sorted(spans))
    root = spans["recovery"]
    eps = 1e-3
    for child in ("recovery.classify", "recovery.revert",
                  "recovery.restore", "recovery.remaster",
                  "recovery.reexecute"):
        c = spans[child]
        assert c["tid"] == root["tid"]
        assert c["ts"] >= root["ts"] - eps
        assert c["ts"] + c["dur"] <= root["ts"] + root["dur"] + eps
    assert root["args"]["case"] == "PHASE_SWITCHING"


# ---------------------------------------------------------------------------
# pure-Python modules against the JAX package, in-process
# ---------------------------------------------------------------------------
def _jcfg(cfg):
    return jfault.ClusterConfig(f=cfg.f, k=cfg.k,
                                n_partitions=cfg.n_partitions,
                                replicas_per_partition=cfg
                                .replicas_per_partition, ppn=cfg.ppn)


@pytest.mark.parametrize("kills", [(2,), (0,), (0, 1, 2), (1, 3), (3,)])
def test_coordinator_matches_jax(kills):
    cfg = fault.ClusterConfig(f=1, k=4, n_partitions=8,
                              replicas_per_partition=2, ppn=2)
    c = Coordinator(cfg, PhaseController())
    j = JCoordinator(_jcfg(cfg), JController())
    plan, jplan = c.fence_missed(3, set(kills)), j.fence_missed(3, set(kills))
    assert plan.case.name == jplan.case.name
    assert (plan.run_mode, plan.revert_to_epoch, plan.remaster,
            plan.copy_sources) == (jplan.run_mode, jplan.revert_to_epoch,
                                   jplan.remaster, jplan.copy_sources)
    assert (c.view, c.alive, c.master_of) == (j.view, j.alive, j.master_of)
    failed = set(range(4)) - c.alive
    assert c.lost_blocks(failed) == j.lost_blocks(failed)
    c.recovered("ev", set(kills))
    j.recovered("ev", set(kills))
    assert (c.view, c.alive, c.master_of, c.events) == \
        (j.view, j.alive, j.master_of, j.events)


def test_fault_injector_matches_jax():
    a, b = FaultInjector(), jfault.FaultInjector()
    for inj in (a, b):
        inj.schedule_kill(1, epoch=2)
        inj.schedule_kill(3, epoch=2, slab=1)
        inj.schedule_kill(0, epoch=4, slab=0)
        inj.schedule_kill(1, epoch=4)
    for e in range(1, 6):
        assert a.slab_kills(e) == b.slab_kills(e)
        assert a.poll(e) == b.poll(e)
        assert (a.killed, a.kills_injected) == (b.killed, b.kills_injected)
        if e == 2:
            a.revive([1])
            b.revive([1])
    assert a.schedule == b.schedule and a.slab_schedule == b.slab_schedule


def test_catch_up_matches_jax():
    rng = np.random.default_rng(4)
    N, C, K = 64, 10, 96
    val = rng.integers(-9, 9, (N, C)).astype(np.int32)
    tid = rng.integers(0, 50, N).astype(np.uint32)
    log = {"row": rng.integers(-1, N, K).astype(np.int32),
           "val": rng.integers(-9, 9, (K, C)).astype(np.int32),
           "tid": rng.integers(0, 80, K).astype(np.uint32)}
    jv, jt = jfault.catch_up(val, tid, log, jthomas_apply)[:2]
    tv, tt = fault.catch_up(
        torch.tensor(val), torch.tensor(tid.astype(np.int64)),
        {k: torch.tensor(v.astype(np.int64) if k == "tid" else v)
         for k, v in log.items()}, thomas_apply)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))


def test_runtime_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterRuntime(2, 4, 16)
