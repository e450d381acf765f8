"""PyTorch port vs JAX reference: the online transaction service.

The numpy modules (admission, batcher, clients, latency, the metrics
registry) are held against the JAX package's on scripted arrival times:
the same pool state, batch arrays, plans, stats and percentiles
(tolerance 0).  The reference's service invariants (tests/test_service.py)
run on the port's ``TxnService`` over a CPU ``StarEngine``; a
record-and-replay test feeds every batch the port's service formed to the
JAX engine and holds the state bit-equal after each epoch.  Small sizes:
P <= 4, <= 256 records a partition, runs of <= 0.4 s.
"""
import copy
import dataclasses
import json

import numpy as np
import pytest

from repro.core.engine import StarEngine as JEngine
from repro.db import ycsb as jycsb
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.service import admission as jadm
from repro.service import batcher as jbat
from repro.service import clients as jcli
from repro.service import latency as jlat
from repro.service import TxnService as JService
from repro_torch.convert import to_numpy_state
from repro_torch.core.engine import StarEngine
from repro_torch.db import tpcc, ycsb
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.service import (BACKPRESSURE, AdmissionConfig,
                                 AdmissionController, ClosedLoopClient,
                                 LatencyRecorder, OpenLoopClient, TPCCSource,
                                 TxnService, YCSBSource)
from repro_torch.service import admission as tadm
from repro_torch.service import batcher as tbat
from repro_torch.service import clients as tcli
from repro_torch.service import latency as tlat
from repro_torch.service.batcher import EpochBatcher
from repro_torch.service.latency import COMMITTED, USER_ABORTED
from repro_torch.storage.index import SENTINEL


def _eq(a, b, path="out"):
    """Bit-exact comparison of two trees of numpy arrays / scalars."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (bool, int, float, str, np.integer,
                                     np.floating)):
        assert a == b or (a != a and b != b), (path, a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


def _pool(pool):
    return {k: getattr(pool, k) for k in (
        "row", "kind", "delta", "user_abort", "is_cross", "home", "tenant",
        "txn_id", "arrival_s", "admit_s", "form_s", "capacity", "live",
        "_free")}


def _adm_state(adm):
    return {"pool": _pool(adm.pool),
            "stats": dataclasses.asdict(adm.stats),
            "router": dataclasses.asdict(adm.router.stats),
            "parts": [list(q) for q in adm.part_queues],
            "master": list(adm.master_queue), "depth": adm.depth()}


# ---------------------------------------------------------------------------
# the numpy service modules against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["shed", BACKPRESSURE])
def test_admission_and_batcher_parity(policy):
    """Scripted arrival chunks through both admission controllers and
    batchers: caps small enough to reject, starved lanes re-queued at the
    front, slots released — pools, queues, stats, batches and plans
    equal at every step."""
    cfg = jycsb.YCSBConfig(n_partitions=4, records_per_partition=64,
                           cross_ratio=0.3)
    sides = []
    for adm_mod, bat_mod in ((jadm, jbat), (tadm, tbat)):
        adm = adm_mod.AdmissionController(
            4, 64, jycsb.M, jycsb.C,
            cfg=adm_mod.AdmissionConfig(6, 5, policy))
        sides.append((adm, bat_mod.EpochBatcher(
            adm, 4, 4, row_bytes=np.full(jycsb.M, 100, np.int32),
            op_bytes=np.full(jycsb.M, 100, np.int32))))
    rng = np.random.default_rng(3)
    t = 0.0
    for step in range(8):
        n = int(rng.integers(0, 40))
        req = jycsb.make_raw(cfg, n, rng)
        req["home"] = np.where(req.pop("declared_cross"), -1,
                               req["home"]).astype(np.int32)
        req["home"][:3] = np.where(req["home"][:3] < 0, 1,
                                   req["home"][:3])     # mis-declared
        req["txn_id"] = np.arange(n, dtype=np.int64) + 100 * step
        req["tenant"] = (np.arange(n) % 2).astype(np.int32)
        t += 0.01
        req["arrival_s"] = t - rng.random(n) * 0.01
        outs = []
        for adm, bat in sides:
            rej = adm.offer(copy.deepcopy(req), t)
            batch, plan = bat.form(t + 0.001)
            if plan.n_cross:
                adm.requeue_master_front(plan.c_idx[::2])
            adm.pool.release(plan.p_idx[plan.p_idx >= 0])
            outs.append((rej, batch, dataclasses.asdict(plan),
                         _adm_state(adm), adm.depths()))
        _eq(outs[0], outs[1], f"step{step}")
    assert sides[1][0].stats.offered > 0
    if policy == "shed":
        assert sides[1][0].stats.shed > 0
    else:
        assert sides[1][0].stats.backpressured > 0
    assert sides[1][0].router.stats.rerouted > 0


def _clients(mod, src_mod, process):
    cfg = src_mod.YCSBConfig(n_partitions=4, records_per_partition=64)
    open_c = mod.OpenLoopClient(mod.YCSBSource(cfg, seed=1), 2000.0,
                                process=process, seed=7, retry_cap=20)
    closed = mod.ClosedLoopClient(mod.YCSBSource(cfg, seed=2), 12,
                                  think_time_s=0.002, seed=3)
    return open_c, closed


@pytest.mark.parametrize("process", ["poisson", "uniform", "bursty"])
def test_clients_parity(process):
    """Open- and closed-loop clients pulled at the same scripted times,
    with push-backs, sheds and completions: the same requests."""
    jo, jc = _clients(jcli, jycsb, process)
    to_, tc = _clients(tcli, ycsb, process)
    for i, until in enumerate(np.linspace(0.0, 0.4, 25)):
        got = []
        for o, c in ((jo, jc), (to_, tc)):
            a, b = o.pull(until), c.pull(until)
            if a is not None and i % 3 == 0:
                o.push_back(tcli.slice_request(a, np.arange(a["parts"]
                                                            .shape[0]) < 60))
            if b is not None:
                c.on_complete(b["parts"].shape[0] // 2, until)
                c.on_shed(tcli.slice_request(b, np.arange(1)), until)
            got.append((a, b, o.dropped_retries, o.emitted, c.in_flight,
                        sorted(c._due)))
        _eq(got[0], got[1], f"pull{i}")
    assert to_.emitted > 0 and to_.dropped_retries > 0


def test_tpcc_source_parity():
    """The TPC-C source over the full mix: the same requests, and the same
    host mirror after shed requests are unwound."""
    kw = dict(n_partitions=2, n_items=200, cust_per_district=20,
              order_ring=64, mix="full", delivery_gen_lag=64)
    from repro.db import tpcc as jtpcc
    srcs = []
    for mod, cmod in ((jtpcc, jcli), (tpcc, tcli)):
        cfg = mod.TPCCConfig(**kw)
        state = mod.TPCCState(cfg)
        mod.init_values(cfg, np.random.default_rng(0), state=state)
        srcs.append((cmod.TPCCSource(cfg, state=state, seed=2), state))
    for i in range(4):
        reqs = [s.generate(48) for s, _ in srcs]
        _eq(reqs[0], reqs[1], f"gen{i}")
        for (s, _), r in zip(srcs, reqs):
            s.unclaim(tcli.slice_request(
                dict(r, tenant=np.zeros(48, np.int32),
                     txn_id=np.arange(48), arrival_s=np.zeros(48)),
                np.arange(48) % 5 == 0))
    (_, js), (_, ts) = srcs
    assert js.pending_claims == ts.pending_claims
    assert js.undelivered == ts.undelivered


def test_latency_recorder_parity_and_percentiles():
    rng = np.random.default_rng(0)
    recs = (jlat.LatencyRecorder(), tlat.LatencyRecorder())
    for _ in range(5):
        n = int(rng.integers(1, 300))
        arr = rng.random(n)
        cols = (rng.integers(0, 3, n).astype(np.int32), arr,
                arr + rng.random(n) * 0.01, arr + rng.random(n) * 0.02,
                arr + 0.05 + rng.random(n) * 0.1,
                np.where(rng.random(n) < 0.1, USER_ABORTED, COMMITTED))
        for r in recs:
            r.record(*cols)
            r.started_s, r.finished_s = 0.0, 1.5
    j, t = recs
    for tenant in (None, 0, 2):
        _eq(dataclasses.asdict(j.percentiles(tenant=tenant)),
            dataclasses.asdict(t.percentiles(tenant=tenant)))
        assert j.committed(tenant) == t.committed(tenant)
    _eq(dataclasses.asdict(j.percentiles("admit_s", "form_s")),
        dataclasses.asdict(t.percentiles("admit_s", "form_s")))
    assert j.throughput_txn_s() == t.throughput_txn_s()
    for last in (True, False):
        assert j.mean_queue_delay_ms(last) == t.mean_queue_delay_ms(last)
    # the reference's percentile test, on the port's recorder
    rec = LatencyRecorder()
    n = 1000
    arrival = np.zeros(n)
    commit = np.arange(1, n + 1) / 1000.0          # 1..1000 ms
    rec.record(np.zeros(n, np.int32), arrival, arrival, arrival, commit,
               np.full(n, COMMITTED, np.int32))
    p = rec.percentiles()
    assert p.n == n
    assert abs(p.p50_ms - 500.5) < 1.0
    assert abs(p.p99_ms - 990.01) < 1.0
    rec.record(np.zeros(1, np.int32), [0.0], [0.0], [0.0], [9.9],
               np.array([USER_ABORTED], np.int32))
    assert rec.percentiles().n == n


def test_registry_exporters_parity(tmp_path):
    """tests/test_obs.py's exporter test on both registries: equal
    snapshots, JSON lines and Prometheus text."""
    outs = []
    for i, reg in enumerate((JRegistry(), MetricsRegistry())):
        stats = dataclasses.make_dataclass("S", [("n", int), ("x", float),
                                                 ("f", bool)])(5, 0.5, True)
        reg.register_object("obj", stats)
        reg.register_provider("prov", lambda: {"a": 1, "nan": float("nan"),
                                               "s": "text"})
        reg.counter_add("a.count", 3)
        reg.gauge_set("a.gauge", 1.5)
        reg.hist_observe("a.lat_s", 0.004)
        reg.hist_observe("a.lat_s", 0.3)
        reg.snapshot(0)
        reg.counter_add("a.count", 1)
        stats.n = 9
        reg.snapshot(1)
        p = tmp_path / f"m{i}.jsonl"
        n = reg.export_jsonl(str(p))
        outs.append((n, p.read_text(), reg.export_prometheus(),
                     reg.snapshots, reg.latest()))
    _eq(outs[0], outs[1])
    n, text, prom, _, _ = outs[1]
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert n == len(lines) == 2
    assert lines[0]["a.count"] == 3 and lines[1]["a.count"] == 4
    assert lines[1]["epoch"] == 1 and lines[1]["obj.n"] == 9
    assert "# TYPE a_count gauge" in prom
    assert 'a_lat_s_bucket{le="+Inf"} 2' in prom
    assert "a_lat_s_count 2" in prom


# ---------------------------------------------------------------------------
# the service end to end on the port's engine (tests/test_service.py)
# ---------------------------------------------------------------------------
def _ycsb_service(rate=2000.0, policy="shed", part_cap=256, master_cap=512,
                  slots=16, lanes=16, process="poisson", cross=0.1):
    cfg = ycsb.YCSBConfig(n_partitions=4, records_per_partition=256,
                          cross_ratio=cross)
    eng = StarEngine(4, 256, device="cpu")
    client = OpenLoopClient(YCSBSource(cfg, seed=1), rate_txn_s=rate,
                            process=process, seed=7)
    svc = TxnService(eng, [client],
                     AdmissionConfig(part_cap, master_cap, policy),
                     slots_per_partition=slots, master_lanes=lanes)
    return svc, eng, client


def test_open_loop_end_to_end():
    svc, eng, client = _ycsb_service(rate=1500.0)
    out = svc.run(duration_s=0.4)
    assert out["epochs"] > 0 and out["committed"] > 0
    assert out["throughput_txn_s"] > 0
    assert 0 < out["p50_ms"] <= out["p99_ms"] <= out["p999_ms"] < 1e5
    assert svc.admission.depth() == 0
    assert out["offered"] == out["committed"] + out["user_aborted"] \
        + out["shed"]
    assert eng.replica_consistent()


@pytest.mark.parametrize("lane", ["read_tier", "analytics"])
def test_service_lane_runs(lane):
    """Each lane through the service on the CPU port engine over TPC-C's
    full mix: it serves, and the service's summary carries the lane's
    summary keys, which are the JAX lane's."""
    from repro.changelog import AnalyticsLane as JLane
    from repro.reads import ReadTier as JTier
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.reads import ReadTier
    cfg, state, eng = _tpcc("full")
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=3000.0)
    obj = (ReadTier(max_staleness_epochs=1) if lane == "read_tier"
           else AnalyticsLane(cfg))
    ref = (JTier(max_staleness_epochs=1) if lane == "read_tier"
           else JLane(cfg))
    svc = TxnService(eng, [client], AdmissionConfig(256, 256),
                     slots_per_partition=8, master_lanes=8,
                     feedback=lambda b, m:
                     tpcc.apply_consume_feedback(state, b, m),
                     **{lane: obj})
    out = svc.run(duration_s=30.0, max_epochs=4)
    assert out["epochs"] == 4 and out["committed"] > 0
    assert set(ref.summary()) <= set(out)
    assert set(obj.summary()) == set(ref.summary())
    if lane == "read_tier":
        assert out["read_served"] > 0 and out["read_stale_violations"] == 0
        assert {"write_committed", "write_txn_s", "combined_txn_s"} <= set(out)
    else:
        assert out["analytics_serves"] == 4 and out["analytics_mv_slabs"] > 0
    assert eng.replica_consistent()


def test_overload_sheds_not_unbounded():
    svc, eng, _ = _ycsb_service(rate=100_000.0, part_cap=32, master_cap=64,
                                slots=8, lanes=8)
    out = svc.run(duration_s=0.4)
    assert out["shed"] > 0
    assert out["max_part_depth"] <= 32
    assert out["max_master_depth"] <= 64
    assert out["committed"] > 0
    assert eng.replica_consistent()


def test_backpressure_defers_instead_of_shedding():
    svc, eng, client = _ycsb_service(rate=50_000.0, policy=BACKPRESSURE,
                                     part_cap=32, master_cap=64,
                                     slots=8, lanes=8)
    out = svc.run(duration_s=0.3)
    assert out["shed"] == 0
    assert out["backpressured"] > 0
    assert out["max_part_depth"] <= 32 and out["max_master_depth"] <= 64
    retry_n = 0 if client.retry is None else client.retry["parts"].shape[0]
    assert retry_n <= client.retry_cap
    assert eng.replica_consistent()


def test_closed_loop_bounds_in_flight():
    """A reissue waits for its predecessor's fence, so generations are
    counted in epochs: the run stops after 8 epochs, not after a stretch
    of wall clock that a loaded host may fill with one epoch."""
    cfg = ycsb.YCSBConfig(n_partitions=4, records_per_partition=256)
    eng = StarEngine(4, 256, device="cpu")
    client = ClosedLoopClient(YCSBSource(cfg, seed=3), n_outstanding=24,
                              tenant=5)
    svc = TxnService(eng, [client], AdmissionConfig(64, 64),
                     slots_per_partition=16, master_lanes=16)
    out = svc.run(duration_s=30.0, max_epochs=8)
    assert out["epochs"] == 8
    assert out["committed"] > 24
    assert client.in_flight + len(client._due) == 24
    assert svc.recorder.committed(tenant=5) == out["committed"]


def test_closed_loop_slots_survive_shedding():
    cfg = ycsb.YCSBConfig(n_partitions=2, records_per_partition=128)
    eng = StarEngine(2, 128, device="cpu")
    client = ClosedLoopClient(YCSBSource(cfg, seed=4), n_outstanding=48,
                              tenant=3)
    svc = TxnService(eng, [client], AdmissionConfig(4, 4),
                     slots_per_partition=4, master_lanes=4)
    out = svc.run(duration_s=0.4)
    assert out["shed"] > 0
    assert out["committed"] > 0
    assert client.in_flight + len(client._due) == 48


def test_multi_tenant_mix():
    cfg = ycsb.YCSBConfig(n_partitions=4, records_per_partition=256)
    eng = StarEngine(4, 256, device="cpu")
    c0 = OpenLoopClient(YCSBSource(cfg, seed=1), 600.0, tenant=0, seed=1)
    c1 = OpenLoopClient(YCSBSource(cfg, seed=2), 300.0, tenant=1, seed=2,
                        process="bursty")
    svc = TxnService(eng, [c0, c1], AdmissionConfig(256, 256),
                     slots_per_partition=16, master_lanes=16)
    svc.run(duration_s=0.4)
    p0 = svc.recorder.percentiles(tenant=0)
    p1 = svc.recorder.percentiles(tenant=1)
    assert p0.n > 0 and p1.n > 0
    assert p0.n + p1.n == svc.recorder.committed()


def _tpcc(mix="new_order_payment"):
    kw = dict(n_partitions=2, n_items=200, cust_per_district=20,
              order_ring=64)
    if mix == "full":
        kw.update(mix="full", delivery_gen_lag=64)
    cfg = tpcc.TPCCConfig(**kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(0), state=state)
    eng = StarEngine(2, cfg.rows_per_partition, init_val=init,
                     indexes=tpcc.index_specs(cfg) if mix == "full"
                     else None, device="cpu")
    return cfg, state, eng


def test_tpcc_open_loop():
    cfg, state, eng = _tpcc()
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=400.0)
    svc = TxnService(eng, [client], AdmissionConfig(64, 64),
                     slots_per_partition=8, master_lanes=8)
    out = svc.run(duration_s=0.4)
    assert out["committed"] > 0
    assert eng.replica_consistent()


def test_tpcc_full_mix_through_service():
    """The five-transaction mix served online with the consume feedback:
    records and indexes of the replica bit-equal, the orders index
    maintained, and the registry's last snapshot equal to every numeric
    field of the stats dataclasses (tests/test_obs.py:145)."""
    cfg, state, eng = _tpcc("full")
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=400.0)
    svc = TxnService(eng, [client], AdmissionConfig(64, 64),
                     slots_per_partition=8, master_lanes=8,
                     feedback=lambda b, m:
                     tpcc.apply_consume_feedback(state, b, m))

    def live_entries():
        return int((eng.store.indexes[tpcc.OID_IDX]["key"]
                    != SENTINEL).sum())

    out = svc.run(duration_s=0.4)
    for _ in range(3):
        if live_entries() > 0:
            break
        out = svc.run(duration_s=0.4, warmup_epochs=0)
    assert out["committed"] > 0
    assert eng.replica_consistent()
    assert live_entries() > 0, "NewOrders maintained the orders index online"
    snaps = svc.metrics.snapshots
    assert len(snaps) == svc.stats.epochs
    last = snaps[-1]
    for prefix, obj in (("engine", eng.stats), ("service", svc.stats),
                        ("admission", svc.admission.stats)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (int, float)):
                assert last[f"{prefix}.{f.name}"] == v, f.name
    assert any(k.startswith("kernels.scan_window") for k in last)
    assert any(k.startswith("kernels.occ_round") for k in last)
    ep = [s["engine.epochs"] for s in snaps]
    assert ep == sorted(ep)


def test_registry_names_the_reference_keys():
    """A registry over the port's service names the same engine, service
    and admission keys as one over the reference's."""
    def keys(svc):
        return {k for k in svc.metrics.values()
                if not k.startswith("kernels.")}
    jcfg = jycsb.YCSBConfig(n_partitions=2, records_per_partition=32)
    jsvc = JService(JEngine(2, 32), [jcli.OpenLoopClient(
        jcli.YCSBSource(jcfg), 100.0)])
    svc, _, _ = _ycsb_service()
    assert keys(svc) == keys(jsvc)
    assert "kernels" in [p for p, _ in svc.metrics._providers]


def test_shed_neworders_unwound_mirror_matches_device():
    cfg, state, eng = _tpcc("full")
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=3),
                            rate_txn_s=6000.0)
    svc = TxnService(eng, [client],
                     AdmissionConfig(part_queue_cap=8, master_queue_cap=8,
                                     policy="shed"),
                     slots_per_partition=8, master_lanes=8,
                     feedback=lambda b, m:
                     tpcc.apply_consume_feedback(state, b, m))
    out = svc.run(duration_s=0.4)
    client.shutdown()
    assert out["shed"] > 0, "burst did not overload admission"
    assert out["committed"] > 0
    assert eng.replica_consistent()
    assert not state.pending_claims, state.pending_claims
    lo_mask = (1 << tpcc.D_SHIFT) - 1
    for w in range(cfg.n_partitions):
        seg = eng.store.indexes[tpcc.NO_IDX]["key"][w].numpy()
        for d in range(tpcc.N_DIST):
            mirror = sorted(tpcc._key_no(w, d, o % (lo_mask + 1))
                            for o, _, _, _, _ in state.undelivered[w][d])
            dev = sorted(int(k) for k in seg
                         if k != SENTINEL
                         and tpcc._key_no(w, d, 0) <= k
                         < tpcc._key_no(w, d + 1, 0))
            assert mirror == dev, (w, d, mirror, dev)


def test_batcher_fixed_shapes_and_fifo():
    adm = AdmissionController(2, 64, max_ops=2, n_cols=3,
                              cfg=AdmissionConfig(64, 64))
    n = 12
    rng = np.random.default_rng(0)
    home = rng.integers(0, 2, n).astype(np.int32)
    req = {"parts": np.repeat(home[:, None], 2, 1),
           "rows": rng.integers(0, 64, (n, 2)).astype(np.int32),
           "kinds": np.zeros((n, 2), np.int32),
           "deltas": np.zeros((n, 2, 3), np.int32),
           "user_abort": np.zeros(n, bool),
           "home": np.full(n, -1, np.int32),
           "txn_id": np.arange(n, dtype=np.int64),
           "tenant": np.zeros(n, np.int32),
           "arrival_s": np.zeros(n)}
    adm.offer(req, 0.0)
    b = EpochBatcher(adm, slots_per_partition=4, master_lanes=4)
    batch1, plan1 = b.form(1.0)
    assert batch1["ptxn"]["row"].shape == (2, 4, 2)
    assert batch1["cross"]["row"].shape == (4, 2)
    assert not batch1["cross"]["valid"].any()
    first_ids = adm.pool.txn_id[plan1.p_idx[plan1.p_idx >= 0]]
    batch2, plan2 = b.form(2.0)
    second_ids = adm.pool.txn_id[plan2.p_idx[plan2.p_idx >= 0]]
    for p in range(2):
        mine = np.sort(np.nonzero(home == p)[0])
        got = np.sort(np.concatenate(
            [adm.pool.txn_id[plan.p_idx[p][plan.p_idx[p] >= 0]]
             for plan in (plan1, plan2)]))
        assert np.array_equal(got, mine)
    assert plan1.total + plan2.total == n
    assert set(first_ids).isdisjoint(second_ids)
    assert (adm.pool.form_s[plan1.p_idx[plan1.p_idx >= 0]] == 1.0).all()


def test_engine_ingest_hook_and_commit_stamps():
    cfg = ycsb.YCSBConfig(n_partitions=2, records_per_partition=128)
    eng = StarEngine(2, 128, device="cpu")
    called = []
    m = eng.run_epoch(ycsb.make_batch(cfg, 64, seed=0),
                      ingest=lambda: called.append(1))
    assert called == [1]
    assert m["t_fence1_s"] <= m["t_fence2_s"]
    assert m["t_ingest_s"] >= 0
    assert m["t_part_s"] >= 0
    assert int(m["p_committed"].sum()) == m["committed_single"]
    assert int(m["c_committed"].sum()) == m["committed_cross"]


def test_controller_receives_measured_latency():
    svc, eng, _ = _ycsb_service(rate=800.0)
    svc.run(duration_s=0.4)
    ctl = eng.controller
    assert ctl.measured_commit_ms > 0
    assert ctl.queue_delay_ms > 0
    assert ctl.expected_mean_latency_ms() == ctl.measured_commit_ms


# ---------------------------------------------------------------------------
# record and replay: the service's batches through the JAX engine
# ---------------------------------------------------------------------------
def test_service_record_and_replay_parity():
    """Every batch the port's service formed (warm-up included), replayed
    through the JAX ``StarEngine``: master and replica bit-equal after each
    epoch, equal commit masks, and the service's committed requests equal
    to the masks' count."""
    svc, eng, _ = _ycsb_service(rate=3000.0, cross=0.2)
    record = []
    run = eng.run_epoch

    def recording(batch, ingest=None):
        b = copy.deepcopy(batch)
        m = run(batch, ingest=ingest)
        record.append((b, m, to_numpy_state(eng.store),
                       to_numpy_state(eng.replica_store)))
        return m
    eng.run_epoch = recording
    out = svc.run(duration_s=0.4)
    assert out["committed"] > 0 and len(record) > 2
    je = JEngine(4, 256)
    n_masks = 0
    for i, (b, m, master, replica) in enumerate(record):
        jm = je.run_epoch(b)
        for name, st in (("store", master), ("replica_store", replica)):
            js = getattr(je, name)
            assert np.array_equal(np.asarray(js.val), st["val"]), (i, name)
            assert np.array_equal(np.asarray(js.tid), st["tid"]), (i, name)
        for k in ("p_committed", "c_committed"):
            assert np.array_equal(np.asarray(jm[k]), m[k]), (i, k)
        n_masks += int(m["p_committed"].sum() + m["c_committed"].sum())
    assert out["user_aborted"] == 0 and n_masks == out["committed"]
    assert svc.stats.epochs + 2 == len(record)       # 2 warm-up epochs
