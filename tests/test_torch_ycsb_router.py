"""PyTorch port vs JAX reference: the YCSB generator, the router, the
engine's knobs on YCSB, and the phase controller (tolerance 0: every value
is an integer, and the controller's floats follow the same arithmetic).

Small sizes: P = 4, 256 records a partition, 192 transactions an epoch;
every port object is built with ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest
from _torch_util import as_numpy

from repro.baselines.cost_model import Network as JNetwork
from repro.core import phase_switch as jps
from repro.core import router as jrouter
from repro.core.engine import StarEngine as JEngine
from repro.core.fault import ClusterConfig as JCluster
from repro.core.fault import classify_failure as jclassify
from repro.db import tpcc as jtpcc
from repro.db import ycsb as jycsb
from repro_torch.baselines.cost_model import Network as TNetwork
from repro_torch.convert import to_numpy_state
from repro_torch.core import phase_switch as tps
from repro_torch.core import router as trouter
from repro_torch.core.engine import StarEngine as TEngine
from repro_torch.core.fault import ClusterConfig as TCluster
from repro_torch.core.fault import RecoveryCase
from repro_torch.core.fault import classify_failure as tclassify
from repro_torch.core.ops import READ, SET
from repro_torch.db import tpcc as ttpcc
from repro_torch.db import ycsb as tycsb

P, R, N_TXNS = 4, 256, 192
SKEWS = {"uniform": {}, "zipf": {"zipf_theta": 0.9},
         "hot": {"hot_set_size": 16, "hot_access_frac": 0.8}}
TIMES = ("t_part_s", "t_sm_s", "t_sm_round_s", "t_ingest_s", "t_fence1_s",
         "t_fence2_s", "t_fence_net_s", "tau_p_ms", "tau_s_ms")


def _tree_equal(a, b, path="out"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (int, float, np.integer)):
        assert a == b, (path, a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


# ---------------------------------------------------------------------------
# the YCSB generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skew", sorted(SKEWS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ycsb_generator_parity(seed, skew):
    kw = dict(n_partitions=P, records_per_partition=R, **SKEWS[skew])
    jc, tc = jycsb.YCSBConfig(**kw), tycsb.YCSBConfig(**kw)
    _tree_equal(jycsb.make_raw(jc, 128, np.random.default_rng(seed)),
                tycsb.make_raw(tc, 128, np.random.default_rng(seed)))
    _tree_equal(jycsb.make_batch(jc, N_TXNS, seed=seed),
                tycsb.make_batch(tc, N_TXNS, seed=seed))
    assert (jycsb.C, jycsb.M, jycsb.ROW_BYTES) == \
        (tycsb.C, tycsb.M, tycsb.ROW_BYTES)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_routing_and_stats_parity(seed):
    rng = np.random.default_rng(seed)
    raw = jycsb.make_raw(jycsb.YCSBConfig(P, R, cross_ratio=0.3), 160, rng)
    declared = np.where(raw["declared_cross"], -1, raw["home"])
    # mis-declare a few cross transactions as singles (the re-route case)
    declared[:20] = raw["home"][:20]
    args = (raw["parts"], raw["rows"], raw["kinds"], raw["deltas"],
            raw["user_abort"])
    jr, tr = jrouter.Router(P, R, jycsb.M), trouter.Router(P, R, tycsb.M)
    for T in (None, 8):
        _tree_equal(jr.route(*args, declared_home=declared, T=T),
                    tr.route(*args, declared_home=declared, T=T))
    assert dataclasses.asdict(jr.stats) == dataclasses.asdict(tr.stats)
    assert tr.stats.rerouted > 0 and tr.stats.deferred_epochs > 0
    home = raw["home"]
    _tree_equal(jrouter.scatter_singles(P, 8, jycsb.M, jycsb.C, home,
                                        *args[1:]),
                trouter.scatter_singles(P, 8, tycsb.M, tycsb.C, home,
                                        *args[1:]))
    _tree_equal(jrouter.globalize_rows(raw["parts"], raw["rows"], R),
                trouter.globalize_rows(raw["parts"], raw["rows"], R))


def _mk_txn(parts_list, M=4, C=10):
    B = len(parts_list)
    parts = np.zeros((B, M), np.int32)
    rows = np.zeros((B, M), np.int32)
    kinds = np.full((B, M), READ, np.int32)
    deltas = np.zeros((B, M, C), np.int32)
    for i, ps in enumerate(parts_list):
        for j, p in enumerate(ps):
            parts[i, j] = p
            rows[i, j] = j
            kinds[i, j] = SET if j == 0 else READ
        parts[i, len(ps):] = ps[0]
    return parts, rows, kinds, deltas


def test_router_classifies_and_routes():
    r = trouter.Router(n_partitions=4, rows_per_partition=100, max_ops=4)
    parts, rows, kinds, deltas = _mk_txn(
        [[0, 0, 0], [1, 1], [2, 3], [0, 2, 3], [3, 3, 3]])
    batch = r.route(parts, rows, kinds, deltas)
    assert batch["n_single"] == 3 and batch["n_cross"] == 2
    assert r.stats.singles == 3 and r.stats.cross == 2
    assert (batch["cross"]["row"] // 100 == parts[[2, 3]]).all()
    assert batch["ptxn"]["valid"][0].sum() == 1
    assert batch["ptxn"]["valid"][1].sum() == 1
    assert batch["ptxn"]["valid"][3].sum() == 1


def test_router_reroute_misdeclared_single():
    r = trouter.Router(n_partitions=4, rows_per_partition=100, max_ops=4)
    parts, rows, kinds, deltas = _mk_txn([[0, 0, 0], [1, 1, 2], [2, 3]])
    declared = np.array([0, 1, -1])
    is_cross, home = r.classify(parts, kinds, declared)
    assert is_cross.tolist() == [False, True, True]
    assert r.stats.rerouted == 1
    r2 = trouter.Router(n_partitions=4, rows_per_partition=100, max_ops=4)
    batch = r2.route(parts, rows, kinds, deltas, declared_home=declared)
    assert batch["n_single"] == 1 and batch["n_cross"] == 2
    assert r2.stats.rerouted == 1


def test_router_feeds_engine():
    """The router's batch through the port's engine, commit counts as the
    reference's test holds them, state bit-equal to the JAX engine fed the
    same batch."""
    rng = np.random.default_rng(0)
    B = 64
    home = rng.integers(0, 4, B)
    parts = np.repeat(home[:, None], 4, 1).astype(np.int32)
    cross = rng.random(B) < 0.3
    parts[cross, 1] = (parts[cross, 1] + 1) % 4
    rows = np.stack([rng.choice(64, 4, replace=False) for _ in range(B)]
                    ).astype(np.int32)
    kinds = rng.integers(0, 3, (B, 4)).astype(np.int32)
    deltas = rng.integers(-5, 5, (B, 4, 10)).astype(np.int32)
    batch = trouter.Router(4, 64, 4).route(parts, rows, kinds, deltas)
    eng = TEngine(4, 64, device="cpu")
    m = eng.run_epoch(batch)
    assert m["committed_single"] == batch["n_single"]
    assert m["committed_cross"] == batch["n_cross"]
    assert eng.replica_consistent()
    je = JEngine(4, 64)
    je.run_epoch(jrouter.Router(4, 64, 4).route(parts, rows, kinds, deltas))
    _assert_engine_equal(je, eng, "router batch")


# ---------------------------------------------------------------------------
# the engine on YCSB: every knob against the reference
# ---------------------------------------------------------------------------
def _assert_engine_equal(je, te, tag):
    for name in ("master", "replica", "snapshot"):
        j, t = getattr(je, name), getattr(te, name)
        got = to_numpy_state({"val": t["val"], "tid": t["tid"],
                              "indexes": []})
        assert np.array_equal(np.asarray(j["val"]), got["val"]), (tag, name)
        assert np.asarray(j["tid"]).dtype == got["tid"].dtype
        assert np.array_equal(np.asarray(j["tid"]), got["tid"]), (tag, name)


def _assert_metrics_equal(jm, tm, tag):
    assert set(jm) == set(tm), (tag, sorted(set(jm) ^ set(tm)))
    for k in jm:
        if k not in TIMES:
            _tree_equal(jm[k], tm[k], f"{tag}.{k}")


def _assert_stats_equal(je, te):
    for f in dataclasses.fields(je.stats):
        if not f.name.endswith("_s"):
            assert getattr(je.stats, f.name) == getattr(te.stats, f.name), \
                f.name


@pytest.mark.parametrize("n_slabs", [1, 4])
@pytest.mark.parametrize("hybrid", [True, False])
def test_engine_ycsb_parity(hybrid, n_slabs):
    cfg = tycsb.YCSBConfig(n_partitions=P, records_per_partition=R)
    kw = dict(hybrid_replication=hybrid, n_slabs=n_slabs)
    je, te = JEngine(P, R, **kw), TEngine(P, R, device="cpu", **kw)
    for ep in range(4):
        jm = je.run_epoch(jycsb.make_batch(jycsb.YCSBConfig(P, R), N_TXNS,
                                           seed=ep))
        tm = te.run_epoch(tycsb.make_batch(cfg, N_TXNS, seed=ep))
        assert te.replica_consistent(), ep
        _assert_engine_equal(je, te, ep)
        _assert_metrics_equal(jm, tm, ep)
    _assert_stats_equal(je, te)
    assert te.stats.committed_cross > 0 and te.stats.value_bytes > 0
    if not hybrid:
        s = te.stats
        assert s.op_bytes_hybrid == s.value_bytes_if_not_hybrid
        assert s.op_bytes_overlapped == s.op_bytes_fence == 0


def test_padding_lanes_with_foreign_rows():
    """A service batch's padding lanes gather whatever their pool slot held
    — a cross transaction's global rows, past the partition.  The reference
    fills those reads and the lane writes nothing; the port clamps them
    into the partition: the same state and commit masks.  A valid lane's
    rows are not clamped: one past the whole table still faults."""
    b = jycsb.make_batch(jycsb.YCSBConfig(P, R), N_TXNS, seed=11)
    pt = b["ptxn"]
    pad = ~pt["valid"]
    assert pad.any()
    pt["row"][pad] = np.random.default_rng(0).integers(
        R, P * R, pt["row"][pad].shape)
    pt["kind"][pad] = SET
    je, te = JEngine(P, R), TEngine(P, R, device="cpu")
    _assert_metrics_equal(je.run_epoch(b), te.run_epoch(b), "padded")
    assert te.replica_consistent()
    _assert_engine_equal(je, te, "padded")

    p, t = map(int, np.argwhere(pt["valid"])[0])
    pt["row"][p, t, 0] = P * R + 7
    with pytest.raises(IndexError):
        TEngine(P, R, device="cpu").run_epoch(b)


@pytest.fixture(scope="module")
def ycsb_engines():
    """The reference's ``ycsb_engine`` fixture on both engines: P=4, 500
    records a partition, 3 epochs."""
    cfg = jycsb.YCSBConfig(n_partitions=4, records_per_partition=500)
    je = JEngine(4, 500)
    te = TEngine(4, 500, device="cpu")
    for ep in range(3):
        je.run_epoch(jycsb.make_batch(cfg, 192, seed=ep))
        te.run_epoch(tycsb.make_batch(tycsb.YCSBConfig(4, 500), 192,
                                      seed=ep))
    return je, te


def test_replica_consistent_and_epoch_advances(ycsb_engines):
    je, te = ycsb_engines
    assert te.replica_consistent()
    assert te.epoch == je.epoch == 4
    assert te.stats.fences == je.stats.fences == 6
    _assert_engine_equal(je, te, "fixture")
    _assert_stats_equal(je, te)


def test_controller_solves_eq12(ycsb_engines):
    _, te = ycsb_engines
    tau_p, tau_s = te.controller.plan()
    e = te.controller.e_ms
    assert abs(tau_p + tau_s - e) < 1e-9                     # Eq (1)
    t_p, t_s = te.controller.t_p, te.controller.t_s
    frac = te.controller.frac_cross
    assert frac > 0 and t_s > 0
    lhs = tau_s * t_s / (tau_p * t_p + tau_s * t_s)          # Eq (2)
    assert abs(lhs - frac) < 1e-6
    # the same telemetry gives the same plan in the reference's solver
    assert jps.solve_phase_times(e, t_p, t_s, frac) == (tau_p, tau_s)


def test_ycsb_no_hybrid_savings(ycsb_engines):
    """Paper §7.5: YCSB writes update the whole record — no savings; the
    port's byte figures equal the reference's."""
    je, te = ycsb_engines
    s = te.stats
    assert s.op_bytes_hybrid >= 0.9 * s.value_bytes_if_not_hybrid
    assert (s.op_bytes_hybrid, s.value_bytes_if_not_hybrid) == \
        (je.stats.op_bytes_hybrid, je.stats.value_bytes_if_not_hybrid)


def test_tpcc_hybrid_replication_saves_bytes():
    kw = dict(n_partitions=2, n_items=500, cust_per_district=50,
              order_ring=64)
    jc, tc = jtpcc.TPCCConfig(**kw), ttpcc.TPCCConfig(**kw)
    js, ts = jtpcc.TPCCState(jc), ttpcc.TPCCState(tc)
    je = JEngine(2, jc.rows_per_partition,
                 init_val=jtpcc.init_values(jc, np.random.default_rng(0)))
    te = TEngine(2, tc.rows_per_partition, device="cpu",
                 init_val=ttpcc.init_values(tc, np.random.default_rng(0)))
    for ep in range(2):
        _assert_metrics_equal(
            je.run_epoch(jtpcc.make_batch(jc, js, 128, seed=ep)),
            te.run_epoch(ttpcc.make_batch(tc, ts, 128, seed=ep)), ep)
    assert te.replica_consistent()
    assert te.stats.value_bytes_if_not_hybrid > 3 * te.stats.op_bytes_hybrid
    _assert_stats_equal(je, te)
    _assert_engine_equal(je, te, "tpcc")


def test_failure_revert_and_cluster_plans():
    """``cluster=``: the reference's revert-and-continue test, then every
    one of the 255 failure patterns of f=2, k=6 planned by both engines'
    ``inject_failure`` (case, re-mastered partitions, run mode)."""
    cfg = tycsb.YCSBConfig(n_partitions=4, records_per_partition=300)
    je = JEngine(4, 300, cluster=JCluster(f=1, k=4, n_partitions=4))
    te = TEngine(4, 300, cluster=TCluster(f=1, k=4, n_partitions=4),
                 device="cpu")
    for e in (je, te):
        e.run_epoch(jycsb.make_batch(jycsb.YCSBConfig(4, 300), 128, seed=0))
    snap = as_numpy(te.snapshot["val"]).copy()
    plan = te.inject_failure({2})
    assert plan.case == RecoveryCase.PHASE_SWITCHING
    je.inject_failure({2})
    assert np.array_equal(as_numpy(te.master["val"]), snap)
    b = tycsb.make_batch(cfg, 128, seed=1)
    je.run_epoch(b)
    te.run_epoch(b)
    assert te.replica_consistent()
    _assert_engine_equal(je, te, "after revert")

    kw = dict(f=2, k=6, n_partitions=6, replicas_per_partition=2)
    jcl, tcl = JCluster(**kw), TCluster(**kw)
    je6 = JEngine(6, 8, cluster=jcl)
    te6 = TEngine(6, 8, cluster=tcl, device="cpu")
    counts = {c: 0 for c in RecoveryCase}
    for mask in range(1, 256):
        failed = {i for i in range(8) if mask & (1 << i)}
        assert jclassify(jcl, failed).name == tclassify(tcl, failed).name
        counts[tclassify(tcl, failed)] += 1
        jp, tp = je6.inject_failure(failed), te6.inject_failure(failed)
        assert (jp.case.name, jp.remaster, jp.run_mode) == \
            (tp.case.name, tp.remaster, tp.run_mode), failed
    assert all(v > 0 for v in counts.values())
    assert tclassify(tcl, set(range(8))) == RecoveryCase.UNAVAILABLE
    assert tclassify(tcl, {0, 1}) == RecoveryCase.FALLBACK_DIST_CC
    assert tclassify(tcl, set(range(2, 8))) == RecoveryCase.FULL_ONLY
    assert tclassify(tcl, {3}) == RecoveryCase.PHASE_SWITCHING


def test_fence_models_network_lag():
    """``net=``: the fence ships the epoch's stream bytes through the
    Network envelope — the modeled lag equals the reference's, above two
    barrier RTTs a fence."""
    jn, tn = JNetwork(), TNetwork()
    cfg = tycsb.YCSBConfig(n_partitions=2, records_per_partition=200)
    je, te = JEngine(2, 200, net=jn), TEngine(2, 200, net=tn, device="cpu")
    jm = je.run_epoch(jycsb.make_batch(jycsb.YCSBConfig(2, 200), 128,
                                       seed=3))
    tm = te.run_epoch(tycsb.make_batch(cfg, 128, seed=3))
    floor = 2 * 2 * tn.rtt_s
    assert tm["t_fence_net_s"] > floor
    assert te.stats.fence_net_s >= tm["t_fence_net_s"]
    assert tm["t_fence_net_s"] == jm["t_fence_net_s"]
    assert te.stats.fence_net_s == je.stats.fence_net_s


# ---------------------------------------------------------------------------
# the phase controller
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adaptive", [False, True])
def test_phase_controller_parity(adaptive):
    rng = np.random.default_rng(5)
    jc = jps.PhaseController(e_ms=10.0, adaptive=adaptive)
    tc = tps.PhaseController(e_ms=10.0, adaptive=adaptive)
    fields = ("e_ms", "t_p", "t_s", "frac_cross", "queue_delay_ms",
              "measured_commit_ms", "fence_wait_ms")
    assert tc.expected_mean_latency_ms() == jc.expected_mean_latency_ms()
    for i in range(60):
        n, el = int(rng.integers(0, 500)), float(rng.random() * 0.02)
        qd = float(rng.random() * 40) if i % 9 else -1.0
        for c in (jc, tc):
            c.observe("partitioned", n, el)
            c.observe("single", n // 7, el / 3, frac_cross=(i % 5) / 10)
            c.observe_latency(qd, None if i % 4 == 0 else 5.0 + i)
            c.observe_fence_wait(float(i % 6) - 1.0)
        assert jc.plan() == tc.plan()
        for f in fields:
            assert getattr(jc, f) == getattr(tc, f), (i, f)
        assert jc.expected_mean_latency_ms() == tc.expected_mean_latency_ms()
    assert (tc.e_ms != 10.0) == adaptive


def test_engine_adaptive_epoch_flag():
    eng = TEngine(2, 64, adaptive_epoch=True, iteration_ms=10.0,
                  device="cpu")
    jeng = JEngine(2, 64, adaptive_epoch=True, iteration_ms=10.0)
    assert eng.controller.adaptive
    for _ in range(40):
        eng.controller.observe_latency(30.0, 35.0)
        jeng.controller.observe_latency(30.0, 35.0)
    assert eng.controller.e_ms > 15.0
    assert eng.controller.e_ms == jeng.controller.e_ms
    assert not TEngine(2, 64, device="cpu").controller.adaptive
