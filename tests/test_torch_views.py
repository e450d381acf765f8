"""PyTorch port vs JAX reference: the materialized views and the analytics
lane.

A CPU port engine and a JAX engine run the same full-mix TPC-C batches,
each with its ``MaterializedViews`` subscribed from the committed state.
Held bit-equal (tolerance 0): the port's stamps and the JAX views' stamps
epoch by epoch, every stamp and ``recompute`` of the committed values,
``time_travel`` to every retained fence, the working projection and the
replica's ``VIEW_COLS`` after each epoch, and the analytics query mix.
The committed projection is a copy: a subscriber behind the views checks,
while the next epoch's streams are applied, that it still holds the last
fence.  The tests of tests/test_changelog.py (the time-travel property,
the revert) run here on both sides.
"""
import numpy as np
import pytest
import torch

from repro.changelog import AnalyticsLane as JLane
from repro.changelog import MaterializedViews as JViews
from repro.core.engine import StarEngine as JEngine
from repro.db import tpcc as jtpcc
from repro_torch.changelog import VIEW_COLS, AnalyticsLane, MaterializedViews
from repro_torch.core.engine import StarEngine
from repro_torch.db import tpcc
from tests._hyp import given, settings, st

CFG = dict(n_partitions=2, n_items=400, cust_per_district=40, order_ring=64,
           mix="full", delivery_gen_lag=256)
AGGS = ("revenue", "stock_low", "undelivered", "order_latency")


def _pair(**views_kw):
    """A JAX engine and a CPU port engine on the same initial state, each
    with MaterializedViews attached from its committed state."""
    out = []
    for mod, eng_cls, views_cls, kw in (
            (jtpcc, JEngine, JViews, {}),
            (tpcc, StarEngine, MaterializedViews, {"device": "cpu"})):
        cfg = mod.TPCCConfig(**CFG)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(5), state=state)
        eng = eng_cls(cfg.n_partitions, cfg.rows_per_partition,
                      init_val=init, indexes=mod.index_specs(cfg),
                      n_slabs=4, **kw)
        views = views_cls(cfg, **views_kw)
        eng.changelog.subscribe(views)
        val, tid = eng.committed_state()
        views.on_reset(val, tid, eng.committed_epoch)
        out.append((mod, cfg, state, eng, views))
    return out


def _step(side, seed, n=96):
    mod, cfg, state, eng, _ = side
    batch = mod.make_batch(cfg, state, n, seed=seed)
    m = eng.run_epoch(batch)
    mod.apply_consume_feedback(state, batch, m)
    return m


def _same_aggs(a, b, tag):
    for k in AGGS:
        assert a[k].dtype == b[k].dtype, (tag, k)
        assert np.array_equal(a[k], b[k]), (tag, k)


class _CommittedWatch:
    """Subscribed after the views: when the master stream arrives (the
    epoch's partitioned slab already applied to the working projection)
    the committed projection must still equal the last fence's copy."""

    def __init__(self, views):
        self.views = views
        self.fence = views._c_proj.clone()
        self.checked = 0
        self.moved = 0

    def on_master(self, stream):
        assert torch.equal(self.views._c_proj, self.fence)
        self.moved += int(not torch.equal(self.views.proj, self.fence))
        self.checked += 1

    def on_commit(self, epoch, record):
        self.fence = self.views._c_proj.clone()

    def on_revert(self, epoch, n_slabs):
        assert torch.equal(self.views.proj, self.fence)


def test_views_stamps_equal_the_jax_views_epoch_by_epoch():
    """Port stamps == JAX stamps == recompute of the committed values at
    every fence; the working projection equals the replica's VIEW_COLS
    (duplicate stock rows included) and the committed one never changes
    between fences."""
    j, t = _pair(stock_threshold=40, retain=4)
    watch = t[3].changelog.subscribe(_CommittedWatch(t[4]))
    _same_aggs(j[4].latest()[1], t[4].latest()[1], "attach")
    for ep in range(5):
        _step(j, ep)
        _step(t, ep)
        (je, ja), (te, ta) = j[4].latest(), t[4].latest()
        assert je == te == t[3].committed_epoch
        _same_aggs(ja, ta, ep)
        _same_aggs(t[4].recompute(t[3].committed_state()[0]), ta, ep)
        rv = t[3].replica_store.val
        assert torch.equal(t[4].proj, rv[..., list(VIEW_COLS)]), ep
        assert torch.equal(t[4].ptid, t[3].replica_store.tid), ep
        assert torch.equal(t[4]._c_proj, t[4].proj)
        assert t[3].replica_consistent()
    assert watch.checked == 5 and watch.moved > 0
    for f in ("slabs_applied", "writes_applied", "master_merges", "commits",
              "reverts"):
        assert getattr(j[4], f) == getattr(t[4], f), f
    assert j[4].retained_epochs() == t[4].retained_epochs()


_MV = None


def _mv_fixture():
    global _MV
    if _MV is None:
        j, t = _pair(stock_threshold=40, retain=4)
        _MV = {"j": j, "t": t, "oracle": {
            t[3].committed_epoch: t[4].recompute(t[3].committed_state()[0])}}
    return _MV


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_mv_bit_equal_recompute_and_time_travel(seed):
    """Every stamped fence bit-equals recompute over the committed values
    and the JAX views' stamp; time_travel(e) returns exactly the stamp of
    fence e, or None once evicted — on both sides."""
    fx = _mv_fixture()
    j, t = fx["j"], fx["t"]
    for side in (j, t):
        _step(side, int(seed) % 100_000)
    epoch, aggs = t[4].latest()
    assert epoch == t[3].committed_epoch == j[4].latest()[0]
    want = t[4].recompute(t[3].committed_state()[0])
    _same_aggs(want, aggs, epoch)
    _same_aggs(j[4].latest()[1], aggs, epoch)
    fx["oracle"][epoch] = {k: v.copy() for k, v in want.items()}
    retained = t[4].retained_epochs()
    assert retained == j[4].retained_epochs()
    assert len(retained) <= 4 and retained[-1] == epoch
    for e in retained:
        _same_aggs(fx["oracle"][e], t[4].time_travel(e), e)
        _same_aggs(j[4].time_travel(e), t[4].time_travel(e), e)
    for e in fx["oracle"]:
        if e not in retained:
            assert t[4].time_travel(e) is None


def test_mv_revert_snaps_back_to_committed():
    """A §4.5 revert copies the committed projection back into the working
    one: the stamps equal the committed state through the failure and at
    the next fence, on both sides alike."""
    sides = _pair(stock_threshold=40, retain=4)
    for side in sides:
        _step(side, 0)
        side[3].inject_failure({0})
        assert side[4].reverts == 1
    j, t = sides
    _same_aggs(t[4].recompute(t[3].committed_state()[0]), t[4].latest()[1],
               "revert")
    assert torch.equal(t[4].proj, t[4]._c_proj)
    for side in sides:
        _step(side, 1)
    epoch, aggs = t[4].latest()
    assert epoch == t[3].committed_epoch == j[4].latest()[0]
    _same_aggs(t[4].recompute(t[3].committed_state()[0]), aggs, epoch)
    _same_aggs(j[4].latest()[1], aggs, epoch)
    assert t[3].replica_consistent()


def test_on_reset_copies_the_committed_arrays():
    """The views seed from the engine's snapshot buffers, which the next
    fence overwrites: what they keep is their own."""
    _, t = _pair()
    views = t[4]
    val, _ = t[3].committed_state()
    c0 = views._c_proj.clone()
    _step(t, 0)
    assert not torch.equal(val[..., list(VIEW_COLS)], c0)
    assert views.proj.data_ptr() != val.data_ptr()


def _walk_lane(side, lane, n_epochs=5):
    mod, cfg, state, eng, _ = side
    assert lane.ensure_attached(eng)
    outs = []
    for ep in range(n_epochs):
        batch = mod.make_batch(cfg, state, 96, seed=ep)
        m = eng.run_epoch(batch)
        mod.apply_consume_feedback(state, batch, m)
        outs.append(lane.serve(eng.committed_epoch))
    return outs


def test_analytics_lane_answers_equal_the_jax_lane():
    """The query mix (top revenue, stock low, backlog, latency histogram,
    the time-travel revenue delta) and every count of the summary equal
    the JAX lane's; the summary keys are the reference's."""
    results = []
    lanes = []
    for mod, eng_cls, lane_cls, kw in (
            (jtpcc, JEngine, JLane, {}),
            (tpcc, StarEngine, AnalyticsLane, {"device": "cpu"})):
        cfg = mod.TPCCConfig(**CFG)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(5), state=state)
        eng = eng_cls(cfg.n_partitions, cfg.rows_per_partition,
                      init_val=init, indexes=mod.index_specs(cfg), **kw)
        lane = lane_cls(cfg, stock_threshold=40, retain=4, travel_every=2)
        results.append(_walk_lane((mod, cfg, state, eng, None), lane))
        lanes.append(lane)
    assert results[0] == results[1]
    assert any("revenue_delta" in r for r in results[1])
    js, ts = lanes[0].summary(), lanes[1].summary()
    assert set(js) == set(ts)
    for k in js:
        if k not in ("analytics_q_p50_ms", "analytics_q_p99_ms",
                     "analytics_query_s"):
            assert js[k] == ts[k], k


@pytest.mark.parametrize("lanes", ["analytics", "both"])
def test_lanes_through_the_service_on_the_cpu(lanes):
    """TxnService on the CPU port engine with the analytics lane (and the
    read tier): every epoch's stamp equals recompute of the committed
    values, the lane's lag is 0, and the summary and registry keys are
    those of the JAX service with the same lanes."""
    from repro.reads import ReadTier as JReadTier
    from repro.service import TxnService as JService
    from repro.service import admission as jadm
    from repro.service import clients as jcli
    from repro_torch.reads import ReadTier
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService)
    keys = []
    for port in (False, True):
        mod = tpcc if port else jtpcc
        cfg = mod.TPCCConfig(**CFG)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(0), state=state)
        eng = (StarEngine(2, cfg.rows_per_partition, init_val=init,
                          indexes=mod.index_specs(cfg), device="cpu")
               if port else JEngine(2, cfg.rows_per_partition,
                                    init_val=init,
                                    indexes=mod.index_specs(cfg)))
        client = (OpenLoopClient if port else jcli.OpenLoopClient)(
            (TPCCSource if port else jcli.TPCCSource)(cfg, state=state,
                                                      seed=2),
            rate_txn_s=3000.0)
        lane = (AnalyticsLane if port else JLane)(cfg, stock_threshold=40)
        tier = None
        if lanes == "both":
            tier = (ReadTier if port else JReadTier)(
                max_staleness_epochs=1, sec_refresh_every=2)
        svc = (TxnService if port else JService)(
            eng, [client],
            (AdmissionConfig if port else jadm.AdmissionConfig)(256, 256),
            slots_per_partition=8, master_lanes=8, analytics=lane,
            read_tier=tier, feedback=lambda b, m, mod=mod, state=state:
            mod.apply_consume_feedback(state, b, m))
        stamps = []
        fence = svc._observe_epoch

        def observe(m, svc=svc, eng=eng, lane=lane, fence=fence):
            fence(m)
            stamps.append((lane.views.latest()[1],
                           lane.views.recompute(eng.committed_state()[0])))
        svc._observe_epoch = observe
        out = svc.run(duration_s=60.0, max_epochs=5)
        keys.append((set(out), {k for k in svc.metrics.values()
                                if not k.startswith("kernels.")}))
    assert keys[0] == keys[1]
    assert out["epochs"] == 5 and out["analytics_serves"] == 5
    assert out["analytics_max_epoch_lag"] == 0
    assert out["analytics_mv_slabs"] > 0 and out["analytics_mv_writes"] > 0
    for got, want in stamps:
        _same_aggs(want, got, "service")
    assert eng.replica_consistent()
