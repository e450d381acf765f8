"""PyTorch port vs JAX reference: the bounded-staleness read tier.

The single-host tests of tests/test_reads.py and the mid-epoch read tests
of tests/test_changelog.py, each run on the port and on the JAX package
with the same numpy-seeded inputs and held bit-equal (tolerance 0; TID
words compare by value, int64 in the port and uint32 in the reference):
read-lane admission, the fallback, the catalog ring, and the freshness
property over a full-mix TPC-C engine pair fed the same batches, where the
chosen replica, the epoch, the freshness and every output key must match
the JAX tier's and equal ``reference_read`` on the recorded fence.  The
port's catalog copies what it retains; ``test_stale_read_returns_the_older
_fence`` fails if it kept references to the engine's snapshot buffers.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_util import assert_tree_equal

from repro.changelog import ChangeLog as JChangeLog
from repro.core.engine import StarEngine as JEngine
from repro.db import tpcc as jtpcc
from repro.reads import ReadTier as JReadTier
from repro.reads import SnapshotCatalog as JCatalog
from repro.reads import reference_read as jreference_read
from repro.service import admission as jadm
from repro_torch.changelog import ChangeLog
from repro_torch.core.engine import StarEngine
from repro_torch.db import tpcc
from repro_torch.reads import (ReadTier, SnapshotCatalog,
                               SnapshotReadExecutor, reference_read)
from repro_torch.reads.tier import ReadTierStats
from repro_torch.service import admission as tadm
from tests._hyp import given, settings, st

SIDES = (("jax", jadm, JReadTier), ("port", tadm, ReadTier))


def _read_req(n, home_p, M=2, C=3, read_only=True):
    return {
        "parts": np.full((n, M), home_p, np.int32),
        "rows": np.tile(np.arange(M, dtype=np.int32), (n, 1)),
        "kinds": np.zeros((n, M), np.int32),
        "deltas": np.zeros((n, M, C), np.int32),
        "user_abort": np.zeros(n, bool),
        "home": np.full(n, home_p, np.int32),
        "read_only": np.full(n, read_only, bool),
        "txn_id": np.arange(n, dtype=np.int64),
        "tenant": np.zeros(n, np.int32),
        "arrival_s": np.zeros(n),
    }


def _same(ref, got, path="out"):
    """assert_tree_equal, with strings, None and bools compared as
    values."""
    if isinstance(ref, (list, tuple)) and not isinstance(ref, str):
        assert isinstance(got, (list, tuple)) and len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _same(ref[k], got[k], f"{path}.{k}")
    elif ref is None or isinstance(ref, (str, bool)):
        assert ref == got, (path, ref, got)
    else:
        assert_tree_equal(ref, got, path)


def _adm(adm):
    return {"read": list(adm.read_queue),
            "parts": [list(q) for q in adm.part_queues],
            "rejected": adm.stats.rejected_by_queue.tolist(),
            "max_read_depth": adm.stats.max_read_depth,
            "depth": adm.depth(), "read_depth": adm.read_depth()}


# ---------------------------------------------------------------------------
# read-lane admission, fallback, catalog ring (tests/test_reads.py)
# ---------------------------------------------------------------------------
def test_read_lane_admission_caps_and_shed_attribution():
    """Read-only singles take the bounded read lane, overflow is shed to
    the P + 1 slot, the lane drains FIFO and the fallback re-queues at the
    front of the home OCC queue — identically on both sides."""
    got = []
    for _, mod, _ in SIDES:
        adm = mod.AdmissionController(
            2, 64, max_ops=2, n_cols=3,
            cfg=mod.AdmissionConfig(64, 64, read_queue_cap=2),
            read_lane=True)
        rejected = adm.offer(_read_req(5, home_p=1), 0.0)
        steps = [rejected, _adm(adm)]
        slots = adm.drain_reads(10)
        adm.requeue_reads_occ(slots)
        steps += [slots, _adm(adm)]
        got.append(steps)
    assert_tree_equal(got[0], got[1])
    rejected, first, slots, after = got[1]
    assert rejected.sum() == 3 and first["read_depth"] == 2
    assert first["rejected"] == [0, 0, 0, 3]
    assert after["parts"][1] == slots and after["depth"] == 2


def test_read_lane_disabled_routes_reads_to_occ():
    got = []
    for _, mod, _ in SIDES:
        adm = mod.AdmissionController(2, 64, max_ops=2, n_cols=3)
        got.append([adm.offer(_read_req(3, home_p=0), 0.0), _adm(adm)])
    assert_tree_equal(got[0], got[1])
    assert got[1][1]["read_depth"] == 0 and len(got[1][1]["parts"][0]) == 3


def test_fallback_never_serves_without_eligible_replica():
    """An empty catalog serves nothing: every drained read re-enters its
    home partition queue in order."""
    got = []
    for _, mod, tier_cls in SIDES:
        adm = mod.AdmissionController(2, 64, max_ops=2, n_cols=3,
                                      read_lane=True)
        assert not adm.offer(_read_req(3, home_p=1), 0.0).any()
        queued = list(adm.read_queue)
        tier = tier_cls(max_staleness_epochs=4)
        assert tier.serve(adm) == []
        got.append([queued, _adm(adm), tier.stats.served,
                    tier.stats.fallbacks])
    assert_tree_equal(got[0], got[1])
    assert got[1][1]["parts"][1] == got[1][0] and got[1][3] == 3


def _view(rid, epoch, P=2, kind="secondary", node=1):
    return {"id": rid, "kind": kind, "node": node, "epoch": epoch,
            "watermark": (epoch, 0), "cover": np.ones(P, bool),
            "row_of_partition": np.arange(P), "val": np.zeros((P, 4, 2)),
            "tid": np.zeros((P, 4)), "idx": []}


def _catalog_walk(cat):
    out = []
    for e in (1, 2, 3):
        cat.stamp(_view("sec1", e))
    out.append(len(cat.entries["sec1"].snaps))
    out.append(cat.freshness("sec1"))
    cat.stamp(_view("full", 3, kind="full", node=0))
    cat.announce_epoch(4)
    out += [cat.freshness("sec1"), cat.freshness("full"),
            len(cat.eligible(0, 0))]
    got = cat.choose(0, 1, weight=2)
    other = cat.choose(0, 1, weight=1)
    out += [got[0].replica_id, got[0].serves, got[1], other[0].replica_id,
            cat.serves_by_replica()]
    out += [cat.remove("sec1"), cat.freshness("sec1"), cat.remove("sec1")]
    return out


def test_catalog_ring_freshness_choose_and_remove():
    want = _catalog_walk(JCatalog(2, retain=2))
    got = _catalog_walk(SnapshotCatalog(2, retain=2))
    assert got == want
    assert got[:2] == [2, 0] and got[7] != got[5]


def test_catalog_owns_its_snapshots():
    """A stamp copies val, tid and every index field (torch and numpy
    alike); a repeated stamp of one epoch copies nothing."""
    t = {"id": "full", "kind": "full", "node": 0, "epoch": 1,
         "watermark": (1, 0), "cover": np.ones(2, bool),
         "row_of_partition": np.arange(2),
         "val": torch.arange(8, dtype=torch.int32).view(2, 4, 1),
         "tid": torch.zeros((2, 4), dtype=torch.int64),
         "idx": [{f: torch.zeros((2, 3), dtype=torch.int32)
                  for f in ("key", "prow", "tid")}]}
    cat = SnapshotCatalog(2, retain=2)
    cat.stamp(t)
    cat.stamp(t)
    assert cat.stamp_copies == 1
    _, snap, _ = cat.entries["full"].snaps[-1]
    t["val"] += 100
    t["idx"][0]["key"] += 1
    assert int(snap["val"].max()) == 7 and int(snap["idx"][0]["key"].max()) == 0
    assert cat.stamp_bytes == 8 * 4 + 8 * 8 + 3 * 6 * 4


# ---------------------------------------------------------------------------
# a port engine and a JAX engine on the same full-mix batches
# ---------------------------------------------------------------------------
CFG = dict(n_partitions=4, n_items=400, cust_per_district=40, order_ring=64,
           mix="full", delivery_gen_lag=96)
_FX = None


def _record(eng, recorded):
    for v in eng.read_views():
        recorded[(v["id"], int(v["epoch"]))] = {
            "val": np.asarray(v["val"]).copy(),
            "tid": np.asarray(v["tid"]).copy(),
            "idx": [{k: np.asarray(ix[k]).copy()
                     for k in ("key", "prow", "tid")}
                    for ix in (v.get("idx") or [])]}


def _engine_fixture():
    """5 full-mix epochs through a JAX engine and a CPU port engine, each
    with its ReadTier (k = 3, the replica view refreshed every 2nd fence,
    so it ends one fence stale); every view of every fence recorded on
    both sides (numpy copies: the oracle)."""
    global _FX
    if _FX is not None:
        return _FX
    sides = {}
    for name, mod, adm, eng_cls, tier_cls, kw in (
            ("jax", jtpcc, jadm, JEngine, JReadTier, {}),
            ("port", tpcc, tadm, StarEngine, ReadTier, {"device": "cpu"})):
        cfg = mod.TPCCConfig(**CFG)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(0), state=state)
        eng = eng_cls(4, cfg.rows_per_partition, init_val=init,
                      indexes=mod.index_specs(cfg), **kw)
        tier = tier_cls(max_staleness_epochs=3, sec_refresh_every=2)
        sides[name] = SimpleNamespace(mod=mod, adm=adm, cfg=cfg, state=state, eng=eng,
                                      tier=tier, recorded={}, reads=[])
    for s in sides.values():
        s.tier.observe_epoch(s.eng)
        _record(s.eng, s.recorded)
    for ep in range(5):
        for s in sides.values():
            raw = s.mod.make_raw(s.cfg, s.state, 96,
                                 np.random.default_rng(ep))
            batch = s.mod.make_batch(s.cfg, s.state, 0, raw=raw)
            m = s.eng.run_epoch(batch)
            s.mod.apply_consume_feedback(s.state, batch, m)
            s.tier.observe_epoch(s.eng)
            _record(s.eng, s.recorded)
            sel = raw["read_only"]
            s.reads.append({k: raw[k][sel] for k in
                            ("parts", "rows", "kinds", "deltas",
                             "user_abort", "home")})
    for s in sides.values():
        s.reads = {k: np.concatenate([r[k] for r in s.reads])
                   for k in s.reads[0]}
    j, t = sides["jax"], sides["port"]
    assert_tree_equal(j.reads, t.reads)
    assert set(j.recorded) == set(t.recorded)
    for key in j.recorded:                       # the same fences
        assert_tree_equal(j.recorded[key], t.recorded[key], str(key))
    assert t.reads["home"].shape[0] > 0, "mix drew no read-only txns"
    _FX = SimpleNamespace(j=j, t=t, final_epoch=int(t.eng.committed_epoch),
                          n_reads=t.reads["home"].shape[0])
    return _FX


def _offer(side, pick):
    n = pick.size
    adm = side.adm.AdmissionController(4, side.cfg.rows_per_partition,
                                  max_ops=side.reads["rows"].shape[1],
                                  n_cols=side.reads["deltas"].shape[2],
                                  read_lane=True)
    req = {k: v[pick] for k, v in side.reads.items()}
    req.update(read_only=np.ones(n, bool), txn_id=np.arange(n, dtype=np.int64),
               tenant=np.zeros(n, np.int32), arrival_s=np.zeros(n))
    assert not adm.offer(req, 0.0).any()
    return adm


def _serve_both(fx, k, pick):
    """Serve the same reads on both tiers at bound k; hold every group
    equal (replica, epoch, freshness, slots, every output key) and the
    port's outputs equal to reference_read on the port's recorded fence.
    Returns the port's results."""
    out = []
    for side in (fx.j, fx.t):
        side.tier.k = int(k)
        adm = _offer(side, pick)
        out.append((adm, side.tier.serve(adm)))
    (jadm_, jres), (tadm_, tres) = out
    assert len(jres) == len(tres)
    pool = tadm_.pool
    cur = fx.t.tier.catalog.current_epoch
    for jr, tr in zip(jres, tres):
        for key in ("replica", "epoch", "freshness"):
            assert jr[key] == tr[key], key
        assert np.array_equal(jr["slots"], tr["slots"])
        assert_tree_equal({x: np.asarray(y) for x, y in jr["out"].items()},
                          tr["out"], f"{tr['replica']}@{tr['epoch']}")
        assert 0 <= tr["freshness"] <= k and tr["freshness"] == \
            cur - tr["epoch"]
        if k == 0:
            assert tr["epoch"] == fx.final_epoch
        ent = fx.t.tier.catalog.entries[tr["replica"]]
        arow = ent.row_of_partition[pool.home[tr["slots"]].astype(np.int64)]
        exp = reference_read(fx.t.recorded[(tr["replica"], tr["epoch"])],
                             arow, pool.row[tr["slots"]],
                             pool.kind[tr["slots"]], pool.delta[tr["slots"]])
        for key, want in exp.items():
            assert np.array_equal(tr["out"][key].numpy(), want), key
    for f in ("served", "batches", "fallbacks", "stale_violations",
              "max_freshness_served", "served_by_freshness"):
        assert getattr(fx.j.tier.stats, f) == getattr(fx.t.tier.stats, f), f
    return tres


def test_k0_reads_bit_equal_current_fence():
    fx = _engine_fixture()
    res = _serve_both(fx, 0, np.arange(fx.n_reads))
    assert sum(r["slots"].size for r in res) == fx.n_reads
    assert fx.t.tier.stats.stale_violations == 0


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 3), st.integers(0, 2 ** 31 - 1))
def test_freshness_bound_property(k, seed):
    """At every bound k in 0..3 the two tiers serve the same reads from the
    same replicas and fences, bit-equal; nothing is dropped or served past
    the bound."""
    fx = _engine_fixture()
    rng = np.random.default_rng(seed)
    pick = rng.choice(fx.n_reads, size=int(rng.integers(1, fx.n_reads + 1)),
                      replace=False)
    before = fx.t.tier.stats.fallbacks
    res = _serve_both(fx, k, pick)
    assert sum(r["slots"].size for r in res) == pick.size
    assert fx.t.tier.stats.fallbacks == before
    assert fx.t.tier.stats.stale_violations == 0


def test_stale_read_returns_the_older_fence():
    """The replica view was last stamped one fence back.  A freshness-1
    read served from it returns that older fence's values, bit-equal to
    the JAX tier's, although the engine's snapshot buffers have since been
    overwritten by the newer fence."""
    fx = _engine_fixture()
    ent = fx.t.tier.catalog.entries["replica"]
    epoch, snap, _ = ent.snaps[-1]
    assert epoch == fx.final_epoch - 1
    live = fx.t.eng.replica_store.snapshot
    assert not torch.equal(snap["val"], live["val"]), \
        "the newer fence wrote nothing: the check would prove nothing"
    assert np.array_equal(snap["val"].numpy(),
                          fx.t.recorded[("replica", epoch)]["val"])
    # make the full copy the busier one on both sides: the least-served
    # choice then picks the stale replica for every group
    for side in (fx.j, fx.t):
        full = side.tier.catalog.entries["full"]
        full.serves = max(full.serves, ent.serves) + 10 ** 6
    res = _serve_both(fx, 1, np.arange(fx.n_reads))
    assert res and all(r["replica"] == "replica" and r["freshness"] == 1
                       and r["epoch"] == epoch for r in res)


def test_executor_one_probe_launch_per_index():
    """One served group probes each index it scans with ONE scan_window
    call, and the CPU executor equals the JAX reference_read."""
    from repro_torch.obs.trace import kernel_launch_counts
    fx = _engine_fixture()
    _, snap, _ = fx.t.tier.catalog.entries["full"].snaps[-1]
    r = fx.t.reads
    arow = r["home"].astype(np.int64)
    kinds = r["kinds"]
    from repro_torch.core.ops import IDX_OPS, IX_ID, SCAN_READ
    K = min(IDX_OPS, kinds.shape[1])
    scanned = np.unique(r["deltas"][:, :K, IX_ID][kinds[:, :K] == SCAN_READ])
    assert scanned.size >= 1
    before = kernel_launch_counts().get("scan_window", 0)
    out = SnapshotReadExecutor().run(snap, arow, r["rows"], kinds,
                                     r["deltas"])
    assert kernel_launch_counts().get("scan_window", 0) - before \
        == scanned.size
    host = {"val": snap["val"].numpy(), "tid": snap["tid"].numpy(),
            "idx": [{f: ix[f].numpy() for f in ix} for ix in snap["idx"]]}
    want = jreference_read(host, arow, r["rows"], kinds, r["deltas"])
    assert_tree_equal(want, out)


# ---------------------------------------------------------------------------
# mid-epoch slab-watermark reads (tests/test_changelog.py)
# ---------------------------------------------------------------------------
def _toy_log(torch_side, P=2, T=3):
    log = {"row": np.zeros((P, T), np.int32),
           "val": np.zeros((P, T, 2), np.int32),
           "tid": np.zeros((P, T), np.uint32),
           "write": np.zeros((P, T, 1), bool)}
    if torch_side:
        log = {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32
                                  else v) for k, v in log.items()}
    return log


def _mid_epoch_walk(port):
    P, R = 2, 8
    mod, tier_cls, clog_cls = (tadm, ReadTier, ChangeLog) if port else \
        (jadm, JReadTier, JChangeLog)
    tier = tier_cls(max_staleness_epochs=0)
    adm = mod.AdmissionController(P, R, max_ops=2, n_cols=3, read_lane=True)
    rng = np.random.default_rng(3)
    v = rng.integers(0, 100, (P, R, 3)).astype(np.int32)
    view = {"id": "full", "kind": "full", "node": 0, "epoch": 5,
            "watermark": (5, 0), "cover": np.ones(P, bool),
            "row_of_partition": np.arange(P, dtype=np.int64),
            "val": torch.as_tensor(v) if port else v,
            "tid": (torch.zeros((P, R), dtype=torch.int64) if port
                    else np.zeros((P, R), np.uint32)), "idx": []}
    tier.catalog.P = P
    tier.catalog.stamp(view)
    trace = []
    req = dict(_read_req(2, home_p=0), kinds=np.zeros((2, 2), np.int32))
    assert not adm.offer(req, 0.0).any()
    trace.append(tier.serve(adm, mid_epoch=True) == [])
    trace.append(adm.read_depth())
    clog = clog_cls(n_slabs=4)
    tier.attach_changelog(clog)
    assert not adm.offer(_read_req(3, home_p=1), 0.0).any()
    log = _toy_log(port, P=P)
    log["write"][1, 0, 0] = True
    clog.publish_slab(log, epoch=6)
    results = tier.serve(adm, mid_epoch=True)
    exp = reference_read({"val": v, "tid": np.zeros((P, R), np.int64),
                          "idx": []},
                         np.zeros(2, np.int64), np.tile(np.arange(2), (2, 1)),
                         np.zeros((2, 2)), np.zeros((2, 2, 3)))
    for r in results:
        for key, want in exp.items():
            assert np.array_equal(np.asarray(r["out"][key]), want), key
    trace.append([(r["replica"], r["epoch"], r["freshness"],
                   r["slots"].tolist(),
                   {k: np.asarray(x) for k, x in r["out"].items()})
                  for r in results])
    trace.append(list(adm.read_queue))
    trace.append((tier.stats.mid_epoch_served, tier.stats.mid_epoch_deferred,
                  tier.stats.stale_violations))
    clog.commit(6)
    tier.catalog.announce_epoch(6)
    tier.catalog.stamp(dict(view, epoch=6, watermark=(6, 4)))
    results = tier.serve(adm, mid_epoch=True)
    trace.append([r["slots"].tolist() for r in results])
    trace.append((tier.stats.mid_epoch_served, adm.read_depth()))
    return trace


def test_mid_epoch_reads_serve_below_watermark_defer_dirty():
    """During an epoch k=0 reads of partitions no published slab wrote
    serve from the committed snapshot; dirty partitions defer to the
    lane's front and serve after the fence — the same groups, outputs,
    queues and counters on both sides."""
    want, got = _mid_epoch_walk(False), _mid_epoch_walk(True)
    _same(want, got)
    assert got[0] is True and got[1] == 2
    assert got[4] == (2, 3, 0) and got[6] == (5, 0)


def test_mid_epoch_gate_resets_on_revert():
    got = []
    for port in (False, True):
        clog = (ChangeLog if port else JChangeLog)(n_slabs=2)
        tier = (ReadTier if port else JReadTier)()
        tier.attach_changelog(clog)
        log = _toy_log(port)
        log["write"][0, 1, 0] = True
        clog.publish_slab(log, epoch=2)
        steps = [np.asarray(tier._gate.dirty).tolist()]
        clog.revert(2)
        steps.append(tier._gate.dirty is None)
        clog.publish_slab(_toy_log(port), epoch=2)
        steps.append(np.asarray(tier._gate.dirty).tolist())
        clog.commit(2)
        steps.append(tier._gate.dirty is None)
        got.append(steps)
    assert got[0] == got[1] == [[True, False], True, [False, False], True]


def test_tier_summary_and_stats_fields_match_the_reference():
    fx = _engine_fixture()
    js, ts = fx.j.tier.summary(), fx.t.tier.summary()
    assert set(js) == set(ts)
    for k in ("read_served", "read_fallbacks", "read_stale_violations",
              "read_max_freshness", "read_by_replica",
              "read_replicas_removed", "read_mid_epoch_served",
              "read_mid_epoch_deferred"):
        assert js[k] == ts[k], k
    import dataclasses
    from repro.reads.tier import ReadTierStats as JStats
    assert [f.name for f in dataclasses.fields(JStats)] == \
        [f.name for f in dataclasses.fields(ReadTierStats)]


@pytest.mark.parametrize("k", [0, 2])
def test_tier_through_the_service_on_the_cpu(k):
    """TxnService with the read tier on the CPU port engine over the full
    mix (max_epochs, not wall clock): reads served between fences and
    mid-epoch, none past the bound, the replica consistent, and the
    summary and registry keys those of the JAX service."""
    from repro.service import TxnService as JService
    from repro.service import clients as jcli
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService)
    keys = []
    for port in (False, True):
        mod = tpcc if port else jtpcc
        cfg = mod.TPCCConfig(n_partitions=2, n_items=200,
                             cust_per_district=20, order_ring=64, mix="full",
                             delivery_gen_lag=64)
        state = mod.TPCCState(cfg)
        init = mod.init_values(cfg, np.random.default_rng(0), state=state)
        eng = (StarEngine(2, cfg.rows_per_partition, init_val=init,
                          indexes=mod.index_specs(cfg), device="cpu")
               if port else JEngine(2, cfg.rows_per_partition,
                                    init_val=init,
                                    indexes=mod.index_specs(cfg)))
        cli = OpenLoopClient if port else jcli.OpenLoopClient
        src = TPCCSource if port else jcli.TPCCSource
        client = cli(src(cfg, state=state, seed=2), rate_txn_s=4000.0)
        tier = (ReadTier if port else JReadTier)(max_staleness_epochs=k,
                                                 sec_refresh_every=2)
        svc = (TxnService if port else JService)(
            eng, [client], (AdmissionConfig if port else
                            jadm.AdmissionConfig)(256, 256),
            slots_per_partition=8, master_lanes=8, read_tier=tier,
            feedback=lambda b, m, mod=mod, state=state:
            mod.apply_consume_feedback(state, b, m))
        out = svc.run(duration_s=60.0, max_epochs=6)
        keys.append((set(out), {x for x in svc.metrics.values()
                                if not x.startswith("kernels.")}))
    assert keys[0] == keys[1]
    assert out["epochs"] == 6 and out["read_served"] > 0
    assert out["read_stale_violations"] == 0
    assert out["read_max_freshness"] <= k
    assert out["read_served"] == svc.read_tier.recorder.committed()
    assert eng.replica_consistent()
