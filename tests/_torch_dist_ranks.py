"""Rank bodies of the multi-process tests (``launch.mesh.spawn`` imports
them by name in each child, so this module imports only torch and the
port).  Each takes ``(rank, world_size, device, *args)`` and returns
numpy arrays and numbers for the parent to check."""
import dataclasses

import numpy as np
import torch

MOE_ARCH = "granite-moe-1b-a400m"
MOE_KEYS = ("router", "w_up", "w_gate", "w_down")


def _np(t):
    """A numpy copy (never a view of a live tensor)."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def moe_cfg():
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch(MOE_ARCH, smoke=True),
                               capacity_factor=8.0)


def _expert_parallel(z, mesh):
    """This rank's rows of the expert-parallel MoE output on ``mesh``: its
    data shard of ``x``; (rows, y, aux)."""
    from repro_torch.models.moe import moe_forward
    cfg = moe_cfg()
    p = {k: torch.tensor(z[f"p_{k}"]) for k in MOE_KEYS}
    x = torch.tensor(z["x"])
    B, nd = x.shape[0], mesh.shape["data"]
    lo = mesh.coords["data"] * (B // nd)
    rows = np.arange(lo, lo + B // nd)
    y, aux = moe_forward(p, x[lo:lo + B // nd], cfg, mesh=mesh)
    return rows, _np(y), float(aux)


def _round_trip(mesh):
    """``gather(place(t))`` is ``t`` bit for bit, every spec of the mesh's
    axes, in int32, float32 and bfloat16."""
    from repro_torch.launch import sharding as shd
    g = torch.Generator().manual_seed(3)
    ok = []
    specs = [("data", None), (None, "model"), ("model", "data"),
             (("data", "model"), None), (None, None)]
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        t = torch.randn((8, 12), generator=g).mul(1000).to(dtype)
        for spec in specs:
            piece = shd.place(t, spec, mesh)
            back = shd.gather(piece, spec, mesh)
            ok.append(back.dtype == t.dtype and torch.equal(back, t))
    return all(ok)


def _generate(mesh):
    """Greedy tokens of Granite-MoE SMOKE without a mesh and with experts
    over ``model`` (each rank keeping its own)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    cfg = moe_cfg()
    prompts = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    one = ServeEngine(cfg, tf.LM(cfg, seed=0, device="cpu"), device="cpu",
                      max_len=64).generate(prompts, 8)
    model = tf.keep_local_experts(tf.LM(cfg, seed=0, device="cpu"), mesh)
    e_loc = model.layers[0].moe["w_up"].shape[0]
    ep = ServeEngine(cfg, model, device="cpu", max_len=64,
                     mesh=mesh).generate(prompts, 8)
    return _np(one), _np(ep), e_loc


def _per_shard(cfg, n_data: int):
    """The one-device oracle of a mesh with ``n_data`` data ranks: the
    step's batch as ``n_data`` microbatches, one a data shard.  A mesh
    averages the shards' losses, and MoE's aux loss is a statistic of a
    shard's tokens (the JAX branch averages it over the batch axes), so
    this is the function the mesh computes."""
    return dataclasses.replace(cfg, microbatches=n_data)


def _trainer(cfg, mesh, steps, tcfg=None):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = tcfg or TrainerConfig(seq_len=32, batch=4, steps_per_epoch=2)
    tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh)
    tr.run(steps)
    return tr


def _whole_np(tr):
    p, o = tr.state()
    out = {f"p/{k}": _np(t) for k, t in p.items()}
    for s in ("master", "m", "v"):
        out.update({f"{s}/{k}": _np(t) for k, t in o[s].items()})
    out["step"] = int(o["step"])
    return out


def _history(tr):
    return [(m["loss"], m["grad_norm"]) for m in tr.metrics_history]


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def lm_four(rank, world, dev, npz):
    """4 ranks: the expert-parallel branch on (1, 4) and (2, 2), the place /
    gather round trip, ``generate`` with experts over ``model`` = 4, and
    the trainer on (2, 2), then ``reshard`` (2, 2) -> (4, 1) -> (1, 1)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer
    z = dict(np.load(npz))
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape)
        out[f"ep{shape}"] = _expert_parallel(z, mesh) + (dict(mesh.coords),)
        out[f"round_trip{shape}"] = _round_trip(mesh)
    out["generate"] = _generate(make_host_mesh(1, 4))

    cfg = moe_cfg()
    one = _trainer(_per_shard(cfg, 2), None, 3)
    m22 = make_host_mesh(2, 2)
    tr = _trainer(cfg, m22, 3)
    out["train(2, 2)"] = (_history(one), _history(tr), _whole_np(one),
                          _whole_np(tr))
    # the stored state is the shards the specs name
    shard_ok = all(torch.equal(tr.pshard[k], t[shd.shard_slices(
        tuple(t.shape), tr.pspecs[k], m22)]) for k, t in tr.params.items())
    out["stored_shards"] = shard_ok and any(
        tr.opt_state["master"][k].numel() < t.numel()
        for k, t in tr.params.items())
    chain = []
    for shape in ((4, 1), (1, 1)):
        before = _whole_np(tr)
        committed = tr._whole(tr.commit_log.committed.params,
                              tr.commit_log.committed.opt_state)
        committed = {k: _np(v) for k, v in committed[0].items()}
        mesh = make_host_mesh(*shape)
        tr.reshard(mesh)
        after = _whole_np(tr)
        c_after = tr._whole(tr.commit_log.committed.params,
                            tr.commit_log.committed.opt_state)
        c_after = {k: _np(v) for k, v in c_after[0].items()}
        p, o = tr.state()
        fresh = Trainer(cfg, tr.tcfg, device="cpu", mesh=mesh)
        fresh.load_state({k: t.clone() for k, t in p.items()},
                         {s: ({k: t.clone() for k, t in o[s].items()}
                              if s != "step" else o[s].clone()) for s in o},
                         step=tr.step)
        tr.run(1)
        fresh.run(1)
        chain.append((_same(before, after), _same(committed, c_after),
                      _same(_whole_np(tr), _whole_np(fresh)),
                      _history(tr)[-1] == _history(fresh)[-1]))
    out["reshard"] = chain
    # the revert keeps its meaning on the last mesh
    back = tr.inject_failure()
    out["revert"] = (back, _same({k: v for k, v in _whole_np(tr).items()
                                  if k.startswith("p/")},
                                 {f"p/{k}": _np(v) for k, v in
                                  tr.commit_log.committed.params.items()}))
    return out


def lm_two(rank, world, dev, ckpt_dir):
    """2 ranks: the trainer on (2, 1) and (1, 2) beside one device; on (2,
    1) with a disk checkpoint, restored by a new trainer on the mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = moe_cfg()
    out = {}
    tcfg = TrainerConfig(seq_len=32, batch=4, steps_per_epoch=2,
                         checkpoint_dir=ckpt_dir)
    for shape in ((2, 1), (1, 2)):
        one = _trainer(_per_shard(cfg, shape[0]), None, 3)
        tr = _trainer(cfg, make_host_mesh(*shape), 3,
                      tcfg if shape == (2, 1) else None)
        out[f"train{shape}"] = (_history(one), _history(tr), _whole_np(one),
                                _whole_np(tr))
        if shape == (2, 1):
            # the fence at step 2 wrote the whole state (rank 0); a new
            # trainer on the mesh restores it as its shards
            c = tr.commit_log.committed
            want = {f"p/{k}": _np(v) for k, v in
                    tr._whole(c.params, c.opt_state)[0].items()}
            back = Trainer(cfg, tcfg, device="cpu",
                           mesh=make_host_mesh(*shape))
            meta = back.restore_from_disk()
            got = {k: v for k, v in _whole_np(back).items()
                   if k.startswith("p/")}
            out["restore"] = (meta["step"], _same(want, got),
                              back.pshard is not None)
    return out


# ---------------------------------------------------------------------------
# the STAR cluster with one process a node
# ---------------------------------------------------------------------------
TPCC4 = dict(n_partitions=4, n_items=400, cust_per_district=40,
             order_ring=64, mix="full", delivery_gen_lag=256)
YCSB_P, YCSB_R, YCSB_TXNS, TPCC_TXNS = 8, 128, 128, 128
DRIVE_EPOCHS = 2
ENGINE_CASES = [("ycsb", False), ("ycsb", True), ("tpcc", False),
                ("tpcc", True)]
FIELDS = ("key", "prow", "tid")


def _copies(tree: dict) -> dict:
    """Copies (``part``/``full``/``sec`` val, tid, idx tensors of all P
    partitions) -> the drive's numpy dict."""
    out = {}
    for c in ("part", "full", "sec"):
        if tree.get(f"{c}_val") is None:
            continue
        out[f"{c}_val"] = _np(tree[f"{c}_val"])
        out[f"{c}_tid"] = _np(tree[f"{c}_tid"])
        for i, ix in enumerate(tree[f"{c}_idx"]):
            for k in FIELDS:
                out[f"{c}_idx/{i}/{k}"] = _np(ix[k])
    return out


class SingleAdapter:
    """The single-process ``ClusterStarEngine`` (the oracle)."""

    def copies(self, eng):
        return _copies({n: getattr(eng, n) for n in (
            "part_val", "part_tid", "part_idx", "full_val", "full_tid",
            "full_idx", "sec_val", "sec_tid", "sec_idx")})

    def load(self, eng, val, tid, idx):
        eng.load_committed(
            torch.tensor(val), torch.tensor(tid),
            indexes=None if idx is None else
            [{k: torch.tensor(v) for k, v in ix.items()} for ix in idx])

    def scribble_node(self, eng, node):
        eng.scribble_node(node)


class DistAdapter(SingleAdapter):
    """``DistClusterStarEngine``: the copies gathered on the master and
    broadcast, so every rank's drive takes the same steps."""

    def copies(self, eng):
        got = eng.gather_copies()
        return eng.comm.broadcast_object(
            _copies(got) if got is not None else None)


def workload(name):
    import _torch_cluster_drive as drv
    from repro_torch.db import tpcc, ycsb
    if name == "ycsb":
        return drv.ycsb_batches(ycsb, YCSB_P, YCSB_R, YCSB_TXNS)
    return drv.tpcc_batches(tpcc, TPCC4, TPCC_TXNS)


def cluster_engine(name, secondary, distributed, device="cpu"):
    from repro_torch.core.cluster import (ClusterStarEngine,
                                          DistClusterStarEngine)
    from repro_torch.db import tpcc
    cfg, init, make, fb = workload(name)
    kw = dict(secondary=secondary, device=device)
    if name == "tpcc":
        kw.update(init_val=init, indexes=tpcc.index_specs(cfg))
        P, R = cfg.n_partitions, cfg.rows_per_partition
    else:
        P, R = YCSB_P, YCSB_R
    eng = (DistClusterStarEngine(P, R, **kw) if distributed
           else ClusterStarEngine(4, P, R, **kw))
    return eng, make, fb


def drive_engine(name, secondary, distributed):
    import _torch_cluster_drive as drv
    eng, make, fb = cluster_engine(name, secondary, distributed)
    adapter = DistAdapter() if distributed else SingleAdapter()
    got = drv.drive(eng, make, fb, adapter, n_epochs=DRIVE_EPOCHS)
    extra = {}
    if distributed:
        _, _, make, _ = workload(name)
        extra["no_collectives"] = eng.partitioned_phase_has_no_collectives(
            make(999))
        extra["calls"] = dict(eng.comm.calls)
        extra["net_bytes"] = dict(eng.net_bytes)
    return got, extra


RUNTIME_CASES = {
    # name: (workload, kills [(node, epoch, slab)], epochs, durability)
    "case1": ("ycsb", [(2, 3, None)], 5, False),
    "midstream": ("ycsb", [(2, 3, 1)], 5, False),
    "case2": ("ycsb", [(0, 3, None)], 5, False),
    "unavailable_wal": ("tpcc", [(0, 4, None), (1, 4, None),
                                 (2, 4, None)], 6, True),
}
EVENT_FIELDS = ("epoch", "failed", "case", "run_mode", "reverted_to",
                "view", "lost_blocks", "reloaded_from_disk",
                "restored_from_secondary", "slabs_discarded",
                "aborted_at_slab")
EPOCH_KEYS = ("committed_single", "committed_cross", "p_committed",
              "c_committed", "node_committed", "op_bytes_overlapped",
              "op_bytes_fence", "index_overflow")


def run_runtime(case, distributed, wal_dir=None, rank=0):
    """One recovery scenario on a 4-node ``ClusterRuntime``: per-epoch
    metrics and ``replica_consistent()``, the recovery events, the final
    copies (gathered), the slab ledger and the stats."""
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import tpcc
    from repro_torch.db.wal import Durability
    name, kills, n_epochs, wal = RUNTIME_CASES[case]
    cfg, init, make, fb = workload(name)
    inj = FaultInjector()
    for node, ep, slab in kills:
        inj.schedule_kill(node, epoch=ep, slab=slab)
    kw = dict(injector=inj, device="cpu", distributed=distributed)
    if name == "tpcc":
        kw.update(init_val=init, indexes=tpcc.index_specs(cfg))
        P, R = cfg.n_partitions, cfg.rows_per_partition
    else:
        P, R = YCSB_P, YCSB_R
    dur = None
    if wal:
        dur = Durability(wal_dir, n_workers=4, checkpoint_every=2,
                         worker=rank if distributed else None)
        kw["durability"] = dur
    rt = ClusterRuntime(4, P, R, **kw)
    out = {"epochs": [], "events": []}
    for ep in range(n_epochs):
        b = make(ep)
        m = rt.run_epoch(b)
        fb(b, m)
        out["epochs"].append({k: np.asarray(m[k]) for k in EPOCH_KEYS})
        out["epochs"][-1]["consistent"] = rt.replica_consistent()
        if "recovery" in m:
            ev = m["recovery"]
            out["events"].append({f: (getattr(ev, f).name if f == "case"
                                      else getattr(ev, f))
                                  for f in EVENT_FIELDS})
            out["events"][-1]["t_recovery_s"] = ev.t_recovery_s
    copies = (DistAdapter() if distributed else SingleAdapter()).copies(
        rt.eng)
    out["copies"] = copies
    out["ledger"] = list(rt.eng.slab_ledger)
    out["slabs_discarded"] = rt.stats.slabs_discarded
    out["committed"] = (rt.stats.committed_single,
                        rt.stats.committed_cross)
    if dur is not None:
        out["entries_logged"] = dur.entries_logged
        dur.close()
    return out


SERVICE_KILL = (3, 6)


def run_service(distributed, batches=None):
    """The node-sharded service (YCSB at 800 txn/s for 1 s, node 3 killed
    at epoch 6) on a distributed runtime; or, with ``batches``, the same
    batches replayed through a single-process runtime.  Returns the
    summary, the batches run and the final copies."""
    import copy
    from repro_torch.cluster import ClusterRuntime, ClusterTxnService
    from repro_torch.cluster.service import serve_cluster
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import ycsb
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     YCSBSource)
    inj = FaultInjector()
    inj.schedule_kill(SERVICE_KILL[0], epoch=SERVICE_KILL[1])
    rt = ClusterRuntime(4, YCSB_P, YCSB_R, injector=inj, device="cpu",
                        distributed=distributed)
    if batches is not None:
        for b in batches:
            rt.run_epoch(copy.deepcopy(b))
        return SingleAdapter().copies(rt.eng), rt.replica_consistent()
    rec = []

    def make_service(runtime):
        run = runtime.run_epoch

        def recorded(batch, ingest=None):
            rec.append(copy.deepcopy(batch))
            return run(batch, ingest=ingest)
        runtime.run_epoch = recorded
        cfg = ycsb.YCSBConfig(n_partitions=YCSB_P,
                              records_per_partition=YCSB_R)
        client = OpenLoopClient(YCSBSource(cfg, seed=1), rate_txn_s=800.0,
                                seed=7)
        return ClusterTxnService(runtime, [client],
                                 AdmissionConfig(64, 64, node_queue_cap=96),
                                 slots_per_partition=16, master_lanes=16)

    svc, out = serve_cluster(rt, make_service, duration_s=1.0)
    consistent = rt.replica_consistent()
    copies = DistAdapter().copies(rt.eng)
    if svc is None:
        return {"followed": out, "consistent": consistent}
    return {"summary": out, "batches": rec, "copies": copies,
            "consistent": consistent,
            "node_committed": rt.eng.node_committed.tolist()}


def cluster_four(rank, world, dev, wal_dir):
    """4 ranks: the engine drive on both workloads with and without the
    secondary copies, the four runtime scenarios, the service."""
    out = {"engine": {}, "runtime": {}}
    for name, secondary in ENGINE_CASES:
        out["engine"][(name, secondary)] = drive_engine(name, secondary,
                                                        True)
    for case in RUNTIME_CASES:
        out["runtime"][case] = run_runtime(case, True,
                                           f"{wal_dir}/{case}", rank)
    out["service"] = run_service(True)
    return out if rank == 0 else {"rank": rank,
                                  "service": out["service"],
                                  "calls": {k: v[1]["calls"] for k, v in
                                            out["engine"].items()}}


# ---------------------------------------------------------------------------
# the read tier and the analytics lane on the cluster with one process a node
# ---------------------------------------------------------------------------
TPCC8 = dict(n_partitions=8, n_items=400, cust_per_district=40,
             order_ring=64, mix="full", delivery_gen_lag=96)
READ_EPOCHS, READ_TXNS = 6, 96
READ_STATS = ("served", "batches", "fallbacks", "stale_violations",
              "replicas_removed", "max_freshness_served",
              "served_by_freshness", "mid_epoch_served",
              "mid_epoch_deferred")
AGGS = ("revenue", "stock_low", "undelivered", "order_latency")


def _group(r):
    return {"replica": r["replica"], "epoch": int(r["epoch"]),
            "freshness": int(r["freshness"]), "slots": r["slots"].copy(),
            "out": {k: _np(v) for k, v in r["out"].items()}}


def _host_figures(rt):
    """This rank's read serving and collective counts (``follow``'s
    side)."""
    h = rt.eng.read_host
    return {"groups": h.groups if h else 0, "reads": h.reads if h else 0,
            "launches": dict(h.launches) if h else {},
            "ring": sorted(h.ring) if h else [],
            "partitioned_collectives": rt.eng.partitioned_collectives}


def read_scenario(distributed, rank=0):
    """TPC-C, P = 8, 4 nodes, node 0 (the master) killed at epoch 3 slab
    1 (FALLBACK_DIST_CC), both lanes: each epoch's read-only requests are
    offered before the epoch, served mid-epoch from the ingest hook and
    after the fence; the analytics lane serves after the fence.  The
    epochs that start from an even fence, when the secondary copies are
    fresh (``sec_refresh_every=2``), write only partitions 0-3, so reads
    of 4-7 serve mid-epoch from every copy.  Returns
    on the master every group, the tier's stats, each fence's aggregates
    and the time travel; on another rank what it served."""
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import tpcc
    from repro_torch.reads import ReadTier
    from repro_torch.service import AdmissionController
    from repro_torch.service.clients import (read_lane_request,
                                             without_writers)
    cfg = tpcc.TPCCConfig(**TPCC8)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(0), state=state)
    inj = FaultInjector()
    inj.schedule_kill(0, epoch=3, slab=1)
    rt = ClusterRuntime(4, 8, cfg.rows_per_partition, init_val=init,
                        indexes=tpcc.index_specs(cfg), injector=inj,
                        device="cpu", distributed=distributed)
    if distributed and rank != 0:
        followed = rt.follow()
        return dict(_host_figures(rt), followed=followed)
    tier = ReadTier(max_staleness_epochs=2, sec_refresh_every=2)
    lane = AnalyticsLane(cfg, stock_threshold=40, retain=4)
    assert lane.ensure_attached(rt)
    tier.observe_epoch(rt)
    tier.attach_changelog(rt.changelog)
    out = {"groups": [], "fences": {}, "events": []}
    for ep in range(READ_EPOCHS):
        raw = tpcc.make_raw(cfg, state, READ_TXNS, np.random.default_rng(ep))
        if ep % 2 == 0:
            raw = without_writers(state, raw, range(4, 8))
        batch = tpcc.make_batch(cfg, state, 0, raw=raw)
        sel = np.nonzero(raw["read_only"])[0]
        adm = AdmissionController(8, cfg.rows_per_partition,
                                  max_ops=raw["rows"].shape[1],
                                  n_cols=raw["deltas"].shape[2],
                                  read_lane=True)
        assert not adm.offer(read_lane_request(raw, sel), 0.0).any()

        def mid_epoch(adm=adm):
            out["groups"] += [dict(_group(r), mid_epoch=True)
                              for r in tier.serve(adm, mid_epoch=True)]
        m = rt.run_epoch(batch, ingest=mid_epoch)
        tpcc.apply_consume_feedback(state, batch, m)
        if "recovery" in m:
            ev = m["recovery"]
            out["events"].append((ev.case.name, ev.aborted_at_slab))
        tier.observe_epoch(rt, m)
        out["groups"] += [dict(_group(r), mid_epoch=False)
                          for r in tier.serve(adm)]
        res = lane.serve(rt.committed_epoch)
        epoch, aggs = lane.views.latest()
        out["fences"][epoch] = ({k: aggs[k].copy() for k in AGGS},
                                res["top_revenue"], res["stock_low"])
    out["time_travel"] = {e: {k: v.copy() for k, v in
                              lane.views.time_travel(e).items()}
                          for e in lane.views.retained_epochs()}
    out["stats"] = {f: getattr(tier.stats, f) for f in READ_STATS}
    out["by_replica"] = tier.catalog.serves_by_replica()
    out["lane"] = {k: v for k, v in lane.summary().items()
                   if not k.startswith("analytics_q_")
                   and k != "analytics_query_s"}
    out["catalog"] = {rid: [e for e, _, _ in ent.snaps]
                      for rid, ent in tier.catalog.entries.items()}
    if distributed:
        out["remote"] = rt.read_peers.stats
        rt.stop_followers()
        out.update(master=_host_figures(rt))
    return out


READ_SERVICE_KILL = (2, 5)


def read_service(rank):
    """``serve_cluster`` with both lanes over TPC-C (P = 8), node 2 killed
    at epoch 5: every group checked against ``reference_read`` of its
    fence's committed full copy, the views' stamp against ``recompute``
    at every fence, ``replica_consistent()`` after every epoch (the other
    ranks' side through ``follow``'s ``on_epoch``)."""
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.cluster import ClusterRuntime, ClusterTxnService
    from repro_torch.cluster.service import serve_cluster
    from repro_torch.core.fault import FaultInjector
    from repro_torch.db import tpcc
    from repro_torch.reads import ReadTier, reference_read
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource)
    cfg = tpcc.TPCCConfig(**TPCC8)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(0), state=state)
    inj = FaultInjector()
    inj.schedule_kill(READ_SERVICE_KILL[0], epoch=READ_SERVICE_KILL[1])
    rt = ClusterRuntime(4, 8, cfg.rows_per_partition, init_val=init,
                        indexes=tpcc.index_specs(cfg), injector=inj,
                        device="cpu", distributed=True)
    consistent = []
    checks = {"groups": 0, "mismatch": [], "stamps": 0, "stamp_bad": [],
              "mid_epoch_groups": 0, "remote_groups": 0}

    def on_epoch(m):
        consistent.append(rt.replica_consistent())

    def make_service(runtime):
        tier = ReadTier(max_staleness_epochs=2, sec_refresh_every=2)
        lane = AnalyticsLane(cfg, stock_threshold=40, retain=4)
        full = {}
        observe, serve, run = tier.observe_epoch, tier.serve, rt.run_epoch

        def observed(engine, metrics=None):
            observe(engine, metrics)
            v = engine.read_views()[0]
            full[int(v["epoch"])] = {
                "val": _np(v["val"]), "tid": _np(v["tid"]),
                "idx": [{k: _np(ix[k]) for k in FIELDS} for ix in v["idx"]]}

        def served(adm, now_s=0.0, limit=None, mid_epoch=False):
            res = serve(adm, now_s, limit=limit, mid_epoch=mid_epoch)
            pool = adm.pool
            for r in res:
                s = r["slots"]
                want = reference_read(full[int(r["epoch"])],
                                      pool.home[s].astype(np.int64),
                                      pool.row[s], pool.kind[s],
                                      pool.delta[s])
                ok = all(np.array_equal(_np(r["out"][k]), w)
                         for k, w in want.items())
                checks["groups"] += 1
                checks["mid_epoch_groups"] += mid_epoch
                checks["remote_groups"] += r["replica"] not in ("full",
                                                                "sec0")
                if not ok:
                    checks["mismatch"].append((r["replica"], r["epoch"]))
            return res

        def fenced(batch, ingest=None):
            m = run(batch, ingest=ingest)
            consistent.append(rt.replica_consistent())
            if lane.views.attached:
                e, aggs = lane.views.latest()
                want = lane.views.recompute(rt.committed_state()[0])
                checks["stamps"] += 1
                if e != rt.committed_epoch or not all(
                        np.array_equal(aggs[k], want[k]) for k in want):
                    checks["stamp_bad"].append(e)
            return m
        tier.observe_epoch, tier.serve = observed, served
        runtime.run_epoch = fenced
        client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                                rate_txn_s=1500.0, seed=3)
        return ClusterTxnService(
            runtime, [client], AdmissionConfig(256, 256, node_queue_cap=512),
            slots_per_partition=16, master_lanes=16, read_tier=tier,
            analytics=lane, feedback=lambda b, m:
            tpcc.apply_consume_feedback(state, b, m))

    svc, out = serve_cluster(rt, make_service, on_epoch=on_epoch,
                             duration_s=30.0, max_epochs=8)
    res = {"consistent": all(consistent) and len(consistent) > 0,
           "final_consistent": rt.replica_consistent()}
    res.update(_host_figures(rt))
    if svc is None:
        return res
    for c in svc.clients:
        c.shutdown()
    res.update(summary={k: out[k] for k in (
        "epochs", "committed", "recoveries", "read_served",
        "read_stale_violations", "read_mid_epoch_served",
        "analytics_serves", "read_by_replica")}, checks=checks,
        remote=rt.read_peers.stats,
        cases=[e.case.name for e in svc.recovery_events])
    return res


def reads_four(rank, world, dev):
    """4 ranks: the read scenario, then the service with both lanes."""
    return {"scenario": read_scenario(True, rank),
            "service": read_service(rank)}
