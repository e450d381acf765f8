"""The read tier and the analytics lane on the STAR cluster with one process
a node (``torch.distributed``, 4 gloo ranks on the CPU): the master's
``ReadTier`` and ``AnalyticsLane`` over ``ClusterRuntime(4, 8, ...,
distributed=True)``, held bit-equal (tolerance 0: every value is an
integer) to the single-process ``ClusterRuntime(4, 8, ...)`` fed the same
batches, the oracle ``tests/test_torch_cluster_runtime.py`` holds to the
JAX engine.

One bounded spawn (``launch.mesh.spawn``) runs, on the ranks of
``tests/_torch_dist_ranks.py``, while this process runs the oracle:

- the scenario of ``tests/test_torch_cluster_runtime.py``'s cluster read
  and MV properties: TPC-C, P = 8, node 0 (the master) killed mid-stream
  at epoch 3, slab 1 (FALLBACK_DIST_CC), each epoch's read-only requests
  served mid-epoch (the ingest hook) and after the fence: every group's
  (replica, epoch, freshness, slots, out), ``ReadTier.stats``, each
  fence's view aggregates and the time travel equal the oracle's; no
  partitioned phase made a collective call, mid-epoch serving included;
  the groups sent to ``sec{m}`` ran on rank m (its plain ``scan_window``
  dispatches show it);
- ``serve_cluster`` with both lanes and node 2 killed: no stale read,
  each group equal to ``reference_read`` of its fence's committed copy,
  the views' stamp equal to ``recompute`` at every fence, the copies
  consistent after every epoch.
"""
import threading

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch.launch.mesh import spawn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 ranks' results, the single-process scenario)."""
    tmp = tmp_path_factory.mktemp("dist_reads")
    box = {}

    def ranks_run():
        try:
            box["dist"] = spawn(ranks.reads_four, 4, device="cpu",
                                timeout_s=240, workdir=tmp / "spawn")
        except BaseException as e:          # re-raised in the test thread
            box["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        one = ranks.read_scenario(False)
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return box["dist"], one


def _same_out(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_read_groups_bit_equal_to_single_process(runs):
    """Every group, mid-epoch and at the fence, in order: the replica the
    catalog chose, the snapshot epoch, the freshness, the slots and the
    outputs; the tier's stats and the catalog's retained epochs."""
    dist, one = runs
    got = dist[0]["scenario"]
    assert len(got["groups"]) == len(one["groups"]) > 0
    for i, (g, w) in enumerate(zip(got["groups"], one["groups"])):
        assert (g["replica"], g["epoch"], g["freshness"], g["mid_epoch"]) \
            == (w["replica"], w["epoch"], w["freshness"], w["mid_epoch"]), i
        assert np.array_equal(g["slots"], w["slots"]), i
        assert _same_out(g["out"], w["out"]), (i, g["replica"])
    assert got["stats"] == one["stats"]
    assert got["stats"]["stale_violations"] == 0
    assert got["stats"]["mid_epoch_served"] > 0
    assert got["by_replica"] == one["by_replica"]
    assert got["catalog"] == one["catalog"]
    assert got["events"] == one["events"] == [("FALLBACK_DIST_CC", 1)]


def test_views_and_time_travel_bit_equal_to_single_process(runs):
    """Each fence's aggregates and query answers, the time travel to every
    retained epoch, and the lane's counters (the revert included)."""
    dist, one = runs
    got = dist[0]["scenario"]
    assert sorted(got["fences"]) == sorted(one["fences"])
    for e, (aggs, top, low) in one["fences"].items():
        g_aggs, g_top, g_low = got["fences"][e]
        assert all(np.array_equal(g_aggs[k], aggs[k]) for k in aggs), e
        assert (g_top, g_low) == (top, low), e
    assert sorted(got["time_travel"]) == sorted(one["time_travel"])
    for e, tt in one["time_travel"].items():
        assert all(np.array_equal(got["time_travel"][e][k], v)
                   for k, v in tt.items()), e
    assert got["lane"] == one["lane"]
    assert got["lane"]["analytics_mv_reverts"] == 1


def test_sec_groups_ran_on_their_rank_without_collectives(runs):
    """A group the catalog sent to ``sec{m}`` (m > 0) ran on rank m: rank
    m's executor served exactly those groups and dispatched its plain
    ``scan_window``; each rank's ring kept the master's entry's epochs;
    no partitioned phase on any rank made a collective call."""
    dist, _ = runs
    got = dist[0]["scenario"]
    for m in range(1, 4):
        mine = [g for g in got["groups"] if g["replica"] == f"sec{m}"]
        host = dist[m]["scenario"]
        assert host["groups"] == len(mine), m
        assert host["reads"] == sum(g["slots"].size for g in mine), m
        assert host["ring"] == got["catalog"][f"sec{m}"], m
        if mine:
            assert host["launches"].get("scan_window", 0) > 0, m
    assert sum(dist[m]["scenario"]["groups"] for m in (1, 2, 3)) > 0
    assert got["remote"]["mid_epoch"]["groups"] + \
        got["remote"]["fence"]["groups"] == sum(
            dist[m]["scenario"]["groups"] for m in (1, 2, 3))
    assert got["remote"]["mid_epoch"]["groups"] > 0
    assert got["master"]["groups"] == 0       # the master hosts no ring
    figures = [got["master"]] + [r["scenario"] for r in dist[1:]]
    for r, f in zip(dist, figures):
        assert f["partitioned_collectives"] == 0
        assert r["service"]["partitioned_collectives"] == 0


def test_serve_cluster_with_both_lanes(runs):
    """The service on the master, the other ranks following: node 2's
    kill recovered, reads served (some by other ranks, some mid-epoch),
    none stale, each equal to ``reference_read`` of its fence; the views'
    stamp equal to ``recompute`` at every fence; the copies consistent
    after every epoch on every rank."""
    dist, _ = runs
    s = dist[0]["service"]
    out, chk = s["summary"], s["checks"]
    assert s["cases"] == ["PHASE_SWITCHING"]
    assert out["read_served"] > 0 and out["read_stale_violations"] == 0
    assert out["analytics_serves"] > 0
    assert chk["groups"] > 0 and chk["mismatch"] == []
    assert chk["remote_groups"] > 0
    assert chk["stamps"] > 0 and chk["stamp_bad"] == []
    for r in dist:
        assert r["service"]["consistent"] and r["service"]["final_consistent"]
    assert sum(dist[m]["service"]["groups"] for m in (1, 2, 3)) \
        == chk["remote_groups"]


def test_end_at_a_slab_boundary_closes_the_phase():
    """The master ends a phase's reads once its own ingest hook is done; a
    slower rank can take that END at one of its slab boundaries: it serves
    what came before, stops listening, and its wait after the last slab
    returns at once (no group needed: a request queue stands in for the
    master)."""
    from types import SimpleNamespace

    from repro_torch.reads.remote import ReadHost

    queue = [{"op": "ring", "keep": []}, {"op": "end"}]

    class Pending:
        def __init__(self):
            self.req = queue.pop(0) if queue else None

        def done(self):
            return self.req is not None

        def take(self):
            assert self.req is not None, "waited for a request never sent"
            return self.req

    comm = SimpleNamespace(post_obj=lambda src, tag: Pending())
    host = ReadHost(SimpleNamespace(comm=comm, committed_epoch=0))
    host.phase_begin()
    host.poll()                      # a slab boundary: RING, then END
    assert host._pending is None and host.ring == {}
    host.poll()                      # a later boundary: nothing to do
    host.poll(wait=True)             # after the last slab: returns
    assert queue == []
