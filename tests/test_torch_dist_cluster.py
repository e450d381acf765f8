"""The STAR cluster with one process a node (``torch.distributed``, 4 gloo
ranks on the CPU): ``core.cluster.DistClusterStarEngine``,
``ClusterRuntime(..., distributed=True)`` and the node-sharded service,
each held bit-equal (tolerance 0: every value is an integer) to the
single-process port (``ClusterStarEngine(4, ...)``, ``ClusterRuntime(4,
...)``) fed the same batches — the oracle ``tests/test_torch_cluster.py``
holds to the JAX cluster engine.

One bounded spawn (``launch.mesh.spawn``: a ``FileStore`` in
``tmp_path``, one intra-op thread a rank, a 60 s group timeout, a parent
deadline) runs every distributed check while this process runs the
single-process oracles; the rank bodies are ``tests/_torch_dist_ranks.py``:

- the engine: ``tests/_torch_cluster_drive.py::drive`` (epochs, a
  ``commit=False`` epoch and its revert, a mid-stream abort, node scribble
  and donor restore, full-replica loss and rebuild, ``load_committed``) on
  YCSB (P = 8 x 128) and the full TPC-C mix (P = 4), with the secondary
  copies off and on: every metric, copy and index segment after every
  step; the partitioned phase makes zero collective calls;
- the runtime: the three recovery cases (a partial node, PHASE_SWITCHING;
  a mid-stream kill; the full-replica node, FALLBACK_DIST_CC from the
  physical secondary copy) and UNAVAILABLE under the full TPC-C mix,
  reloaded from the ranks' write-ahead logs: per-epoch metrics, the
  recovery events, the final copies, the slab ledger, and the log files
  themselves (file for file);
- the service: ``serve_cluster`` with node 3 killed at epoch 6; the
  batches it ran, replayed through the single-process runtime, give the
  same copies.
"""
import filecmp
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
    """(the 4 ranks' results, the single-process oracles, the WAL
    directories)."""
    tmp = tmp_path_factory.mktemp("dist_cluster")
    box = {}

    def ranks_run():
        try:
            box["dist"] = spawn(ranks.cluster_four, 4,
                                args=(str(tmp / "wal_dist"),), device="cpu",
                                timeout_s=300, workdir=tmp / "spawn")
        except BaseException as e:          # re-raised in the test thread
            box["error"] = e

    t = threading.Thread(target=ranks_run)
    t.start()
    try:
        one = {"engine": {c: ranks.drive_engine(*c, False)
                          for c in ranks.ENGINE_CASES},
               "runtime": {c: ranks.run_runtime(c, False,
                                                str(tmp / "wal_one" / c))
                           for c in ranks.RUNTIME_CASES}}
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return box["dist"], one, tmp


def _equal(a, b, what):
    assert a.keys() == b.keys(), (what, sorted(set(a) ^ set(b)))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        assert np.array_equal(x, y), (what, k, np.argwhere(x != y)[:5])


@pytest.mark.parametrize("case", ranks.ENGINE_CASES,
                         ids=[f"{n}-{'sec' if s else 'nosec'}"
                              for n, s in ranks.ENGINE_CASES])
def test_engine_bit_equal_to_single_process(runs, case):
    """Every metric, copy (secondary copies included) and index segment of
    every step of the drive equal to the single-process engine's; the
    partitioned phase made no collective call; the slabs crossed the group
    as sends."""
    dist, one, _ = runs
    got, extra = dist[0]["engine"][case]
    want, _ = one["engine"][case]
    _equal(want, got, case)
    assert bool(got["ep0/consistent"]) and bool(got["final/consistent"])
    assert extra["no_collectives"]
    calls = [extra["calls"]] + [r["calls"][case] for r in dist[1:]]
    assert all(c["send"] > 0 and c["recv"] > 0 for c in calls)
    assert extra["net_bytes"]["slab_ship"] > 0
    assert extra["net_bytes"]["batch"] > 0


@pytest.mark.parametrize("case", list(ranks.RUNTIME_CASES))
def test_runtime_recovery_bit_equal_to_single_process(runs, case):
    """The scenario's per-epoch metrics, ``replica_consistent()`` at every
    fence, recovery events, final copies, slab ledger and stats equal to
    the single-process runtime's; with the WAL, the ranks' log files equal
    the single-process runtime's file for file."""
    dist, one, tmp = runs
    got, want = dist[0]["runtime"][case], one["runtime"][case]
    assert len(got["epochs"]) == len(want["epochs"])
    for i, (g, w) in enumerate(zip(got["epochs"], want["epochs"])):
        _equal(w, g, (case, i))
        assert g["consistent"]
    strip = [{k: v for k, v in e.items() if k != "t_recovery_s"}
             for e in got["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "t_recovery_s"}
                     for e in want["events"]]
    assert len(strip) == 1 and got["events"][0]["t_recovery_s"] > 0
    want_case = {"case1": "PHASE_SWITCHING", "midstream": "PHASE_SWITCHING",
                 "case2": "FALLBACK_DIST_CC",
                 "unavailable_wal": "UNAVAILABLE"}[case]
    assert strip[0]["case"] == want_case
    if case == "midstream":
        assert strip[0]["aborted_at_slab"] == 1
    if case == "case2":
        assert strip[0]["restored_from_secondary"] == (0,)
    _equal(want["copies"], got["copies"], case)
    assert got["ledger"] == want["ledger"]
    assert got["slabs_discarded"] == want["slabs_discarded"]
    assert got["committed"] == want["committed"]
    if case == "unavailable_wal":
        assert strip[0]["reloaded_from_disk"]
        d1, d2 = tmp / "wal_dist" / case, tmp / "wal_one" / case
        names = sorted(p.name for p in d1.iterdir())
        assert names == sorted(p.name for p in d2.iterdir())
        assert any(n.startswith("wal_") for n in names)
        _, mismatch, errors = filecmp.cmpfiles(d1, d2, names, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
        assert got["entries_logged"] > 0


def test_node_sharded_service(runs):
    """The service on the master with the other ranks following: it
    committed, recovered node 3's kill, kept the replicas consistent, and
    its batches replayed through the single-process runtime give the same
    copies."""
    dist, _, _ = runs
    s = dist[0]["service"]
    out = s["summary"]
    assert s["consistent"] and out["committed"] > 0
    assert out["recoveries"] == 1 and out["recovery_latency_s"][0] > 0
    assert len(out["node_committed"]) == 4
    assert all(r["service"]["followed"] == len(s["batches"])
               and r["service"]["consistent"] for r in dist[1:])
    copies, consistent = ranks.run_service(False, batches=s["batches"])
    assert consistent
    _equal(copies, s["copies"], "service")
