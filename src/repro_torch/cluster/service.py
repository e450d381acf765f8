"""ClusterTxnService: the online transaction service sharded over the
cluster's nodes, port of ``repro.cluster.service``.

``service.TxnService`` already speaks the engine metric surface, so the
cluster variant is the same epoch pipeline — open-loop clients → admission
→ double-buffered batch formation → ``run_epoch`` — with the node topology
threaded through:

* **node-sharded admission** — the partition→node map gives every node a
  bounded ingest budget (``AdmissionConfig.node_queue_cap``) on top of the
  per-partition caps, and sheds/depths are attributed per node;
* **node-sharded batching** — the batcher's (P, T) formation is block-
  contiguous per node (partition p belongs to node p // ppn), so each
  node's block of the partitioned phase receives exactly its own node's
  queues;
* **per-node telemetry** — every epoch samples per-node queue depth and
  accumulates shed counts; together with the engine's per-node committed /
  fence-wait arrays, fig12/fig13 report per-node skew;
* **recovery events** — epochs that detected a failure carry the
  :class:`RecoveryEvent`; the service collects them and reports recovery
  latency in the summary.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.service.admission import AdmissionConfig
from repro_torch.service.service import TxnService


class ClusterTxnService(TxnService):
    def __init__(self, runtime: ClusterRuntime, clients: list,
                 admission_cfg: AdmissionConfig | None = None,
                 slots_per_partition: int = 64, master_lanes: int = 64,
                 max_ops: int | None = None, feedback=None, read_tier=None,
                 analytics=None):
        self.node_of_partition = np.arange(runtime.P) // runtime.topology.ppn
        super().__init__(runtime, clients, admission_cfg,
                         slots_per_partition=slots_per_partition,
                         master_lanes=master_lanes, max_ops=max_ops,
                         feedback=feedback,
                         node_of_partition=self.node_of_partition,
                         read_tier=read_tier, analytics=analytics)
        self.runtime = runtime
        N = runtime.n_nodes
        self.node_depth_max = np.zeros(N, np.int64)
        self.recovery_events = []
        # per-node telemetry under one namespace: cluster.node<k>.* plus
        # the recovery ledger — read live at every registry snapshot
        self.metrics.register_provider("cluster", self._node_metrics)

    def _node_metrics(self) -> dict:
        eng = self.runtime.eng
        shed = self.node_shed()
        out = {}
        for k in range(self.runtime.n_nodes):
            out[f"node{k}.committed"] = int(eng.node_committed[k])
            out[f"node{k}.fence_wait_s"] = float(eng.node_fence_wait_s[k])
            out[f"node{k}.queue_depth_max"] = int(self.node_depth_max[k])
            out[f"node{k}.shed"] = int(shed[k])
        out["recoveries"] = len(self.recovery_events)
        out["recovery_latency_s"] = float(
            sum(e.t_recovery_s for e in self.recovery_events))
        return out

    # ------------------------------------------------------------------
    def _observe_epoch(self, metrics: dict):
        part_depth, _ = self.admission.depths()
        by_node = np.bincount(self.node_of_partition, weights=part_depth,
                              minlength=self.runtime.n_nodes).astype(np.int64)
        np.maximum(self.node_depth_max, by_node, out=self.node_depth_max)
        if "recovery" in metrics:
            self.recovery_events.append(metrics["recovery"])
        super()._observe_epoch(metrics)

    def node_shed(self) -> np.ndarray:
        """Rejected-arrival counts grouped by owning node (master-queue
        rejections charge the designated master, node 0).  Indexes the
        P + 2 attribution layout EXPLICITLY — the read-lane slot (index
        P + 1) is a cluster-wide lane, reported separately as ``read_shed``,
        never charged to a node (``rq[:-1]``/``rq[-1]`` here would
        silently misattribute read-lane sheds to the master)."""
        P = self.admission.P
        rq = self.admission.stats.rejected_by_queue
        by_node = np.bincount(self.node_of_partition, weights=rq[:P],
                              minlength=self.runtime.n_nodes).astype(np.int64)
        by_node[0] += int(rq[P])
        return by_node

    def summary(self) -> dict:
        out = super().summary()
        eng = self.runtime.eng
        out.update({
            "node_committed": eng.node_committed.tolist(),
            "node_fence_wait_s": [round(float(x), 6)
                                  for x in eng.node_fence_wait_s],
            "node_queue_depth_max": self.node_depth_max.tolist(),
            "node_shed": self.node_shed().tolist(),
            "fence_wait_ema_ms": round(eng.controller.fence_wait_ms, 3),
            "recoveries": len(self.recovery_events),
            "recovery_latency_s": [round(e.t_recovery_s, 4)
                                   for e in self.recovery_events],
            # §5 in-phase op-stream shipping: bytes that overlapped
            # execution vs the unshipped tail the fences waited on
            "op_bytes_overlapped": int(eng.stats.op_bytes_overlapped),
            "op_bytes_fence": int(eng.stats.op_bytes_fence),
            "slabs_shipped": int(eng.stats.slabs_shipped),
            "slabs_discarded": int(eng.stats.slabs_discarded),
            "read_shed": int(
                self.admission.stats.rejected_by_queue[self.admission.P + 1]),
        })
        return out


def serve_cluster(runtime: ClusterRuntime, make_service, on_epoch=None,
                  **run_kw):
    """The node-sharded service with one process a node (a
    ``ClusterRuntime(..., distributed=True)`` on every rank): the master
    (rank 0) builds the service with ``make_service(runtime)``, whose
    batcher gives each node's block of the partitioned phase that node's
    own queues, runs it (``run_kw``) and then ends the other ranks'
    :meth:`ClusterRuntime.follow`.  A service with ``read_tier=`` and
    ``analytics=`` runs both lanes on the master; the other ranks serve
    the read groups sent to the copies they hold from inside ``follow``.
    ``on_epoch`` is ``follow``'s (the other ranks' side of collective
    calls the master makes after each epoch).  Returns (service,
    summary) on the master, (None, epochs followed) elsewhere."""
    if not runtime.eng.is_master:
        return None, runtime.follow(on_epoch)
    svc = make_service(runtime)
    out = svc.run(**run_kw)
    runtime.stop_followers()
    return svc, out
