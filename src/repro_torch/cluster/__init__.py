"""Distributed cluster runtime, port of ``repro.cluster``: the full online
pipeline over simulated nodes on one card — node-sharded
ingest/admission/batching, cluster-wide epoch fences with
coordinator-driven phase switching, asymmetric replication (f full-replica
nodes on the single-master value stream, k partial nodes replaying the
partitioned op stream), live failure injection, and §4.5 recovery with
per-worker write-ahead logs + fuzzy checkpoints."""
from repro_torch.cluster.coordinator import Coordinator, RecoveryEvent
from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.cluster.service import ClusterTxnService

__all__ = ["Coordinator", "RecoveryEvent", "ClusterRuntime",
           "ClusterTxnService"]
