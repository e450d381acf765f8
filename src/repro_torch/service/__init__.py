"""Online transaction service layer in front of `StarEngine` (§4.3), port
of ``repro.service``.

clients → admission (bounded queues, shed/backpressure, re-route) →
epoch-pipelined batcher (double-buffered against device execution) →
engine → commit-fence latency stamping.
"""
from repro_torch.service.admission import (AdmissionConfig,
                                           AdmissionController, BACKPRESSURE,
                                           RequestPool, SHED)
from repro_torch.service.batcher import BatchPlan, EpochBatcher
from repro_torch.service.clients import (ClosedLoopClient, OpenLoopClient,
                                         TPCCSource, YCSBSource)
from repro_torch.service.latency import LatencyRecorder, LatencySummary
from repro_torch.service.service import ServiceStats, TxnService

__all__ = [
    "AdmissionConfig", "AdmissionController", "BACKPRESSURE", "BatchPlan",
    "ClosedLoopClient", "EpochBatcher", "LatencyRecorder", "LatencySummary",
    "OpenLoopClient", "RequestPool", "SHED", "ServiceStats", "TPCCSource",
    "TxnService", "YCSBSource",
]
