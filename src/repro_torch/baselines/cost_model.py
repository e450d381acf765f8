"""Calibrated cluster cost model for the evaluation baselines (§7) — the
port keeps the network envelope the engine's fence model uses (the
baseline throughput models wait for the benchmark slice).

The transaction *algorithms* (OCC rounds, lock conflicts, replication
streams) execute for real in the vectorized engine; absolute wall-clock
throughput on a 4-node EC2 cluster is then derived from:

  * measured per-transaction CPU cost on this host (calibration),
  * the paper's hardware envelope: 12 workers/node, 4.8 Gbit/s NIC,
    ~100 us same-AZ RTT.

EXPERIMENTS.md labels every number derived through this model as
"model-derived (calibrated)". Ratios between systems — what Fig. 11/13/16
actually claim — depend only on the message/byte patterns and measured
conflict behaviour, not on the absolute CPU scale factor.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Network:
    bandwidth_Bps: float = 4.8e9 / 8       # 4.8 Gbit/s (paper, iperf)
    rtt_s: float = 100e-6                  # same-AZ round trip
    def transfer_s(self, nbytes: float) -> float:
        return nbytes / self.bandwidth_Bps
