"""Phase-switching controller (§4.3, Eqs 1-2), port of
``repro.core.phase_switch``.

    tau_p + tau_s = e                        (1)
    tau_s*t_s / (tau_p*t_p + tau_s*t_s) = P  (2)

t_p, t_s are monitored throughputs (txn/s) of the two phases; P is the
cross-partition fraction; e the iteration time.  Solving:

    tau_s = e * P*t_p / ((1-P)*t_s + P*t_p),    tau_p = e - tau_s

with the paper's edge case P = 0 -> (tau_p, tau_s) = (e, 0).

Adaptive epoch length (SCAR/Lion-style reaction to the observed mix): with
``adaptive=True`` the controller drives ``e_ms`` from the measured
enqueue→formation queue-delay EMA the service layer feeds in through
``observe_latency``.  Under epoch group commit the ideal queue delay is
~e/2 (arrivals wait half an epoch on average), so the controller steers
``e_ms`` toward ``2 * queue_delay`` — longer epochs when measured delay
says batches form slower than the epoch turns (amortize fences), shorter
when the system is underloaded (cut latency) — clamped to
[e_min_ms, e_max_ms] and EMA-smoothed so a burst cannot whipsaw the epoch.
The flag defaults to OFF: fig12's fixed 10 ms epochs stay reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field


DEFAULT_ITERATION_MS = 10.0        # paper default (§4.3, §7.4)


def solve_phase_times(e_ms: float, t_p: float, t_s: float, frac_cross: float):
    P = min(max(frac_cross, 0.0), 1.0)
    if P <= 0.0 or t_s <= 0.0:
        return e_ms, 0.0
    if P >= 1.0 or t_p <= 0.0:
        return 0.0, e_ms
    tau_s = e_ms * P * t_p / ((1.0 - P) * t_s + P * t_p)
    return e_ms - tau_s, tau_s


@dataclass
class PhaseController:
    """Tracks real-time throughput telemetry and yields (tau_p, tau_s)."""
    e_ms: float = DEFAULT_ITERATION_MS
    ema: float = 0.5
    t_p: float = 0.0               # partitioned-phase txn/s (EMA)
    t_s: float = 0.0               # single-master txn/s (EMA)
    frac_cross: float = 0.0
    queue_delay_ms: float = 0.0    # measured enqueue→batch-formation (EMA)
    measured_commit_ms: float = 0.0  # measured enqueue→commit-fence (EMA)
    fence_wait_ms: float = 0.0     # cluster: max per-node fence wait (EMA)
    adaptive: bool = False         # drive e_ms from the queue-delay EMA
    e_min_ms: float = 2.0
    e_max_ms: float = 50.0
    adapt_gain: float = 0.25       # per-observation step toward the target
    history: list = field(default_factory=list)

    def observe(self, phase: str, n_txns: int, elapsed_s: float,
                frac_cross: float | None = None):
        if elapsed_s <= 0:
            return
        rate = n_txns / elapsed_s
        if phase == "partitioned":
            self.t_p = rate if self.t_p == 0 else (
                self.ema * rate + (1 - self.ema) * self.t_p)
        else:
            self.t_s = rate if self.t_s == 0 else (
                self.ema * rate + (1 - self.ema) * self.t_s)
        if frac_cross is not None:
            self.frac_cross = frac_cross

    def observe_latency(self, queue_delay_ms: float,
                        commit_latency_ms: float | None = None):
        """Feed *measured* end-to-end latency from the service layer
        (enqueue→formation queue delay, and optionally enqueue→commit-fence)
        so Eq. 1–2 planning and latency reporting reflect live traffic
        instead of the synthetic U(0, e) assumption."""
        if queue_delay_ms >= 0:
            self.queue_delay_ms = queue_delay_ms if self.queue_delay_ms == 0 \
                else (self.ema * queue_delay_ms
                      + (1 - self.ema) * self.queue_delay_ms)
        if commit_latency_ms is not None and commit_latency_ms >= 0:
            self.measured_commit_ms = commit_latency_ms \
                if self.measured_commit_ms == 0 \
                else (self.ema * commit_latency_ms
                      + (1 - self.ema) * self.measured_commit_ms)
        if self.adaptive and self.queue_delay_ms > 0:
            # group-commit ideal: queue delay ≈ e/2 -> steer e toward
            # 2 * measured delay, bounded and low-pass filtered
            target = min(max(2.0 * self.queue_delay_ms, self.e_min_ms),
                         self.e_max_ms)
            self.e_ms += self.adapt_gain * (target - self.e_ms)

    def observe_fence_wait(self, max_wait_ms: float):
        """Cluster coordinator telemetry: the slowest node sets the fence;
        everyone else waits.  The EMA of that worst-case wait quantifies
        per-node skew (fig13 reports it) and is the §4.3 signal a deployment
        would use to rebalance partitions across nodes."""
        if max_wait_ms < 0:
            return
        self.fence_wait_ms = max_wait_ms if self.fence_wait_ms == 0 else (
            self.ema * max_wait_ms + (1 - self.ema) * self.fence_wait_ms)

    def plan(self):
        tau_p, tau_s = solve_phase_times(self.e_ms, self.t_p, self.t_s,
                                         self.frac_cross)
        self.history.append((tau_p, tau_s))
        return tau_p, tau_s

    def expected_mean_latency_ms(self) -> float:
        """§4.3: deferral is symmetric; mean latency ≈ (tau_p + tau_s)/2 —
        used until the service layer reports a measured figure, after which
        the measured enqueue→commit EMA wins."""
        if self.measured_commit_ms > 0:
            return self.measured_commit_ms
        return self.e_ms / 2.0
