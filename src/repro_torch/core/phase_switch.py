"""Phase-switching controller (§4.3, Eqs 1-2).

    tau_p + tau_s = e                        (1)
    tau_s*t_s / (tau_p*t_p + tau_s*t_s) = P  (2)

t_p, t_s are monitored throughputs (txn/s) of the two phases; P is the
cross-partition fraction; e the iteration time.  Solving:

    tau_s = e * P*t_p / ((1-P)*t_s + P*t_p),    tau_p = e - tau_s

with the paper's edge case P = 0 -> (tau_p, tau_s) = (e, 0).

The port keeps the controller the engine feeds (the service layer's
adaptive epoch length waits for the service slice).
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

    def plan(self):
        tau_p, tau_s = solve_phase_times(self.e_ms, self.t_p, self.t_s,
                                         self.frac_cross)
        self.history.append((tau_p, tau_s))
        return tau_p, tau_s
