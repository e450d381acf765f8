"""Analytical model (§6.3, Eqs 3-5) — Figures 3 and 10 derive from these.
Port of ``repro.core.analytical`` (numpy, copied).

  T_part(n)  = (n_s*t_s + n_c*t_c)/n                       (3)
  T_nonpart(n) = (n_s + n_c)*t_s                           (4)
  T_STAR(n)  = (n_s/n + n_c)*t_s                           (5)

With K = t_c/t_s and P = n_c/(n_c+n_s):

  I_part(n)    = (K*P - P + 1)/(n*P - P + 1)
  I_nonpart(n) = n/(n*P - P + 1)
  I(n)         = n/(n*P - P + 1)          (STAR speedup over one node)
"""
from __future__ import annotations

import numpy as np


def t_partitioning(n, n_s, n_c, t_s, t_c):
    return (n_s * t_s + n_c * t_c) / n


def t_nonpartitioned(n, n_s, n_c, t_s):
    return (n_s + n_c) * t_s


def t_star(n, n_s, n_c, t_s):
    return (n_s / n + n_c) * t_s


def improvement_over_partitioning(n, P, K):
    P = np.asarray(P, dtype=np.float64)
    return (K * P - P + 1.0) / (n * P - P + 1.0)


def improvement_over_nonpartitioned(n, P):
    P = np.asarray(P, dtype=np.float64)
    return n / (n * P - P + 1.0)


def star_speedup(n, P):
    """I(n) = T_STAR(1)/T_STAR(n) — Figure 3."""
    P = np.asarray(P, dtype=np.float64)
    return n / (n * P - P + 1.0)


def crossover_K(n):
    """STAR beats partitioning-based systems when K > n (§6.3)."""
    return float(n)
