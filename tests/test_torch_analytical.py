"""PyTorch port vs JAX reference: the §6.3 analytical model (the checks of
tests/test_phase_analytical.py on both modules, whose outputs must be
equal to the last bit) and ``baselines.calibrate``'s non-timing fields
(retry factor, replication bytes, remote reads) from the real executors
on the same batch, tolerance 0."""
import numpy as np
import pytest

from repro.baselines.calibrate import calibrate as jcalibrate
from repro.core import analytical as jan
from repro.core.phase_switch import solve_phase_times as jsolve
from repro_torch.baselines.calibrate import calibrate as tcalibrate
from repro_torch.baselines.cost_model import Calibration
from repro_torch.core import analytical as tan
from repro_torch.core.phase_switch import solve_phase_times


def _draws(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0, 1)), float(rng.uniform(1e3, 1e7)),
             float(rng.uniform(1e3, 1e7)), float(rng.uniform(1, 100)))
            for _ in range(n)] + [(0.0, 1e6, 1e6, 10.0), (1.0, 1e3, 1e7, 1.0)]


@pytest.mark.parametrize("P, tp, ts, e", _draws(40))
def test_eq12_solution(P, tp, ts, e):
    tau_p, tau_s = solve_phase_times(e, tp, ts, P)
    assert (tau_p, tau_s) == jsolve(e, tp, ts, P)
    assert abs(tau_p + tau_s - e) < 1e-6 * e
    assert tau_p >= 0 and tau_s >= 0
    if 0 < P < 1:
        lhs = tau_s * ts / (tau_p * tp + tau_s * ts)
        assert abs(lhs - P) < 1e-6


def test_p_zero_all_partitioned():
    tau_p, tau_s = solve_phase_times(10.0, 1e6, 1e6, 0.0)
    assert tau_p == 10.0 and tau_s == 0.0


def test_star_speedup_fig3():
    """I(n) = n/(nP - P + 1): P=0 -> n; P=1 -> 1; equal to the reference."""
    for n in (2, 4, 8, 16):
        assert np.isclose(tan.star_speedup(n, 0.0), n)
        assert np.isclose(tan.star_speedup(n, 1.0), 1.0)
    ps = np.linspace(0, 1, 11)
    sp = tan.star_speedup(4, ps)
    assert np.all(np.diff(sp) < 0)
    assert np.array_equal(sp, jan.star_speedup(4, ps))


def test_crossover_fig10():
    """STAR beats partitioning-based systems iff K > n (§6.3)."""
    n = 4
    ps = np.linspace(0.05, 0.95, 10)
    assert (tan.improvement_over_partitioning(n, ps, K=n + 1) > 1).all()
    assert (tan.improvement_over_partitioning(n, ps, K=n - 1) < 1).all()
    equal = tan.improvement_over_partitioning(n, ps, K=n)
    assert np.allclose(equal, 1.0)
    for K in (n - 1, n, n + 1):
        assert np.array_equal(tan.improvement_over_partitioning(n, ps, K),
                              jan.improvement_over_partitioning(n, ps, K))
    assert tan.crossover_K(n) == jan.crossover_K(n) == 4.0


def test_consistency_eq3_eq5():
    n, n_s, n_c, t_s, t_c = 4, 900, 100, 1e-6, 8e-6
    P = n_c / (n_s + n_c)
    K = t_c / t_s
    ratio = tan.t_partitioning(n, n_s, n_c, t_s, t_c) / tan.t_star(
        n, n_s, n_c, t_s)
    assert np.isclose(ratio, tan.improvement_over_partitioning(n, P, K))
    ratio2 = tan.t_nonpartitioned(n, n_s, n_c, t_s) / tan.t_star(
        n, n_s, n_c, t_s)
    assert np.isclose(ratio2, tan.improvement_over_nonpartitioned(n, P))
    for f in ("t_partitioning", "t_star", "t_nonpartitioned"):
        args = ((n, n_s, n_c, t_s, t_c) if f == "t_partitioning"
                else (n, n_s, n_c, t_s))
        assert getattr(tan, f)(*args) == getattr(jan, f)(*args)


@pytest.mark.parametrize("workload, cross", [("ycsb", 0.5), ("tpcc", 0.3)])
def test_calibrate_non_timing_fields_match_jax(workload, cross):
    """The port's calibration runs its executors on the device it is given;
    every field that is not a time is equal to the reference's."""
    kw = dict(workload=workload, n_partitions=4, n_txns=192,
              cross_ratio=cross, seed=3)
    got = tcalibrate(device="cpu", **kw)
    want = jcalibrate(**kw)
    assert isinstance(got, Calibration)
    for f in ("retry_factor", "value_bytes_per_txn", "op_bytes_per_txn",
              "remote_reads_per_cross"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.t_cross_cpu > 0 and got.t_single_cpu == 0.75 * got.t_cross_cpu


def test_calibrate_asks_for_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tcalibrate(n_txns=64)
