"""PyTorch port vs JAX reference: the OCC kernels' plain versions and both
phase executors (bit-exact), on the random conflict and phantom workloads
of tests/test_occ_kernels.py.  The JAX side runs kernel="jnp" and the
ref.py oracles."""
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_util import assert_tree_equal, to_torch, tree_to_torch
from test_occ_kernels import C, M, _random_index_workload

from repro.core.partitioned import run_partitioned as jpart
from repro.core.single_master import run_single_master as jsm
from repro.kernels.occ import ref as jref
from repro.core.ops import IDX_OPS, is_index_kind, writes_primary
from repro_torch.core.partitioned import run_partitioned as tpart
from repro_torch.core.single_master import run_single_master as tsm
from repro_torch.kernels.occ import ops as tocc

K = min(IDX_OPS, M)


def _case(seed, B=8, P=2, caps=(12, 16)):
    """Fixed shapes per call site (the JAX side compiles once per shape)."""
    rng = np.random.default_rng(seed)
    n_rows = 64 * P
    txns, index = _random_index_workload(rng, B, P, n_rows, list(caps),
                                         conflict_rows=n_rows // 4)
    val0 = rng.integers(0, 50, (n_rows, C)).astype(np.int32)
    tid0 = rng.integers(0, 5, n_rows).astype(np.uint32) * 2
    return rng, txns, index, val0, tid0, n_rows


@pytest.mark.parametrize("seed", range(4))
def test_locate_index_ops_matches_ref(seed):
    _, txns, index, _, _, n_rows = _case(seed)
    a = jref.locate_index_ops_ref(index, txns["kind"][:, :K],
                                  txns["delta"][:, :K], n_rows)
    b = tocc.locate_index_ops(tree_to_torch(index),
                              to_torch(txns["kind"][:, :K]),
                              to_torch(txns["delta"][:, :K]), n_rows)
    assert a["no_addr"] == b["no_addr"]
    assert_tree_equal({k: v for k, v in a.items() if k != "no_addr"},
                      {k: v for k, v in b.items() if k != "no_addr"})


@pytest.mark.parametrize("with_ix", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_occ_round_matches_ref(seed, deterministic, with_ix):
    rng, txns, index, val0, tid0, n_rows = _case(seed)
    kind, delta = txns["kind"], txns["delta"]
    active = txns["valid"] & ~txns["user_abort"]
    delta_v = delta.at[..., -1].set(0)
    wmask = writes_primary(kind) & active[:, None]
    amask = active[:, None] & (kind >= 0) & ~is_index_kind(kind)
    last = jnp.asarray(rng.integers(0, 2**32, kind.shape[0],
                                    dtype=np.uint64).astype(np.uint32))
    ix = has_claim = tix = thc = None
    if with_ix:
        ix = jref.locate_index_ops_ref(index, kind[:, :K], delta[:, :K],
                                       n_rows)
        has_claim = (ix["claim_addr"] < ix["no_addr"]) & active[:, None]
        tix = {k: (v if k == "no_addr" else to_torch(v))
               for k, v in ix.items()}
        thc = to_torch(has_claim)
    a = jref.occ_round_ref(jnp.asarray(val0), jnp.asarray(tid0), txns["row"],
                           kind, delta_v, wmask, amask, active, jnp.uint32(3),
                           last, ix=ix, has_claim=has_claim,
                           deterministic=deterministic)
    b = tocc.occ_round(to_torch(val0), to_torch(tid0), to_torch(txns["row"]),
                       to_torch(kind), to_torch(delta_v), to_torch(wmask),
                       to_torch(amask), to_torch(active), 3, to_torch(last),
                       ix=tix, has_claim=thc, deterministic=deterministic)
    assert_tree_equal(tuple(a), b)


@pytest.mark.parametrize("seed", range(4))
def test_step_index_ops_matches_ref(seed):
    rng = np.random.default_rng(100 + seed)
    P = 3
    txns, index = _random_index_workload(rng, P, P, 64, [10, 14],
                                         conflict_rows=16)
    a = jref.step_index_ops_ref(index, txns["kind"][:, :K],
                                txns["delta"][:, :K])
    b = tocc.step_index_ops(tree_to_torch(index),
                            to_torch(txns["kind"][:, :K]),
                            to_torch(txns["delta"][:, :K]))
    assert_tree_equal(tuple(a), b)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_run_single_master_matches_jax(seed, deterministic):
    _, txns, index, val0, tid0, _ = _case(seed)
    a = jsm(jnp.asarray(val0), jnp.asarray(tid0), txns, jnp.uint32(2),
            max_rounds=4, index=[dict(i) for i in index], kernel="jnp",
            deterministic=deterministic)
    b = tsm(to_torch(val0), to_torch(tid0), tree_to_torch(txns), 2,
            max_rounds=4, index=tree_to_torch(index),
            deterministic=deterministic)
    assert_tree_equal(tuple(a), b)


def test_run_single_master_without_index():
    _, txns, _, val0, tid0, _ = _case(7)
    a = jsm(jnp.asarray(val0), jnp.asarray(tid0), txns, jnp.uint32(5),
            max_rounds=3, kernel="jnp")
    b = tsm(to_torch(val0), to_torch(tid0), tree_to_torch(txns), 5,
            max_rounds=3)
    assert_tree_equal(tuple(a), b)


@pytest.mark.parametrize("seed", range(4))
def test_run_partitioned_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    P, T, R = 3, 3, 64
    txns, index = _random_index_workload(rng, P * T, P, R, [12],
                                         conflict_rows=R // 2)
    ptxn = {k: np.asarray(v).reshape((P, T) + v.shape[1:])
            for k, v in txns.items()}
    val0 = rng.integers(0, 50, (P, R, C)).astype(np.int32)
    tid0 = np.zeros((P, R), np.uint32)
    a = jpart(jnp.asarray(val0), jnp.asarray(tid0),
              {k: jnp.asarray(v) for k, v in ptxn.items()}, jnp.uint32(1),
              index=[dict(i) for i in index], kernel="jnp")
    b = tpart(to_torch(val0), to_torch(tid0), tree_to_torch(ptxn), 1,
              index=tree_to_torch(index))
    assert_tree_equal(tuple(a), b)
