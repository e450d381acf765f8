"""PyTorch port vs JAX reference: TID words and op semantics (bit-exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_util import as_numpy, to_torch

from repro.core import ops as jops
from repro.core import tid as jtid
from repro_torch.core import ops as tops
from repro_torch.core import tid as ttid

U32 = 1 << 32


@pytest.mark.parametrize("epoch", [1, 255, 256])
def test_tid_words(epoch):
    rng = np.random.default_rng(epoch)
    seq = rng.integers(0, 1 << 23, 64).astype(np.uint32)
    seq[:3] = (0, 1, (1 << 23) - 1)
    for locked in (False, True):
        a = jtid.make_tid(epoch, jnp.asarray(seq), locked=locked)
        b = ttid.make_tid(epoch, to_torch(seq), locked=locked)
        assert np.array_equal(as_numpy(a), as_numpy(b))
        assert np.array_equal(as_numpy(jtid.tid_seq(a)),
                              as_numpy(ttid.tid_seq(b)))
        assert np.array_equal(as_numpy(jtid.tid_epoch(a)),
                              as_numpy(ttid.tid_epoch(b)))
        assert np.array_equal(as_numpy(jtid.tid_locked(a)),
                              as_numpy(ttid.tid_locked(b)))
        assert np.array_equal(as_numpy(jtid.tid_unlock(a)),
                              as_numpy(ttid.tid_unlock(b)))
        assert np.array_equal(as_numpy(jtid.tid_lock(a)),
                              as_numpy(ttid.tid_lock(b)))
    # the reference wraps mod 2**32
    assert int(ttid.make_tid(256, 1)) == int(jtid.make_tid(256, 1)) == 2


@pytest.mark.parametrize("epoch", [1, 255, 256])
def test_next_tid(epoch):
    rng = np.random.default_rng(10 + epoch)
    obs = rng.integers(0, U32, 256, dtype=np.uint64).astype(np.uint32)
    last = rng.integers(0, U32, 256, dtype=np.uint64).astype(np.uint32)
    # TIDs of this epoch, locked and not, and of its neighbours
    for e, arr in ((epoch, obs[:64]), (epoch - 1, obs[64:96]),
                   (epoch, last[:64])):
        arr[:] = np.asarray(jtid.make_tid(e, jnp.asarray(
            rng.integers(0, 1 << 23, arr.size).astype(np.uint32))))
    obs[:16] |= 1
    a = jtid.next_tid(jnp.uint32(epoch), jnp.asarray(obs), jnp.asarray(last))
    b = ttid.next_tid(epoch, to_torch(obs), to_torch(last))
    assert np.array_equal(as_numpy(a), as_numpy(b))
    assert b.dtype == torch.int64 and int(b.max()) < U32


def _op_batch(seed, n=512, C=10):
    rng = np.random.default_rng(seed)
    edge = np.array([-2**31, -2**31 + 1, -2**31 + 7, -1, 0, 1, 9, 10, 11,
                     2**31 - 500, 2**31 - 2, 2**31 - 1], np.int64)
    old = rng.choice(edge, (n, C))
    delta = rng.choice(edge, (n, C))
    mix = rng.random((n, C)) < 0.5
    old = np.where(mix, rng.integers(-2**31, 2**31, (n, C)), old)
    delta = np.where(~mix, rng.integers(-2**31, 2**31, (n, C)), delta)
    kind = np.arange(n) % 10                      # every kind, READ..DELETE
    return (kind.astype(np.int32), old.astype(np.int32),
            delta.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_op_every_kind_near_int32_limits(seed):
    kind, old, delta = _op_batch(seed)
    a = jops.apply_op(jnp.asarray(kind), jnp.asarray(old), jnp.asarray(delta))
    b = tops.apply_op(to_torch(kind), to_torch(old), to_torch(delta))
    assert b.dtype == torch.int32
    assert np.array_equal(np.asarray(a), b.numpy())
    for pred in ("writes_primary", "writes_index", "reads_index",
                 "is_index_kind", "is_write_kind"):
        assert np.array_equal(np.asarray(getattr(jops, pred)(
            jnp.asarray(kind))), getattr(tops, pred)(to_torch(kind)).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resolve_op_guards(seed):
    rng = np.random.default_rng(seed)
    B, M, K, C = 16, 24, tops.IDX_OPS, 10
    kind = rng.integers(0, 10, (B, M)).astype(np.int32)
    delta = rng.integers(-5, 5, (B, M, C)).astype(np.int32)
    delta[..., -1] = rng.integers(0, K + 2, (B, M))   # guards, some bogus
    consume_ok = rng.random((B, K)) < 0.6
    wmask = rng.random((B, M)) < 0.7
    ja, jb = jops.resolve_op_guards(jnp.asarray(kind), jnp.asarray(delta),
                                    jnp.asarray(consume_ok),
                                    jnp.asarray(wmask))
    ta, tb = tops.resolve_op_guards(to_torch(kind), to_torch(delta),
                                    to_torch(consume_ok), to_torch(wmask))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())
