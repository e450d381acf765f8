"""Parity of the port's two-version tables (``repro_torch.storage.engine``'s
free functions and the ``repro_torch.db.table`` shim) with
``repro.db.table`` on the CPU.

The same numpy writes go to both sides: JAX rebinds its immutable arrays,
the port writes its tensors in place.  Tolerance 0; TIDs are compared by
value (JAX uint32, the port int64 holding the uint32).  The JAX snapshot
is the working array itself; the port's is a copy, and a write into the
working tensors after a commit or a revert must not reach it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.db as jdb
import repro.db.table as jtable
import repro_torch.db as tdb
import repro_torch.db.table as ttable
import repro_torch.storage as tstorage

NAMES = ("Database", "TableSpec", "flat_tid", "flat_val", "global_key",
         "make_database", "make_table", "snapshot_commit",
         "revert_to_snapshot")
P = 3


def _specs(mod):
    return [mod.TableSpec("stock", 7, 4), mod.TableSpec("order", 5, 2)]


def _same_db(t, j):
    """Every table array and the epoch equal, TIDs by value."""
    assert set(t) == set(j)
    assert int(t["_epoch"]) == int(j["_epoch"])
    assert t["_epoch"].dtype == torch.int64
    for name in (k for k in j if k != "_epoch"):
        for f in ("val", "tid", "val_prev", "tid_prev"):
            want = np.asarray(j[name][f])
            got = t[name][f]
            assert got.dtype == (torch.int32 if f.startswith("val")
                                 else torch.int64), (name, f)
            assert np.array_equal(got.numpy(), want.astype(got.numpy().dtype)
                                  ), (name, f)


def _write(t, j, rng, tid):
    """The same random post-images and TID into three distinct rows of
    every table."""
    for name in (k for k in j if k != "_epoch"):
        cap = j[name]["val"].shape[1]
        p, r = np.divmod(rng.choice(P * cap, 3, replace=False), cap)
        v = rng.integers(-2**31, 2**31 - 1, (3, j[name]["val"].shape[2]),
                         dtype=np.int64).astype(np.int32)
        j[name] = dict(j[name], val=j[name]["val"].at[p, r].set(v),
                       tid=j[name]["tid"].at[p, r].set(jnp.uint32(tid)))
        t[name]["val"][torch.tensor(p), torch.tensor(r)] = torch.tensor(v)
        t[name]["tid"][torch.tensor(p), torch.tensor(r)] = tid


def test_exports_match_jax():
    """The shim exports the JAX shim's nine names; ``repro_torch.db`` and
    ``repro_torch.storage`` export what ``repro.db`` and the free
    functions of ``repro.storage`` do."""
    jnames = {n for n in vars(jtable) if not n.startswith("_")
              and n not in ("annotations",)}
    assert jnames >= set(NAMES)
    for n in NAMES:
        assert hasattr(ttable, n), n
        assert getattr(ttable, n) is getattr(tstorage, n), n
    assert set(tdb.__all__) == set(jdb.__all__)
    for n in tdb.__all__:
        assert getattr(tdb, n) is getattr(ttable, n), n


def test_make_database_matches_jax():
    j = jtable.make_database(_specs(jtable), P)
    t = ttable.make_database(_specs(ttable), P, device="cpu")
    _same_db(t, j)
    tab = ttable.make_table(ttable.TableSpec("x", 4, 3), 2, device="cpu")
    jtab = jtable.make_table(jtable.TableSpec("x", 4, 3), 2)
    for f in tab:
        assert tuple(tab[f].shape) == jtab[f].shape, f
    assert tab["val_prev"].data_ptr() != tab["val"].data_ptr()


@pytest.mark.parametrize("plan", ["cccrc", "wrwcrr", "cwrcw"])
def test_commit_and_revert_match_jax(plan):
    """A seeded sequence of writes (w: one round into every table),
    commits (c) and reverts (r), the two databases compared after each
    step."""
    rng = np.random.default_rng(len(plan))
    j = jtable.make_database(_specs(jtable), P)
    t = ttable.make_database(_specs(ttable), P, device="cpu")
    tid = 0x10000
    for step in plan:
        _write(t, j, rng, tid)
        tid += 0x100 * (1 + step.count("w"))
        if step == "c":
            j, t = jtable.snapshot_commit(j), ttable.snapshot_commit(t)
        elif step == "r":
            j, t = jtable.revert_to_snapshot(j), ttable.revert_to_snapshot(t)
        _same_db(t, j)


def test_epoch_wraps_as_uint32():
    j = jtable.make_database(_specs(jtable), P)
    t = ttable.make_database(_specs(ttable), P, device="cpu")
    j["_epoch"] = jnp.uint32(2**32 - 1)
    t["_epoch"] = torch.tensor(2**32 - 1, dtype=torch.int64)
    j, t = jtable.snapshot_commit(j), ttable.snapshot_commit(t)
    assert int(j["_epoch"]) == int(t["_epoch"]) == 0
    j, t = jtable.revert_to_snapshot(j), ttable.revert_to_snapshot(t)
    assert int(j["_epoch"]) == int(t["_epoch"]) == 0


@pytest.mark.parametrize("op", ["commit", "revert"])
def test_snapshot_is_a_copy(op):
    """After a commit (or a revert), a write into the working tensors in
    place leaves the snapshot as it was: JAX's alias of the working array
    would carry the write into it."""
    t = ttable.make_database(_specs(ttable), P, device="cpu")
    rng = np.random.default_rng(5)
    j = jtable.make_database(_specs(jtable), P)
    _write(t, j, rng, 7)
    t = ttable.snapshot_commit(t)
    if op == "revert":
        _write(t, j, rng, 9)
        t = ttable.revert_to_snapshot(t)
    snap = {k: {f: v[f].clone() for f in ("val_prev", "tid_prev")}
            for k, v in t.items() if k != "_epoch"}
    for k, tab in t.items():
        if k == "_epoch":
            continue
        tab["val"].add_(1)
        tab["tid"].add_(1)
        assert torch.equal(tab["val_prev"], snap[k]["val_prev"]), k
        assert torch.equal(tab["tid_prev"], snap[k]["tid_prev"]), k
        assert not torch.equal(tab["val"], tab["val_prev"]), k


def test_flat_views_and_global_key_match_jax():
    rng = np.random.default_rng(3)
    j = jtable.make_database(_specs(jtable), P)
    t = ttable.make_database(_specs(ttable), P, device="cpu")
    _write(t, j, rng, 11)
    for name in ("stock", "order"):
        assert np.array_equal(ttable.flat_val(t[name]).numpy(),
                              np.asarray(jtable.flat_val(j[name])))
        assert np.array_equal(ttable.flat_tid(t[name]).numpy(),
                              np.asarray(jtable.flat_tid(j[name]),
                                         np.int64))
        # the port's flat views are views of the working tensors
        assert ttable.flat_val(t[name]).data_ptr() == \
            t[name]["val"].data_ptr()
    parts = rng.integers(0, P, 6).astype(np.int32)
    idx = rng.integers(0, 7, 6).astype(np.int32)
    assert ttable.global_key(2, 5, 7) == int(jtable.global_key(2, 5, 7))
    assert np.array_equal(
        ttable.global_key(torch.tensor(parts), torch.tensor(idx), 7).numpy(),
        np.asarray(jtable.global_key(jnp.asarray(parts), jnp.asarray(idx),
                                     7)))
