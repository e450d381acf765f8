"""Helpers for the PyTorch port's parity tests: move arrays between the JAX
package (numpy / jax arrays, TID words uint32) and the port (torch CPU
tensors, TID words int64) and compare trees of them bit for bit."""
import numpy as np
import torch


def to_torch(x):
    """numpy or jax array -> CPU tensor; uint32 TID words widen to int64."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a)


def tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v) for v in tree)
    return to_torch(tree)


def as_numpy(x):
    """Either side's array as numpy, integers as int64 (bool stays bool)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a if a.dtype == np.bool_ else a.astype(np.int64)


def assert_tree_equal(ref, got, path="out"):
    """Bit-exact comparison (tolerance 0) of a JAX tree with a port tree."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, sorted(ref), sorted(got))
        for k in ref:
            assert_tree_equal(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree_equal(a, b, f"{path}[{i}]")
    elif isinstance(ref, (int, np.integer)) and not isinstance(got,
                                                              torch.Tensor):
        assert int(ref) == int(got), (path, ref, got)
    else:
        a, b = as_numpy(ref), as_numpy(got)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert a.dtype == b.dtype or (a.dtype != np.bool_
                                      and b.dtype != np.bool_), path
        assert np.array_equal(a, b), (path, np.argwhere(a != b)[:5])
