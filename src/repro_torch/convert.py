"""Carry storage state across between numpy (the JAX engine's arrays, read
with ``np.asarray``) and the port's ``StorageEngine``.

TID words are uint32 in the reference and int64 in the port; both
functions check the range as they convert.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

U32 = 1 << 32


def from_jax_state(val, tid, indexes, device=None):
    """val (P, R, C) int32, tid (P, R) uint32 and per index key/prow int32,
    tid uint32 (P, cap) numpy arrays -> the port's state dict
    ``{"val", "tid", "indexes"}`` on ``device`` (``StorageEngine.load_state``
    takes it), TIDs widened to int64."""
    dev = resolve_device(device)

    def tids(a):
        a = np.asarray(a)
        if a.dtype != np.uint32:
            raise TypeError(f"TID words must be uint32, got {a.dtype}")
        return torch.tensor(a.astype(np.int64), device=dev)

    def words(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    return {"val": words(val), "tid": tids(tid),
            "indexes": [{"key": words(ix["key"]), "prow": words(ix["prow"]),
                         "tid": tids(ix["tid"])} for ix in indexes]}


def to_numpy_state(store):
    """A ``StorageEngine`` (or its state dict) -> numpy arrays in the
    reference's types: ``{"val" int32, "tid" uint32, "indexes": [{"key",
    "prow" int32, "tid" uint32}]}``.  Raises if a TID word is outside
    [0, 2**32)."""
    st = store.state() if hasattr(store, "state") else store

    def tids(t):
        a = t.cpu().numpy()
        if a.size and (a.min() < 0 or a.max() >= U32):
            raise ValueError("TID word outside [0, 2**32)")
        return a.astype(np.uint32)

    return {"val": st["val"].cpu().numpy(), "tid": tids(st["tid"]),
            "indexes": [{"key": ix["key"].cpu().numpy(),
                         "prow": ix["prow"].cpu().numpy(),
                         "tid": tids(ix["tid"])} for ix in st["indexes"]]}
