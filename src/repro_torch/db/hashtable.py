"""Open-addressing hash index over dense arrays (vectorized linear probing),
port of ``repro.db.hashtable`` with the same hash and slot layout.

The paper's tables are hash tables (§3).  The index is a power-of-two slot
array; a batch of lookups is a (B, max_probes) gather fan-out resolved with
argmax.  Insertion is a setup-time, sequential operation run on the host;
lookups run on the index's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

EMPTY = -1
_M32 = 0xFFFFFFFF


def make_index(n_slots: int, device=None):
    """An empty index of ``n_slots`` (a power of two) on ``device``
    (``None`` = cuda)."""
    assert n_slots & (n_slots - 1) == 0, "n_slots must be a power of two"
    dev = resolve_device(device)
    return {"key": torch.full((n_slots,), EMPTY, dtype=torch.int32,
                              device=dev),
            "row": torch.full((n_slots,), EMPTY, dtype=torch.int32,
                              device=dev)}


def _hash(key, n_slots):
    """The reference's uint32 mix, in int64 words: int32 keys (tensor or
    numpy) -> int64 home slots."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64) & _M32
    else:
        k = np.asarray(key).astype(np.int64) & _M32
    k = ((k ^ (k >> 16)) * 0x45d9f3b) & _M32
    k = ((k ^ (k >> 16)) * 0x45d9f3b) & _M32
    k = k ^ (k >> 16)
    return k & (n_slots - 1)


def insert(index, keys, rows, max_probes: int = 32):
    """Sequential batch insert — index build is a setup-time op.  Each key
    takes the first empty slot after its home within ``max_probes`` steps
    (past that, the slot ``max_probes`` on is overwritten, as in the
    reference).  Returns a new index on the same device."""
    dev = index["key"].device
    ikey = index["key"].cpu().numpy().copy()
    irow = index["row"].cpu().numpy().copy()
    n_slots = ikey.shape[0]
    keys = np.asarray(keys.cpu() if isinstance(keys, torch.Tensor) else keys,
                      np.int32)
    rows = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                      np.int32)
    for key, row, h in zip(keys, rows, _hash(keys, n_slots)):
        slot, i = int(h), 0
        while ikey[slot] != EMPTY and i < max_probes:
            i += 1
            slot = (int(h) + i) % n_slots
        ikey[slot], irow[slot] = key, row
    return {"key": torch.as_tensor(ikey, device=dev),
            "row": torch.as_tensor(irow, device=dev)}


def lookup(index, keys, max_probes: int = 32):
    """Vectorized probe: (B,) int32 keys on the index's device -> (B,) rows
    (-1 if absent)."""
    n_slots = index["key"].shape[0]
    h = _hash(keys, n_slots)                                   # (B,)
    probes = (h[:, None] + torch.arange(max_probes, device=keys.device)
              ) % n_slots
    hit = index["key"][probes] == keys[:, None]                # (B, probes)
    first = hit.to(torch.int8).argmax(dim=1)
    rows = index["row"][probes.gather(1, first[:, None])[:, 0]]
    return torch.where(hit.any(dim=1), rows, EMPTY)
