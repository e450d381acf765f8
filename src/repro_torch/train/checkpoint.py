"""Disk checkpointing with epoch-commit semantics (the port of
``repro/train/checkpoint.py``), in the JAX package's on-disk layout.

Checkpoints are written at epoch fences only, so on-disk state is always a
committed epoch; restore picks the NEWEST complete checkpoint (highest
step wins; a directory without ``meta.json`` is skipped).  The layout is
the JAX package's, so either side restores the other's directories:
``step_<10 digits>/`` holds ``params.npz`` and ``opt.npz``, one array a
leaf named by its JAX key path (``layers/moe/w_up``, ``master/embed``,
``step``), layers stacked on a leading L axis, bf16 stored as float32
(lossless), and ``meta.json`` ``{"step": ..., **extra}``; it is written
under ``.tmp`` and renamed into place.
"""
from __future__ import annotations

import json
import shutil
import zipfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import jax_key


def _leaves(tree: dict, prefix: str = ""):
    """{JAX key path: [(layer index or None, tensor)]} of a state tree
    (dicts of tensors keyed by parameter names): ``layers.<i>.<rest>`` is
    row i of ``layers/<rest>``, anything else its own key."""
    out: dict = {}
    for name, t in tree.items():
        if isinstance(t, dict):
            for k, v in _leaves(t, f"{prefix}{name}/").items():
                out.setdefault(k, []).extend(v)
            continue
        key, i = jax_key(name)
        out.setdefault(prefix + key, []).append((i, t))
    return out


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:          # npz has no bf16: store f32
        t = t.float()
    return t.cpu().numpy()


def _write_npz(path, tree: dict):
    """``np.savez``'s format (an uncompressed zip of ``<key>.npy``),
    written one array at a time so that only one leaf is on the host."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, rows in _leaves(tree).items():
            if rows[0][0] is None:
                arr = _to_numpy(rows[0][1])
            else:
                arr = np.stack([_to_numpy(t) for _, t in sorted(
                    rows, key=lambda r: r[0])])
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            del arr


def _load_into(tree: dict, npz):
    """Copy the arrays of the open ``npz`` (JAX key paths) into the tensors
    of ``tree`` in place, each cast to its tensor's dtype; one array is
    read at a time."""
    with torch.no_grad():
        for key, rows in _leaves(tree).items():
            arr = npz[key]
            for i, t in rows:
                src = torch.from_numpy(np.ascontiguousarray(
                    arr if i is None else arr[i]))
                t.copy_(src.reshape(t.shape).to(t.dtype))
            del arr


def save_checkpoint(directory, step: int, params: dict, opt_state: dict,
                    extra: dict | None = None):
    d = Path(directory) / f"step_{step:010d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    _write_npz(tmp / "params.npz", params)
    _write_npz(tmp / "opt.npz", opt_state)
    (tmp / "meta.json").write_text(json.dumps({"step": step,
                                               **(extra or {})}))
    tmp.rename(d)                                   # atomic commit point
    return d


def latest_checkpoint(directory) -> Path | None:
    d = Path(directory)
    if not d.exists():
        return None
    cands = sorted([p for p in d.iterdir()
                    if p.is_dir() and p.name.startswith("step_")
                    and (p / "meta.json").exists()])
    return cands[-1] if cands else None


def restore_checkpoint(directory, params: dict, opt_state: dict):
    """Load the newest checkpoint under ``directory`` into ``params`` and
    ``opt_state`` in place.  Returns (params, opt_state, meta), or None
    when there is none."""
    ckpt = latest_checkpoint(directory)
    if ckpt is None:
        return None
    meta = json.loads((ckpt / "meta.json").read_text())
    with np.load(ckpt / "params.npz") as pz:
        _load_into(params, pz)
    with np.load(ckpt / "opt.npz") as oz:
        _load_into(opt_state, oz)
    return params, opt_state, meta
