"""Carry state across between numpy (the JAX package's arrays, read with
``np.asarray``) and the port: storage state for ``StorageEngine``, a JAX
cluster engine's copies for ``core.cluster.ClusterStarEngine``, and a JAX
LM parameter tree and optimizer state for ``models.transformer.LM`` and
``train.trainer.Trainer``.

TID words are uint32 in the reference and int64 in the port; the storage
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


def _tensor(a, dev):
    """numpy -> tensor of the same dtype (bfloat16 arrives as ml_dtypes'
    bfloat16, which torch does not read: it is carried bit for bit)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def jax_key(name: str):
    """A port parameter name -> (its "/"-joined key path in the JAX
    package's tree, whose layers are stacked on a leading L axis; the
    layer index, or None outside the layers): ``layers.3.moe.w_up`` ->
    (``layers/moe/w_up``, 3), ``embed`` -> (``embed``, None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def params_from_jax(params, cfg, device=None):
    """A JAX parameter tree (``repro.models.transformer.init_params``
    layout, leaves as numpy arrays, layers stacked on a leading L axis)
    -> the port's model state: ``{name: tensor}`` for
    ``LM.load_state_dict``, layers unstacked into ``layers.<i>.<name>``.
    Layouts (``wq`` (d, H, Dh), ``wo`` (H, Dh, d), ``in_proj``, ``conv_w``
    (W, C), ...) and dtypes are kept.  Raises ValueError on a missing,
    extra or misshapen parameter."""
    from repro_torch.models.transformer import param_shapes
    dev = resolve_device(device)
    want = param_shapes(cfg)
    flat = {k: v for k, v in _flatten(params) if not k.startswith("layers.")}
    for k, v in _flatten(params.get("layers", {}), "layers."):
        v = np.asarray(v)
        if v.shape[:1] != (cfg.n_layers,):
            raise ValueError(f"{k}: leading axis {v.shape[:1]}, expected "
                             f"{cfg.n_layers} stacked layers")
        _, name = k.split(".", 1)
        for i in range(cfg.n_layers):
            flat[f"layers.{i}.{name}"] = v[i]
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameters missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if tuple(v.shape) != want[k][0]:
            raise ValueError(f"{k}: shape {tuple(v.shape)}, the config "
                             f"needs {want[k][0]}")
        out[k] = _tensor(v, dev)
    return out


def opt_state_from_jax(opt, cfg, device=None):
    """A JAX ``repro.train.optimizer.init_opt_state`` tree (``master``,
    ``m``, ``v`` parameter trees and ``step``, leaves as numpy) -> the
    port's optimizer state: ``{"master", "m", "v"}`` as ``{name: tensor}``
    (layers unstacked as :func:`params_from_jax` does) and ``"step"`` an
    int32 scalar, on ``device``."""
    dev = resolve_device(device)
    out = {s: params_from_jax(opt[s], cfg, device=dev)
           for s in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])),
                               dtype=torch.int32, device=dev)
    return out


def cluster_state_from_jax(engine, state, epoch: int):
    """Load a JAX ``ClusterStarEngine``'s committed state into a port
    ``core.cluster.ClusterStarEngine`` (``engine``), working and snapshot
    copies alike.  ``state`` holds the reference engine's arrays as numpy:
    ``part_val``/``full_val`` (P, R, C) int32, ``part_tid``/``full_tid``
    (P, R) uint32, ``part_idx``/``full_idx`` lists of key/prow int32, tid
    uint32 (P, cap), and, where the reference kept physical secondary
    copies, ``sec_val``/``sec_tid``/``sec_idx`` in its rolled layout (else
    the port's are rolled from the partial copy).  ``epoch`` is the
    reference engine's ``epoch``: the one it runs next, after ``epoch -
    1`` committed fences.  TID words widen to int64 as in
    :func:`from_jax_state`."""
    from repro_torch.core.cluster import _clone
    st = {}
    for copy in ("part", "full", "sec"):
        if copy == "sec" and (not engine.secondary or "sec_val" not in state):
            continue
        t = from_jax_state(state[f"{copy}_val"], state[f"{copy}_tid"],
                           state[f"{copy}_idx"], device=engine.device)
        st.update({f"{copy}_val": t["val"], f"{copy}_tid": t["tid"],
                   f"{copy}_idx": t["indexes"]})
    if engine.secondary and "sec_val" not in state:
        st.update({f"sec_{k}": v for k, v in engine._roll_home(
            {k: st[f"part_{k}"] for k in ("val", "tid", "idx")}).items()})
    engine._load_state(st)
    engine._snap = _clone(st)
    engine.epoch = int(epoch)
    engine.committed_epoch = int(epoch) - 1
    return engine
