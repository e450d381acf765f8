"""Placement rules for parameters, optimizer state, batches and caches,
and the placement itself: the counterpart of ``repro/launch/sharding.py``.

The rules are the reference's, over the port's names:

* tensor-parallel over ``model``: attention heads, FFN hidden, experts,
  vocab;
* batch over ``(pod, data)``;
* FSDP (weight sharding over ``data``) for archs flagged ``cfg.fsdp``;
* optimizer state ALWAYS owner-sharded over ``data`` on top of the param
  spec (ZeRO-1) — the STAR "single-master" dense update;
* KV caches: kv-heads over ``model`` when divisible, else sequence-sharded;
* SSM params/state replicated over ``model`` (head counts are not
  divisible).

A spec is a tuple with one entry a dimension: an axis name, a tuple of
axis names, or None (whole) — a ``PartitionSpec``'s entries.  The spec
functions read only ``mesh.axis_names`` and ``mesh.shape[axis]``, so they
run on a :class:`~repro_torch.launch.mesh.AbstractMesh` with no process
group.  The port keeps one tensor a layer where the JAX package stacks
the layers on a leading L axis: a layer tensor's spec is the stacked
tensor's spec (computed on the stacked shape, so the size and divisibility
tests are the reference's) with the L entry dropped.

:func:`place` cuts this rank's shard of a whole tensor, :func:`gather`
rebuilds the whole tensor from the shards with ``all_gather`` on the
axes' groups: together the counterpart of ``named()`` plus
``jax.device_put``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import jax_key


def _shape(leaf) -> tuple:
    if isinstance(leaf, (tuple, list, torch.Size)):
        return tuple(leaf)
    return tuple(leaf.shape)


def _flatten(tree, prefix=""):
    """Nested dicts/lists -> [(dotted name, leaf)]."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry(axes):
    """A spec entry of ``axes``, as a ``PartitionSpec`` stores it: one axis
    by its name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _div(n: int, mesh, axis: str) -> bool:
    return (axis in mesh.axis_names and n % mesh.shape[axis] == 0
            and n >= mesh.shape[axis])


def add_data_axis(spec: tuple, shape: tuple, mesh,
                  min_size: int = 1 << 20) -> tuple:
    """ZeRO-style: shard the largest free dim over `data` if profitable."""
    if "data" not in mesh.axis_names:
        return spec
    flat = []
    for e in spec:
        flat.extend(e if isinstance(e, tuple) else (e,))
    if "data" in flat:
        return spec
    if math.prod(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (s, e) in enumerate(zip(shape, entries)):
        if e is None and s % mesh.shape["data"] == 0 and s > best:
            best, best_dim = s, i
    if best_dim < 0:
        return spec
    entries[best_dim] = "data"
    return tuple(entries)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def _param_spec(cfg: ArchConfig, name: str, shape: tuple, mesh) -> tuple:
    """The reference's ``spec_for`` on its path ``name`` and the stacked
    ``shape``."""
    pre = (None,) if name.startswith("layers/") else ()

    def p(*rest):
        return (*pre, *rest)

    whole = (None,) * len(shape)
    sp = whole
    vocab_tp = (not cfg.batch_over_model) and _div(cfg.padded_vocab, mesh,
                                                   "model")
    heads = _div(cfg.n_heads_padded, mesh, "model")
    if ("norm" in name or "A_log" in name or name.endswith("D")
            or "dt_bias" in name or "conv_" in name):
        sp = whole
    elif name == "embed":
        sp = ("model", None) if vocab_tp else (None, None)
    elif name == "lm_head":
        sp = (None, "model") if vocab_tp else (None, None)
    elif "frontend" in name:
        sp = (None, None)
    elif name.endswith("attn/wq"):
        sp = p(None, "model", None) if heads else p(None, None, None)
    elif name.endswith("attn/wk") or name.endswith("attn/wv"):
        sp = (p(None, "model", None)
              if _div(cfg.n_kv_heads_padded, mesh, "model")
              else p(None, None, None))
    elif name.endswith("attn/wo"):
        sp = p("model", None, None) if heads else p(None, None, None)
    elif (name.endswith("attn/w_uq") or name.endswith("attn/w_uk")
          or name.endswith("attn/w_uv")):
        sp = p(None, "model", None) if heads else p(None, None, None)
    elif (name.endswith("attn/w_dq") or name.endswith("attn/w_dkv")
          or name.endswith("attn/w_kr")):
        sp = p(None, None)
    elif "mlp/w_up" in name or "mlp/w_gate" in name:
        sp = p(None, "model") if _div(cfg.d_ff, mesh, "model") else p(None,
                                                                       None)
    elif "mlp/w_down" in name:
        sp = p("model", None) if _div(cfg.d_ff, mesh, "model") else p(None,
                                                                       None)
    elif "moe/router" in name:
        sp = p(None, None)
    elif "moe/" in name:       # (L, E, a, b) expert weights: experts over model
        sp = (p("model", None, None) if _div(cfg.n_experts, mesh, "model")
              else p(None, None, None))
    elif "ssm/" in name:
        sp = whole
    # batch_over_model archs use the model axis for DATA parallelism: a
    # weight sharded over 'model' there would conflict
    if cfg.batch_over_model:
        sp = whole
    if cfg.fsdp and name not in ("embed", "lm_head") and "norm" not in name:
        sp = add_data_axis(sp, shape, mesh)
    return sp


def _stacked(cfg: ArchConfig, name: str, leaf):
    """(reference path, stacked shape, whether a layer tensor)."""
    jname, layer = jax_key(name)
    shape = _shape(leaf)
    if layer is None:
        return jname, shape, False
    return jname, (cfg.n_layers,) + shape, True


def param_specs(cfg: ArchConfig, params: dict, mesh) -> dict:
    """{port name: spec} for ``params`` ({name: tensor or shape}, as
    ``LM.named_parameters()`` or ``transformer.param_shapes``)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, tuple) and len(leaf) == 2 and isinstance(
                leaf[1], torch.dtype):
            leaf = leaf[0]                  # param_shapes' (shape, dtype)
        jname, shape, layer = _stacked(cfg, name, leaf)
        sp = _param_spec(cfg, jname, shape, mesh)
        out[name] = sp[1:] if layer else sp
    return out


def opt_specs(cfg: ArchConfig, opt_state: dict, pspecs: dict, mesh) -> dict:
    """Optimizer state ``{"master", "m", "v": {name: tensor}, "step"}``:
    the param spec + forced `data` owner-sharding (ZeRO-1)."""
    out = {"step": ()}
    for s in ("master", "m", "v"):
        out[s] = {}
        for name, leaf in opt_state[s].items():
            jname, shape, layer = _stacked(cfg, name, leaf)
            sp = pspecs[name]
            if layer:
                sp = (None,) + tuple(sp)
            sp = add_data_axis(sp, shape, mesh)
            out[s][name] = sp[1:] if layer else sp
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def data_specs(batch: dict, mesh, cfg: ArchConfig | None = None,
               kind: str = "train") -> dict:
    """{name: spec} of a batch ({name: tensor or shape}): its leading
    (batch) dimension over the batch axes where they divide it."""
    ba = batch_axes(mesh)
    if (cfg is not None and cfg.batch_over_model
            and kind in ("train", "prefill") and "model" in mesh.axis_names):
        ba = ba + ("model",)
    nb = math.prod(mesh.shape[a] for a in ba) if ba else 1
    ba2 = batch_axes(mesh)
    nb2 = math.prod(mesh.shape[a] for a in ba2) if ba2 else 1
    out = {}
    for name, leaf in batch.items():
        shape = _shape(leaf)
        B, rest = shape[0], (None,) * (len(shape) - 1)
        if ba and B % nb == 0:
            out[name] = (_entry(ba), *rest)
        elif ba2 and B % nb2 == 0:      # fall back to (pod, data) only
            out[name] = (_entry(ba2), *rest)
        else:
            out[name] = (None, *rest)
    return out


def _cache_spec(cfg, name: str, shape: tuple, mesh, ba, nb) -> tuple:
    """The reference's cache ``spec_for`` on its path and stacked shape."""
    if name == "pos" or "slot_pos" in name:
        return (None,) * len(shape)
    if name.endswith("/k") or name.endswith("/v"):
        # (L, B, S_alloc, Hkv, Dh)
        bspec = ba if (ba and shape[1] % nb == 0) else None
        if _div(cfg.n_kv_heads_padded, mesh, "model"):
            return (None, bspec, None, "model", None)
        if shape[2] % mesh.shape["model"] == 0:
            return (None, bspec, "model", None, None)
        return (None, bspec, None, None, None)
    if "c_kv" in name or "k_rope" in name:
        # (L, B, S_alloc, r)
        bspec = ba if (ba and shape[1] % nb == 0) else None
        if shape[2] % mesh.shape["model"] == 0:
            return (None, bspec, "model", None)
        return (None, bspec, None, None)
    if "ssm/h" in name or "ssm/conv" in name:
        bspec = ba if (ba and shape[1] % nb == 0) else None
        return (None, bspec, *((None,) * (len(shape) - 2)))
    if len(shape) >= 2 and ba and shape[1] % nb == 0:
        return (None, ba, *((None,) * (len(shape) - 2)))
    return (None,) * len(shape)


def cache_specs(cfg: ArchConfig, cache: dict, mesh) -> dict:
    """{dotted name: spec} of a decode cache (``transformer.init_cache``'s
    ``{"layers": [per-layer dict], "pos"}``): batch over (pod, data); kv
    heads over model if divisible, else sequence over model (split-K
    decode)."""
    ba = batch_axes(mesh)
    nb = math.prod(mesh.shape[a] for a in ba) if ba else 1
    ba = _entry(ba)
    out = {}
    for name, leaf in _flatten(cache):
        shape = () if isinstance(leaf, int) else _shape(leaf)
        jname, layer = jax_key(name)
        if layer is not None:
            shape = (cfg.n_layers,) + shape
        sp = _cache_spec(cfg, jname, shape, mesh, ba, nb)
        out[name] = sp[1:] if layer is not None else sp
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def axes_of(entry) -> tuple:
    """The axis names of one spec entry (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(shape: tuple, spec: tuple, mesh) -> tuple:
    """The slices of a whole tensor of ``shape`` that this rank's shard
    under ``spec`` covers."""
    sl = []
    for d, s in enumerate(shape):
        axes = axes_of(spec[d]) if d < len(spec) else ()
        if not axes:
            sl.append(slice(None))
            continue
        n = mesh.count(axes)
        if s % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {axes} ({n} ways)")
        c = s // n
        i = mesh.index(axes)
        sl.append(slice(i * c, (i + 1) * c))
    return tuple(sl)


def place(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec`` (a copy
    of its own)."""
    return t[shard_slices(tuple(t.shape), spec, mesh)].clone()


def _all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's pieces along ``dim``, bit for bit (moved as
    bytes, so every dtype crosses every backend)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    return torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                     dim=dim)


def gather(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` under ``spec``: an
    ``all_gather`` on each sharded dimension's axis groups (the innermost
    axis of a tuple first)."""
    out = shard
    for d in range(shard.dim()):
        axes = axes_of(spec[d]) if d < len(spec) else ()
        for a in reversed(axes):
            out = _all_gather_dim(out, d, mesh.group(a)) if mesh.distributed \
                else out
    return out.clone() if out is shard else out
