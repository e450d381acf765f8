"""The training step (the port of ``make_train_fn`` in
``repro/launch/steps.py``) and the dry run's bundles.  The prefill and
decode steps are ``models.transformer.prefill`` / ``decode_step``
themselves.  A bundle (:func:`bundle_for`) is what one step of a cell
holds on a mesh: its trees (parameters, optimizer state, batch, cache)
as tensors on the ``meta`` device, which allocate nothing, and their
placement specs; the JAX package's bundles also carry the jitted
function to lower and compile, which has no counterpart here
(``launch/dryrun.py``).  The reference's ``opt_shapes`` is
``train.optimizer.init_opt_state`` itself, given meta tensors.

On a mesh of several ranks (``launch.mesh.Mesh``) a step is, on every
rank: run the rank's shard of the batch (``sharding.data_specs``) through
the gathered parameters, MoE layers expert-parallel over ``model``; sum
the expert weights' gradients over ``model`` (each rank's are its own
experts') and average every gradient over the batch axes; update the
optimizer state the rank owns (``sharding.opt_specs``: ZeRO-1 over
``data``) with the norm of the whole gradient; gather the updated master
weights back into every rank's parameters.  GSPMD's tensor-parallel split
of the dense layers is not reproduced: a dense layer runs whole on each
rank, which computes the same function (``launch/dryrun.py`` records
what a rank then holds: ``held_bytes_whole_params``, the whole
gradients included).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import sharding as shd
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         global_norm, init_opt_state)


def param_grads(loss, params: dict, cfg: ArchConfig) -> dict:
    """{name: d loss / d param}: zeros for a parameter of
    ``transformer.unreached_params(cfg)`` that the loss does not reach
    (an audio encoder's token embedding), as ``jax.grad`` gives; any
    other parameter the loss does not reach raises ValueError."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    stray = ({n for n, g in zip(params, grads) if g is None}
             - tf.unreached_params(cfg))
    if stray:
        raise ValueError(f"the loss of {cfg.name} does not reach "
                         f"{sorted(stray)}")
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def _loss_and_grads(model, params, batch, cfg, mesh):
    """(loss, metrics, grads) of ``batch``; with ``cfg.microbatches`` > 1
    the microbatches' gradients accumulate in float32."""
    def grads_of(b):
        loss, metrics = tf.loss_fn(model, b, cfg, mesh=mesh)
        return loss, metrics, param_grads(loss, params, cfg)

    k = cfg.microbatches
    B = next(iter(batch.values())).shape[0]
    if B % k != 0:                 # smoke/tiny batches: no accumulation
        k = 1
    if k == 1:
        return grads_of(batch)
    gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
    lsum, msum = 0.0, {}
    for i in range(k):
        mb = {n: a.reshape((k, a.shape[0] // k) + a.shape[1:])[i]
              for n, a in batch.items()}
        loss, metrics, grads = grads_of(mb)
        for n, g in grads.items():
            gsum[n] += g.float()
        lsum = lsum + loss.detach()
        msum = {n: msum.get(n, 0.0) + m.detach()
                for n, m in metrics.items()}
    return (lsum / k, {n: m / k for n, m in msum.items()},
            {n: g / k for n, g in gsum.items()})


def _all_reduce_flat(tensors: list, groups: list, scale: float = 1.0):
    """Sum a list of float32 tensors over each group in turn, as one
    buffer, then scale; in place."""
    import torch.distributed as dist
    if not tensors or not groups:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for g in groups:
        dist.all_reduce(flat, group=g)
    if scale != 1.0:
        flat *= scale
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def _expert_names(cfg: ArchConfig, mesh, names) -> list:
    """The parameters a rank of ``mesh`` holds a slice of experts of."""
    if not moe_lib.expert_parallel(cfg, mesh):
        return []
    return [n for n in names if ".moe." in n and not n.endswith(".router")]


def make_train_fn(cfg: ArchConfig, hp: AdamWConfig = AdamWConfig(),
                  mesh=None, ospecs: dict | None = None):
    """``train_step(model, params, opt_state, batch) -> metrics``: the loss
    and its gradient with respect to ``params`` (the model's ``{name:
    Parameter}``), then AdamW in place.  On a mesh of several ranks
    (module docstring) ``opt_state`` is the rank's shards under
    ``ospecs`` and ``batch`` the whole batch."""

    if mesh is None or not mesh.distributed:
        def train_step(model, params, opt_state, batch):
            loss, metrics, grads = _loss_and_grads(model, params, batch,
                                                   cfg, None)
            _, _, gnorm = adamw_update(params, grads, opt_state, hp)
            return {**{n: m.detach() for n, m in metrics.items()},
                    "loss": loss.detach(), "grad_norm": gnorm}
        return train_step

    def train_step(model, params, opt_state, batch):
        dspecs = shd.data_specs(batch, mesh, cfg, "train")
        local = {n: shd.place(a, dspecs[n], mesh) for n, a in batch.items()}
        lead = dspecs[next(iter(dspecs))][0]
        axes = shd.axes_of(lead)
        groups = [mesh.group(a) for a in axes]
        nb = mesh.count(axes) if axes else 1
        loss, metrics, grads = _loss_and_grads(model, params, local, cfg,
                                               mesh)
        with torch.no_grad():
            g32 = {n: g.float().clone() for n, g in grads.items()}
            del grads
            _all_reduce_flat([g32[n] for n in _expert_names(cfg, mesh, g32)],
                             [mesh.group("model")])
            _all_reduce_flat(list(g32.values()), groups, 1.0 / nb)
            gnorm = global_norm(g32)
            owned = {n: g[shd.shard_slices(tuple(g.shape),
                                           ospecs["master"][n], mesh)]
                     for n, g in g32.items()}
            del g32
            adamw_update(None, owned, opt_state, hp, gnorm=gnorm)
            for n, p in params.items():
                p.copy_(shd.gather(opt_state["master"][n],
                                   ospecs["master"][n], mesh))
            names = list(metrics)
            vals = [torch.stack([loss.detach().float()]
                                + [metrics[n].detach().float()
                                   for n in names])]
            _all_reduce_flat(vals, groups, 1.0 / nb)
        out = dict(zip(names, vals[0][1:]))
        return {**out, "loss": vals[0][0], "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# the dry run's bundles (``repro/launch/steps.py``'s lowering bundles)
# ---------------------------------------------------------------------------
@dataclass
class Bundle:
    """One step of a cell on a mesh: ``trees`` {"params", "opt_state",
    "batch", "cache"} of ``meta`` tensors (the trees the step holds),
    ``specs`` the same keys' placement specs and ``arguments`` the trees
    the JAX step takes as arguments (a prefill's cache is its output)."""
    kind: str
    trees: dict
    specs: dict
    arguments: tuple


def param_meta(cfg: ArchConfig) -> dict:
    """{name: meta tensor} of the model's state dict."""
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in tf.param_shapes(cfg).items()}


def _cache(cfg: ArchConfig, cell: ShapeCell) -> dict:
    return tf.init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")


def train_bundle(cfg: ArchConfig, cell: ShapeCell, mesh) -> Bundle:
    params = param_meta(cfg)
    opt = init_opt_state(params)         # meta in, meta out: no allocation
    batch = input_specs(cfg, cell)
    pspec = shd.param_specs(cfg, params, mesh)
    return Bundle("train", {"params": params, "opt_state": opt,
                            "batch": batch},
                  {"params": pspec,
                   "opt_state": shd.opt_specs(cfg, opt, pspec, mesh),
                   "batch": shd.data_specs(batch, mesh, cfg, cell.kind)},
                  ("params", "opt_state", "batch"))


def prefill_bundle(cfg: ArchConfig, cell: ShapeCell, mesh) -> Bundle:
    params = param_meta(cfg)
    batch = input_specs(cfg, cell)
    cache = _cache(cfg, cell)
    return Bundle("prefill", {"params": params, "batch": batch,
                              "cache": cache},
                  {"params": shd.param_specs(cfg, params, mesh),
                   "batch": shd.data_specs(batch, mesh, cfg, cell.kind),
                   "cache": shd.cache_specs(cfg, cache, mesh)},
                  ("params", "batch"))


def decode_bundle(cfg: ArchConfig, cell: ShapeCell, mesh) -> Bundle:
    params = param_meta(cfg)
    batch = input_specs(cfg, cell)
    cache = _cache(cfg, cell)
    return Bundle("decode", {"params": params, "cache": cache,
                             "batch": batch},
                  {"params": shd.param_specs(cfg, params, mesh),
                   "cache": shd.cache_specs(cfg, cache, mesh),
                   "batch": shd.data_specs(batch, mesh, cfg, cell.kind)},
                  ("params", "cache", "batch"))


def bundle_for(cfg: ArchConfig, cell: ShapeCell, mesh) -> Bundle:
    if cell.kind == "train":
        return train_bundle(cfg, cell, mesh)
    if cell.kind == "prefill":
        return prefill_bundle(cfg, cell, mesh)
    if cell.kind == "decode":
        return decode_bundle(cfg, cell, mesh)
    raise ValueError(cell.kind)
