"""Routed mixture-of-experts FFN with sort-based (one-hot-free) dispatch
(the port of ``repro/models/moe.py``).

``moe_apply`` is the per-shard body: local tokens, a contiguous slice of
experts, capacity-bounded dispatch, partial-sum combine.  ``moe_forward``
runs it on one device with the full expert set, or, given a mesh whose
``model`` axis divides the experts (the JAX package's branch condition),
expert-parallel: the rank at ``model`` index i runs experts ``[i * e_loc,
(i + 1) * e_loc)`` on its own tokens (already this rank's batch shard:
the caller splits the batch axes), the partial outputs are summed with
an ``all_reduce`` over the ``model`` group (in float32), and ``aux`` is
averaged over ``model``, then over the batch axes.

Under autograd the expert-parallel branch gives every rank the gradient
of the function a single device computes on its tokens: the ``all_reduce``
of the outputs passes its gradient through unchanged, and the dispatch
input and the routing weights sum their gradients over ``model`` (each
rank's are the share of its own experts), so the router and everything
before the layer see whole gradients; the averages of ``aux`` pass theirs
through unchanged, which with the caller's average of the gradients over
the batch axes is the gradient of the averaged loss.

The expert products are batched matrix products (``torch.einsum``), as
the JAX package leaves them to XLA: no kernel of this repository computes
them.  The combine adds each slot's row into its token with ``index_add_``,
whose additions run in no fixed order on the card (the CPU adds in slot
order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, normal_init


def init_moe(gen, cfg, dtype) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {
        "router": normal_init(gen, (d, E), d ** -0.5, torch.float32),
        "w_up": normal_init(gen, (E, d, ff), d ** -0.5, dtype),
        "w_down": normal_init(gen, (E, ff, d), ff ** -0.5, dtype),
    }
    if cfg.mlp_gated:
        p["w_gate"] = normal_init(gen, (E, d, ff), d ** -0.5, dtype)
    return p


def moe_capacity(n_tokens: int, cfg) -> int:
    cap = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(min(n_tokens, 16), min(cap, n_tokens))


def route(router, x_flat, cfg):
    """Returns (weights (T, k) f32, expert ids (T, k) int64, aux
    load-balance loss).  ``torch.topk`` may order equal gates otherwise
    than ``lax.top_k``."""
    logits = x_flat.float() @ router                               # (T, E)
    gates = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(gates, cfg.top_k, dim=-1)            # (T, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e f_e * p_e
    me = gates.mean(0)
    ce = F.one_hot(ids[:, 0], cfg.n_experts).float().mean(0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return weights, ids, aux


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        s = g.float().contiguous().clone()
        dist.all_reduce(s, group=ctx.group)
        return s.to(g.dtype), None


class _AllReduce(torch.autograd.Function):
    """One ``all_reduce`` over ``group`` of several tensors, summed in
    float32, each then multiplied by its scale; the backward passes the
    gradients through unchanged (module docstring)."""

    @staticmethod
    def forward(ctx, group, scales, *xs):
        import torch.distributed as dist
        flat = torch.cat([x.float().reshape(-1) for x in xs])
        dist.all_reduce(flat, group=group)
        out, o = [], 0
        for x, sc in zip(xs, scales):
            y = flat[o:o + x.numel()].view(x.shape)
            out.append((y * sc if sc != 1.0 else y).to(x.dtype))
            o += x.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + gs


def pmean_value(x, group, n: int):
    """Mean over the ``n`` ranks of ``group``; gradients pass through
    (module docstring)."""
    return _AllReduce.apply(group, (1.0 / n,), x)[0]


def moe_apply(p, x_flat, cfg, expert_offset: int, n_local_experts: int,
              group=None):
    """Sort-based dispatch over a local expert slice.

    x_flat: (T, d).  ``p`` holds weights for ONLY the local experts
    (w_up / w_gate / w_down first dim = n_local_experts) but the full
    router.  ``group``: the ``model`` process group of an expert-parallel
    run (the outputs are summed over it, the router's and the input's
    gradients too).  Returns (y (T, d), aux)."""
    T, d = x_flat.shape
    k = cfg.top_k
    C = moe_capacity(T, cfg)
    dev = x_flat.device

    weights, ids, aux = route(p["router"], x_flat, cfg)
    x_disp = x_flat
    if group is not None:
        weights = _SumGrad.apply(weights, group)
        x_disp = _SumGrad.apply(x_flat, group)

    # flatten assignments and sort by expert id (stable)
    flat_ids = ids.reshape(-1)                                     # (T*k,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    s_ids, s_w, s_tok = flat_ids[order], flat_w[order], flat_tok[order]

    # position within expert via segment starts
    starts = torch.searchsorted(
        s_ids, torch.arange(cfg.n_experts, device=dev, dtype=s_ids.dtype))
    pos_in_e = torch.arange(T * k, device=dev) - starts[s_ids]

    local = (s_ids >= expert_offset) & (s_ids < expert_offset
                                        + n_local_experts)
    keep = local & (pos_in_e < C)
    local_e = torch.clamp(s_ids - expert_offset, 0, n_local_experts - 1)
    n_slots = n_local_experts * C
    dest = torch.where(keep, local_e * C + pos_in_e,
                       torch.full_like(pos_in_e, n_slots))      # drop slot

    # slot tables: which token / weight feeds each capacity slot (the drop
    # slot, past the end, takes every dropped assignment and is cut off)
    slot_tok = torch.full((n_slots + 1,), T, device=dev,
                          dtype=s_tok.dtype).index_put((dest,), s_tok)[:-1]
    slot_w = torch.zeros(n_slots + 1, device=dev, dtype=torch.float32
                         ).index_put((dest,), torch.where(
                             keep, s_w, torch.zeros_like(s_w)))[:-1]
    valid = slot_tok < T
    safe_tok = torch.where(valid, slot_tok, torch.zeros_like(slot_tok))

    # index_select: its backward adds the slots' rows back into their
    # tokens with index_add_ (advanced indexing's backward sorts the
    # indices first, which on the card took ~46 ms a layer at 16,384 x 8)
    buf = x_disp.index_select(0, safe_tok) * valid.to(x_flat.dtype)[:, None]
    buf = buf.reshape(n_local_experts, C, d)

    # expert FFN
    up = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    if "w_gate" in p:
        up = act_fn(cfg.mlp_act)(torch.einsum("ecd,edf->ecf", buf,
                                              p["w_gate"])) * up
    else:
        up = act_fn(cfg.mlp_act)(up)
    out = torch.einsum("ecf,efd->ecd", up, p["w_down"]).reshape(n_slots, d)

    # combine (partial sum over this expert slice): add slot rows back
    contrib = out * (slot_w * valid).to(out.dtype)[:, None]
    y = torch.zeros((T, d), dtype=x_flat.dtype, device=dev).index_add(
        0, safe_tok, contrib.to(x_flat.dtype))
    if group is not None:
        # the outputs summed and aux averaged over the group, in one call
        import torch.distributed as dist
        y, aux = _AllReduce.apply(group, (1.0, 1.0 / dist.get_world_size(
            group)), y, aux)
    return y, aux


def expert_parallel(cfg, mesh) -> bool:
    """The reference's branch condition: a mesh whose ``model`` axis
    divides the experts (and spans more than this rank)."""
    return (mesh is not None and getattr(mesh, "distributed", False)
            and "model" in mesh.axis_names
            and cfg.n_experts % mesh.shape["model"] == 0)


def local_experts(p, cfg, mesh) -> dict:
    """``p`` with only this rank's experts (the router whole): what a rank
    of an expert-parallel mesh holds.  ``p`` may already be local."""
    e_loc = cfg.n_experts // mesh.shape["model"]
    off = mesh.coords["model"] * e_loc
    return {k: (v if k == "router" or v.shape[0] == e_loc
                else v[off:off + e_loc]) for k, v in p.items()}


def moe_forward(p, x, cfg, mesh=None):
    """x: (B, S, d) -> (y, aux).  Expert-parallel over the ``model`` axis
    of ``mesh`` (module docstring); ``x`` is this rank's batch shard,
    whole over ``model``.  ``p`` holds every expert or this rank's."""
    B, S, d = x.shape
    if not expert_parallel(cfg, mesh):
        y, aux = moe_apply(p, x.reshape(-1, d), cfg, 0, cfg.n_experts)
        return y.reshape(B, S, d), aux
    e_loc = cfg.n_experts // mesh.shape["model"]
    off = mesh.coords["model"] * e_loc
    y, aux = moe_apply(local_experts(p, cfg, mesh), x.reshape(-1, d), cfg,
                       off, e_loc, group=mesh.group("model"))
    # make aux truly replicated across every mesh axis
    for a in ("pod", "data"):
        if a in mesh.axis_names and mesh.shape[a] > 1:
            aux = pmean_value(aux, mesh.group(a), mesh.shape[a])
    return y.reshape(B, S, d), aux
