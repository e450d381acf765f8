"""Routed mixture-of-experts FFN with sort-based (one-hot-free) dispatch
(the port of ``repro/models/moe.py``).

``moe_apply`` is the per-shard body: local tokens, a contiguous slice of
experts, capacity-bounded dispatch, partial-sum combine; ``moe_forward``
runs it on one device with the full expert set (the JAX package's
single-device branch).  The expert-parallel branch, experts over the
``model`` mesh axis with a ``psum`` combine, waits for the
``torch.distributed`` slice (ROADMAP Queue 1, item 7e).

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


def moe_apply(p, x_flat, cfg, expert_offset: int, n_local_experts: int):
    """Sort-based dispatch over a local expert slice.

    x_flat: (T, d).  ``p`` holds weights for ONLY the local experts
    (w_up / w_gate / w_down first dim = n_local_experts) but the full
    router.  Returns (y (T, d), aux)."""
    T, d = x_flat.shape
    k = cfg.top_k
    C = moe_capacity(T, cfg)
    dev = x_flat.device

    weights, ids, aux = route(p["router"], x_flat, cfg)

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
    buf = x_flat.index_select(0, safe_tok) * valid.to(x_flat.dtype)[:, None]
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
    return y, aux


def moe_forward(p, x, cfg):
    """x: (B, S, d) -> (y, aux), every expert on this device."""
    B, S, d = x.shape
    y, aux = moe_apply(p, x.reshape(-1, d), cfg, 0, cfg.n_experts)
    return y.reshape(B, S, d), aux
