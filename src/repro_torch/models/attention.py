"""GQA attention with partial RoPE, sliding windows and a slot-indexed
decode cache (the GQA half of ``repro/models/attention.py``; MLA waits for
ROADMAP Queue 1, item 7c).

Where the JAX model computes attention in XLA (``_attend`` /
``chunked_attention``), the port calls the flash-attention kernel:
``ops.mha`` for prefill, ``ops.decode`` for one-token steps against the
slot cache.  The kernel reads the kv heads unexpanded through
``cfg.kv_index_map()``, the query head -> kv head map, which is irregular
under padded heads (``cfg.pad_heads_to``); only the kernel's plain version
expands them (``flash_attention.ref.expand_kv``, as the JAX model
does).

The decode cache is updated in place (JAX returns a new one).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import apply_rope, const_init, normal_init


def init_attention(gen, cfg, dtype) -> dict:
    d, Dh = cfg.d_model, cfg.d_head
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    s = d ** -0.5
    return {
        "wq": normal_init(gen, (d, H, Dh), s, dtype),
        "wk": normal_init(gen, (d, Hkv, Dh), s, dtype),
        "wv": normal_init(gen, (d, Hkv, Dh), s, dtype),
        "wo": normal_init(gen, (H, Dh, d), (H * Dh) ** -0.5, dtype),
    }


def _head_mask(cfg, dtype, device):
    """(H_pad,) mask: pad heads contribute zero."""
    if cfg.n_heads_padded == cfg.n_heads:
        return None
    return (torch.arange(cfg.n_heads_padded, device=device)
            < cfg.n_heads).to(dtype)


def _project(p, x, cfg, positions):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    q = apply_rope(q, positions[None, :], cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions[None, :], cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _output(p, out, cfg):
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def attention_forward(p, x, cfg, positions):
    """Full-sequence attention (prefill).  x: (B, S, d); positions: (S,)
    int32.  Returns (y, (k, v)) with k/v post-RoPE for cache seeding."""
    q, k, v = _project(p, x, cfg, positions)
    out = fa.mha(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                 kv_head=cfg.kv_index_map())
    return _output(p, out, cfg), (k, v)


def attention_decode(p, x, cache, cfg):
    """One-token decode.  x: (B, 1, d).  cache: {"k": (B, S_alloc, Hkv, Dh),
    "v": ..., "slot_pos": (S_alloc,) int32, "pos": int — the absolute
    position of the incoming token}.  Writes the token's k/v into slot
    ``pos % S_alloc`` in place and returns (y, cache)."""
    pos = int(cache["pos"])
    S_alloc = cache["k"].shape[1]
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(p, x, cfg, pvec)
    slot = pos % S_alloc
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["slot_pos"][slot] = pos
    out = fa.decode(q, cache["k"], cache["v"], cache["slot_pos"], pos,
                    window=cfg.sliding_window, kv_head=cfg.kv_index_map())
    return _output(p, out, cfg), cache


def init_attn_cache(cfg, batch, seq_len, dtype, device):
    """An empty slot cache; sliding-window archs get a ring buffer."""
    S_alloc = (seq_len if cfg.sliding_window is None
               else min(seq_len, cfg.sliding_window))
    shape = (batch, S_alloc, cfg.n_kv_heads_padded, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((S_alloc,), -1, dtype=torch.int32,
                               device=device),
        "pos": 0,
    }
