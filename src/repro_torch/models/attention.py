"""GQA attention with partial RoPE, sliding windows and a slot-indexed
decode cache, and MLA, multi-head latent attention (MiniCPM3): the port of
``repro/models/attention.py``.

Where the JAX model computes attention in XLA (``_attend`` /
``chunked_attention``), the port calls the flash-attention kernel:
``ops.mha`` for prefill, ``ops.decode`` for one-token steps against the
slot cache.  The kernel reads the kv heads unexpanded through
``cfg.kv_index_map()``, the query head -> kv head map, which is irregular
under padded heads (``cfg.pad_heads_to``); only the kernel's plain version
expands them (``flash_attention.ref.expand_kv``, as the JAX model
does).

MLA runs prefill and training in the expanded form, through ``ops.mha``
at q/k head dim ``qk_nope + qk_rope`` (96) and v head dim ``v_head_dim``
(64), and decodes in the absorbed form, whose cache holds only the latent
``c_kv`` and the rotary key ``k_rope``: its einsums and softmax are
PyTorch ops, as the JAX model computes them outside any Pallas kernel.

The decode caches are updated in place (JAX returns new ones).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import (apply_rope, const_init, normal_init,
                                       rms_norm)

NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 family)
# ---------------------------------------------------------------------------
def init_mla(gen, cfg, dtype) -> dict:
    d, H = cfg.d_model, cfg.n_heads_padded
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    s = d ** -0.5
    return {
        "w_dq": normal_init(gen, (d, qr), s, dtype),
        "q_norm": const_init(gen, (qr,), 1.0, dtype),
        "w_uq": normal_init(gen, (qr, H, dn + dr), qr ** -0.5, dtype),
        "w_dkv": normal_init(gen, (d, kvr), s, dtype),
        "kv_norm": const_init(gen, (kvr,), 1.0, dtype),
        "w_kr": normal_init(gen, (d, dr), s, dtype),
        "w_uk": normal_init(gen, (kvr, H, dn), kvr ** -0.5, dtype),
        "w_uv": normal_init(gen, (kvr, H, dv), kvr ** -0.5, dtype),
        "wo": normal_init(gen, (H, dv, d), (H * dv) ** -0.5, dtype),
    }


def _mla_qkv(p, x, cfg, positions):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr), c_kv (B, S, kvr),
    k_rope (B, S, dr)), the rotary halves rotated at ``positions``."""
    dn = cfg.qk_nope_head_dim
    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])        # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions[None, :], cfg.rope_theta)
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"])            # (B,S,kvr)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions[None, :],
                        cfg.rope_theta)[:, :, 0]             # (B,S,dr)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, x, cfg, positions):
    """Expanded-form MLA (prefill, training): K and V up-projected from
    the latent for every head, k_rope shared by the heads; attention
    through the flash kernel at head dims (dn + dr, dv), scaled by
    (dn + dr) ** -0.5.  Returns (y, (c_kv, k_rope)) for cache seeding."""
    B, S, _ = x.shape
    H = cfg.n_heads_padded
    dr = cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])   # (B,S,H,dn)
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])        # (B,S,H,dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    out = fa.mha(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                 scale=(cfg.qk_nope_head_dim + dr) ** -0.5)
    return _output(p, out, cfg), (c_kv, k_rope)


def mla_decode(p, x, cache, cfg):
    """Absorbed-form one-token MLA.  x: (B, 1, d).  cache: {"c_kv": (B,
    S_alloc, kvr), "k_rope": (B, S_alloc, dr), "slot_pos": (S_alloc,)
    int32, "pos": int}.  W_uk is folded into the query and W_uv applied
    after the latent sum, so the cache is never up-projected; the scores
    in float32, as the JAX model asks (``preferred_element_type``).
    Writes the token's latent into slot ``pos % S_alloc`` in place and
    returns (y, cache)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos = int(cache["pos"])
    S_alloc = cache["c_kv"].shape[1]
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, pvec)
    slot = pos % S_alloc
    cache["c_kv"][:, slot] = c_kv_new[:, 0]
    cache["k_rope"][:, slot] = k_rope_new[:, 0]
    cache["slot_pos"][slot] = pos
    c_kv, k_rope, slot_pos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])  # (B,1,H,kvr)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
              + torch.einsum("bshe,bte->bhst", q_rope.float(),
                             k_rope.float())) * (dn + dr) ** -0.5
    mask = (slot_pos >= 0) & (slot_pos <= pos)                # (S_alloc,)
    scores = scores.masked_fill(~mask, NEG_INF)               # (B,H,1,S)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(c_kv.dtype), c_kv)
    out = torch.einsum("bshr,rhe->bshe", out_lat, p["w_uv"])  # (B,1,H,dv)
    return _output(p, out, cfg), cache


def init_mla_cache(cfg, batch, seq_len, dtype, device):
    """An empty latent cache (a ring under a sliding window)."""
    S_alloc = (seq_len if cfg.sliding_window is None
               else min(seq_len, cfg.sliding_window))
    return {
        "c_kv": torch.zeros((batch, S_alloc, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, S_alloc, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "slot_pos": torch.full((S_alloc,), -1, dtype=torch.int32,
                               device=device),
        "pos": 0,
    }
