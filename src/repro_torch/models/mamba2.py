"""Mamba-2 (SSD, arXiv:2405.21060) block: the port of
``repro/models/mamba2.py``.

Prefill runs the chunked SSD scan through the ``mamba2_ssd`` kernel, where
the JAX model computes the same chunked algorithm in XLA; the ``D`` skip
and the gated norm follow as in the JAX code.  Decode is the O(1)
recurrent step in plain PyTorch, as in JAX.  ``ngroups = 1``: B and C are
shared across heads, and the kernel reads them once per batch row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.ops import ssd
from repro_torch.models.layers import const_init, normal_init, rms_norm


def init_mamba2(gen, cfg, dtype) -> dict:
    d, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.n_ssm_heads, cfg.ssm_conv_width)
    d_proj = 2 * di + 2 * N + H                     # x, z, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": normal_init(gen, (d, d_proj), d ** -0.5, dtype),
        "conv_w": normal_init(gen, (W, di + 2 * N), 0.5, dtype),
        "conv_b": const_init(gen, (di + 2 * N,), 0.0, dtype),
        "dt_bias": const_init(gen, (H,), 0.0, f32),
        "A_log": const_init(gen, (H,), 0.0, f32),   # A = -exp(A_log) = -1
        "D": const_init(gen, (H,), 1.0, f32),
        "gate_norm": const_init(gen, (di,), 1.0, dtype),
        "out_proj": normal_init(gen, (di, d), di ** -0.5, dtype),
    }


def _split_proj(proj, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    xz, rest = proj[..., : 2 * di], proj[..., 2 * di:]
    x_in, z = xz[..., :di], xz[..., di:]
    Bv, Cv, dt = rest[..., :N], rest[..., N: 2 * N], rest[..., 2 * N:]
    return x_in, z, Bv, Cv, dt


def _causal_conv(u, w, b):
    """u: (B, S, C); w: (W, C) depthwise causal conv via shifted adds (not
    ``F.conv1d``, which runs in TF32 on the card by default)."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    S = u.shape[1]
    out = torch.zeros_like(u)
    for i in range(W):
        out = out + pad[:, i: i + S, :] * w[i]
    return F.silu(out + b)


def ssm_chunk(cfg, S: int) -> int:
    """The largest divisor of S that is <= cfg.ssm_chunk."""
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    return Q


def mamba2_forward(p, x, cfg, return_state: bool = False):
    """x: (B, S, d) -> (y (B, S, d), {"h", "conv"} decode state or None)."""
    Bsz, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim

    proj = x @ p["in_proj"]
    x_in, z, Bv, Cv, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([x_in, Bv, Cv], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    x_in, Bv, Cv = (conv_out[..., :di], conv_out[..., di: di + N],
                    conv_out[..., di + N:])

    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    logd = dt * A                                                 # log decay
    xh = x_in.reshape(Bsz, S, H, P)
    xdt = xh.float() * dt[..., None]                              # (B,S,H,P)

    y, h_last = ssd(xdt.permute(0, 2, 1, 3).reshape(Bsz * H, S, P),
                    logd.permute(0, 2, 1).reshape(Bsz * H, S),
                    Bv.float(), Cv.float(), chunk=ssm_chunk(cfg, S),
                    heads=H)
    y = y.reshape(Bsz, H, S, P).permute(0, 2, 1, 3)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["gate_norm"])
    out = y @ p["out_proj"]
    if return_state:
        W = cfg.ssm_conv_width
        conv_tail = F.pad(conv_in, (0, 0, W - 1, 0))[:, -(W - 1):, :]
        return out, {"h": h_last.reshape(Bsz, H, P, N), "conv": conv_tail}
    return out, None


def mamba2_decode(p, x, cache, cfg):
    """One-token step.  x: (B, 1, d); cache: {"h": (B, H, P, N) f32,
    "conv": (B, W-1, C)}.  Returns (y, new cache)."""
    Bsz = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"]
    x_in, z, Bv, Cv, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([x_in, Bv, Cv], dim=-1)                   # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)           # (B,W,C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                      + p["conv_b"])[:, None, :]
    x_in, Bv, Cv = (conv_out[..., :di], conv_out[..., di: di + N],
                    conv_out[..., di + N:])

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]             # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                        # (B,H)
    xh = x_in.reshape(Bsz, H, P).float()
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhpn", Bv[:, 0].float(), xh, dt)
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0].float(), h)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    out = y @ p["out_proj"]
    return out, {"h": h, "conv": window[:, 1:, :]}


def init_mamba2_cache(cfg, batch, dtype, device):
    di, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_head_dim, cfg.ssm_conv_width)
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, W - 1, di + 2 * N), dtype=dtype,
                            device=device),
    }
