"""Shared model layers: norms, rotary embeddings, MLPs, init helpers
(the port of ``repro/models/layers.py``).

Parameters keep the JAX package's layouts (``w_up`` (d, d_ff), ...), so a
JAX parameter tree loads without transposes (``repro_torch.convert``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm


def normal_init(gen, shape, scale, dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 from the ``torch.Generator``
    ``gen`` on its device, then cast to ``dtype``.  ``gen=None`` gives an
    empty tensor on the meta device (shapes only)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def const_init(gen, shape, value, dtype) -> torch.Tensor:
    """A constant tensor on ``gen``'s device (meta when ``gen`` is None)."""
    dev = "meta" if gen is None else gen.device
    return torch.full(shape, value, dtype=dtype, device=dev)


def rms_norm(x, weight, eps: float = 1e-5, residual=None):
    """RMSNorm over the last axis through the rmsnorm kernel.  Without a
    residual returns ``y``; with one, normalises ``x + residual`` and
    returns ``(y, x + residual)`` (the fused form of an add then a norm).
    Differentiable: its gradient is the rmsnorm backward kernel."""
    y, res = rmsnorm(x, weight, residual, eps=eps)
    return y if residual is None else (y, res)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary position embeddings (partial rotary supported)
# ---------------------------------------------------------------------------
def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, d_rot, 2, dtype=torch.float32,
                            device=device) / d_rot
    return 1.0 / (theta ** exponent)          # (d_rot/2,)


def apply_rope(x, positions, theta: float, rope_fraction: float = 1.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Rotates
    interleaved pairs (dims 2i, 2i+1), as the JAX package does."""
    d_head = x.shape[-1]
    d_rot = int(d_head * rope_fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    rot, rest = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)
    angles = positions[..., None, None].float() * freqs   # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = rot[..., ::2].float(), rot[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(rot.shape).to(x.dtype)
    return torch.cat([rotated, rest], dim=-1)


# ---------------------------------------------------------------------------
# (gated) MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype) -> dict:
    p = {"w_up": normal_init(gen, (d_model, d_ff), d_model ** -0.5, dtype),
         "w_down": normal_init(gen, (d_ff, d_model), d_ff ** -0.5, dtype)}
    if gated:
        p["w_gate"] = normal_init(gen, (d_model, d_ff), d_model ** -0.5,
                                  dtype)
    return p


def mlp_forward(p, x, act: str):
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = act_fn(act)(x @ p["w_gate"]) * up
    else:
        up = act_fn(act)(up)
    return up @ p["w_down"]


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, mask=None):
    """logits (B, S, V) any float dtype; labels (B, S) int.  float32 math;
    the row max is held constant under differentiation, as the JAX
    package's ``stop_gradient`` holds it."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
