"""AdamW with float32 master weights (the port of
``repro/train/optimizer.py``).

Parameters live in the model's dtype (bf16 for compute); the optimizer
state is ``{"master", "m", "v"}``, dicts of float32 tensors keyed by the
model's parameter names, and ``"step"``, an int32 scalar on the device.
Where the JAX package returns new trees, :func:`adamw_update` updates the
state and the parameters in place (one copy of the state, 16 bytes a
parameter, instead of two); the arithmetic is the JAX package's, in the
same order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: dict) -> dict:
    """float32 master copies (never aliasing the parameters), zero moments
    and step 0, on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's float32 sum of squares."""
    leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params: dict | None, grads: dict, opt_state: dict,
                 hp: AdamWConfig, gnorm=None):
    """One AdamW step with global-norm clipping and linear warmup, in
    place: ``opt_state``'s tensors and the parameters (each set to its
    master cast to its dtype).  Returns (params, opt_state, grad norm).

    On a mesh a rank updates only the state it owns: ``grads`` and
    ``opt_state`` are then its shards, ``gnorm`` the norm of the whole
    gradient, and ``params`` None (the caller gathers the masters)."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(hp.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    lr = hp.lr * torch.clamp(stepf / hp.warmup_steps, max=1.0)
    b1t = 1.0 - hp.b1 ** stepf
    b2t = 1.0 - hp.b2 ** stepf
    for k in grads:
        master, m, v = (opt_state[s][k] for s in ("master", "m", "v"))
        g = grads[k].float() * scale
        m.copy_(hp.b1 * m + (1 - hp.b1) * g)
        v.copy_(hp.b2 * v + (1 - hp.b2) * torch.square(g))
        mh = m / b1t
        vh = v / b2t
        master.copy_(master - lr * (mh / (torch.sqrt(vh) + hp.eps)
                                    + hp.weight_decay * master))
        if params is not None:
            params[k].copy_(master)
    opt_state["step"] = step
    return params, opt_state, gnorm
