"""Plain PyTorch version of the SSD kernel (``csrc/ssd.cu``): the
sequential token-by-token recurrence, mirroring
``repro/kernels/mamba2_ssd/ref.py``.

h_t = h_{t-1} * exp(logd_t) + (x_t * dt_t) ⊗ B_t;   y_t = C_t · h_t
"""
from __future__ import annotations

import torch


def ssd_ref(xdt, logd, Bv, Cv, heads=1):
    """xdt: (BH, S, P) f32 (= x*dt); logd: (BH, S) f32 (= dt*A);
    Bv, Cv: (BH // heads, S, N) f32, each row shared by ``heads``
    consecutive rows of xdt -> y (BH, S, P), h_final (BH, P, N)."""
    if heads > 1:
        Bv = Bv.repeat_interleave(heads, dim=0)
        Cv = Cv.repeat_interleave(heads, dim=0)
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        h = (h * torch.exp(logd[:, t])[:, None, None]
             + xdt[:, t, :, None] * Bv[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", h, Cv[:, t]))
    return torch.stack(ys, dim=1), h
