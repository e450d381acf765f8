"""Plain PyTorch version of the SSD kernels (``csrc/ssd.cu``): the
sequential token-by-token recurrence, mirroring
``repro/kernels/mamba2_ssd/ref.py``, and its gradient by autograd.

h_t = h_{t-1} * exp(logd_t) + (x_t * dt_t) ⊗ B_t;   y_t = C_t · h_t
"""
from __future__ import annotations

import torch


STATE_TILE = 64    # tokens between the chunk-start states (csrc/ssd.cu)


def ssd_ref(xdt, logd, Bv, Cv, heads=1, states=False):
    """xdt: (BH, S, P) f32 (= x*dt); logd: (BH, S) f32 (= dt*A);
    Bv, Cv: (BH // heads, S, N) f32, each row shared by ``heads``
    consecutive rows of xdt -> y (BH, S, P), h_final (BH, P, N); with
    ``states`` also the state before each STATE_TILE-token tile, (BH,
    ceil(S / STATE_TILE), P, N), as the forward kernel hands them to the
    backward."""
    if heads > 1:
        Bv = Bv.repeat_interleave(heads, dim=0)
        Cv = Cv.repeat_interleave(heads, dim=0)
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    h = torch.zeros((BH, P, N), device=xdt.device,
                    dtype=torch.promote_types(xdt.dtype, torch.float32))
    ys, hst = [], []
    for t in range(S):
        if t % STATE_TILE == 0:
            hst.append(h)
        h = (h * torch.exp(logd[:, t])[:, None, None]
             + xdt[:, t, :, None] * Bv[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", h, Cv[:, t]))
    if states:
        return torch.stack(ys, dim=1), h, torch.stack(hst, dim=1)
    return torch.stack(ys, dim=1), h


def ssd_backward_ref(dy, dh_final, xdt, logd, Bv, Cv, heads=1):
    """The gradient of :func:`ssd_ref` by autograd through it, in the
    inputs' dtype: from dy (BH, S, P) and dh_final (BH, P, N) or None
    (zero), returns (dxdt (BH, S, P), dlogd (BH, S), dB, dC (BH // heads,
    S, N): summed over the ``heads`` rows that share them)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xdt, logd, Bv, Cv)]
        y, h = ssd_ref(*leaves, heads=heads)
        outs, grads = (y,), (dy,)
        if dh_final is not None:
            outs, grads = (y, h), (dy, dh_final)
        return torch.autograd.grad(outs, leaves, grads)
