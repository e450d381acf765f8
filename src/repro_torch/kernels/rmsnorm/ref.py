"""Plain PyTorch version of the rmsnorm kernel (``csrc/rmsnorm.cu``).

It copies the Pallas kernel (``repro/kernels/rmsnorm/kernel.py::_rms_kernel``),
not the JAX oracle ``rmsnorm_ref``: the residual sum ``x + r`` is taken in
float32 and normalised unrounded; only the two outputs are rounded to x's
type.  The JAX oracle rounds the sum to x's type first.  In float32 the two
are the same function; in bfloat16 they differ by at most a rounding step of
the sum, inside the 2e-2 that ``tests/test_kernels.py`` allows them.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x, w, residual=None, eps: float = 1e-5):
    """x (T, D); w (D,); optional residual (T, D) added BEFORE the norm.
    Returns (y, x + residual) in x's dtype (the second is ``x`` itself
    when there is no residual)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype), (xf.to(x.dtype) if residual is not None else x)
