"""Dispatch for the rmsnorm kernel: ``csrc/rmsnorm.cu`` for CUDA tensors,
the plain version (``ref.rmsnorm_ref``) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.obs.trace import kernel_launch

KERNEL = "rmsnorm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 12288                 # the row's float32 sum in 48 KB of shared memory
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]


def rmsnorm(x, w, residual=None, *, eps=1e-5):
    """Fused residual add + RMSNorm over the last axis of ``x`` (any leading
    shape).  Returns ``(y, x + residual)``, both shaped like ``x``; without
    a residual the second is ``x``."""
    D = x.shape[-1]
    T = x.numel() // D
    kernel_launch(KERNEL, backend=x.device.type, rows=T, width=D)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps)
    if x.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: dtype {x.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if D > MAX_D:
        raise ValueError(f"rmsnorm: width {D}, the kernel takes <= {MAX_D}")
    dev = x.device
    chk = _build.checked
    # no copy of inputs that are contiguous and 16-byte aligned already
    xs = chk("x", _build.aligned16(x), x.dtype, x.shape, dev)
    ws = chk("w", _build.aligned16(w), x.dtype, (D,), dev)
    if residual is None:
        y = torch.empty_like(xs)
        r_ptr = res_ptr = None            # NULL: no residual to add
    else:
        rs = chk("residual", _build.aligned16(residual), x.dtype, x.shape,
                 dev)
        # y and x + residual in one allocation
        y, res = torch.empty((2,) + xs.shape, dtype=x.dtype,
                             device=dev).unbind(0)
        r_ptr, res_ptr = rs.data_ptr(), res.data_ptr()
    f = _build.bind("rmsnorm", "rmsnorm_fwd", _ARGS)
    _build.launch(KERNEL, f, xs.data_ptr(), r_ptr, ws.data_ptr(),
                  y.data_ptr(), res_ptr, T, D, float(eps), DTYPES[x.dtype],
                  _build.stream_ptr(dev))
    return y, (x if residual is None else res)
