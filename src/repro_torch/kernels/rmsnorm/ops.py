"""Dispatch for the rmsnorm kernel: ``csrc/rmsnorm.cu`` for CUDA tensors,
the plain version (``ref.rmsnorm_ref``) for CPU tensors.

:func:`rmsnorm` is differentiable: where grad mode is on and an input wants
a gradient it goes through :class:`_RMSNorm`, whose backward is the
backward kernel (``rmsnorm_bwd``: dx, dw and d(residual)) or, for CPU
tensors, autograd through the plain version.  Otherwise (serving) it is the
forward kernel alone, as before."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.obs.trace import kernel_launch

KERNEL = "rmsnorm"
BACKWARD = f"{KERNEL}.backward"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 12288                 # the row's float32 sum in 48 KB of shared memory
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
# x, r, w, dy, dres, dx, part, dw; T, D, G, eps, dtype, stream
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p]
# T, D, dtype -> the backward's blocks (its dw partials)
_BWD_BLOCKS_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
_GRIDS: dict = {}             # (T, D, dtype, device) -> the backward's blocks


def rmsnorm(x, w, residual=None, *, eps=1e-5):
    """Fused residual add + RMSNorm over the last axis of ``x`` (any leading
    shape).  Returns ``(y, x + residual)``, both shaped like ``x``; without
    a residual the second is ``x``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, residual)):
        if residual is None:
            return _RMSNorm.apply(x, w, None, eps), x
        return _RMSNorm.apply(x, w, residual, eps)
    return _forward(x, w, residual, eps)


def _check(x, D):
    if x.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: dtype {x.dtype}, the kernel takes "
                         f"float32 or bfloat16")
    if D > MAX_D:
        raise ValueError(f"rmsnorm: width {D}, the kernel takes <= {MAX_D}")


def _forward(x, w, residual, eps):
    D = x.shape[-1]
    T = x.numel() // D
    kernel_launch(KERNEL, backend=x.device.type, rows=T, width=D)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps)
    _check(x, D)
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


def rmsnorm_backward(dy, dres, x, w, residual=None, *, eps=1e-5):
    """The gradient of :func:`rmsnorm`: ``(dx, dw)`` from ``dy`` (the
    gradient of ``y``) and, in the residual form, ``dres`` (that of ``x +
    residual``; None counts as zero).  The gradient of the residual is
    ``dx`` itself.  CUDA tensors run the backward kernel; CPU tensors
    differentiate the plain version."""
    D = x.shape[-1]
    T = x.numel() // D
    kernel_launch(BACKWARD, backend=x.device.type, rows=T, width=D)
    if x.device.type == "cpu":
        with torch.enable_grad():
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            if residual is None:
                y, _ = rmsnorm_ref(xl, wl, None, eps)
                return torch.autograd.grad(y, (xl, wl), dy)
            y, s = rmsnorm_ref(xl, wl, residual.detach(), eps)
            outs, grads = (y, s), (dy, dres)
            if dres is None:
                outs, grads = (y,), (dy,)
            return torch.autograd.grad(outs, (xl, wl), grads)
    _check(x, D)
    dev = x.device
    chk = _build.checked
    xs = chk("x", _build.aligned16(x), x.dtype, x.shape, dev)
    ws = chk("w", _build.aligned16(w), x.dtype, (D,), dev)
    gs = chk("dy", _build.aligned16(dy), x.dtype, x.shape, dev)
    r_ptr = dr_ptr = None
    if residual is not None:
        r_ptr = chk("residual", _build.aligned16(residual), x.dtype, x.shape,
                    dev).data_ptr()
        if dres is not None:
            dr_ptr = chk("dres", _build.aligned16(dres), x.dtype, x.shape,
                         dev).data_ptr()
    G = _bwd_blocks(T, D, x.dtype, dev)
    dx = torch.empty_like(xs)
    dw = torch.empty_like(ws)
    part = torch.empty((max(G, 1), D), dtype=torch.float32, device=dev)
    f = _build.bind("rmsnorm", "rmsnorm_bwd", _BWD_ARGS)
    _build.launch(BACKWARD, f, xs.data_ptr(), r_ptr, ws.data_ptr(),
                  gs.data_ptr(), dr_ptr, dx.data_ptr(), part.data_ptr(),
                  dw.data_ptr(), T, D, G, float(eps), DTYPES[x.dtype],
                  _build.stream_ptr(dev))
    return dx, dw


def _bwd_blocks(T, D, dtype, dev) -> int:
    """The backward kernel's grid for T rows of width D: as many blocks as
    the card holds at once (the kernel's occupancy on ``dev``), no more
    than the rows need; 0 for no rows."""
    if T == 0:
        return 0
    key = (T, D, dtype, dev)
    G = _GRIDS.get(key)
    if G is None:
        f = _build.bind("rmsnorm", "rmsnorm_bwd_blocks", _BWD_BLOCKS_ARGS)
        with torch.cuda.device(dev):
            G = f(T, D, DTYPES[dtype])
        if G <= 0:
            raise RuntimeError(f"rmsnorm backward: no grid for {T} x {D} "
                               f"(CUDA error {-G})")
        _GRIDS[key] = G
    return G


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with the backward kernel as its gradient.  Outputs ``y``
    alone without a residual, ``(y, x + residual)`` with one."""

    @staticmethod
    def forward(ctx, x, w, residual, eps):
        y, res = _forward(x, w, residual, eps)
        ctx.save_for_backward(x, w, residual)
        ctx.eps = eps
        return y if residual is None else (y, res)

    @staticmethod
    def backward(ctx, dy, dres=None):
        x, w, residual = ctx.saved_tensors
        dx, dw = rmsnorm_backward(dy, dres, x, w, residual, eps=ctx.eps)
        return dx, dw, (None if residual is None else dx), None
