"""Dispatch for the SSD kernel: ``csrc/ssd.cu`` for CUDA tensors, the
plain version (``ref.ssd_ref``) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref
from repro_torch.obs.trace import kernel_launch

KERNEL = "mamba2_ssd"
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def ssd(xdt, logd, Bv, Cv, *, chunk=128, heads=1):
    """Chunked SSD scan.  xdt (BH, S, P), logd (BH, S), Bv/Cv
    (BH // heads, S, N), all float32: B and C are shared by ``heads``
    consecutive rows of xdt (Mamba-2's ngroups = 1), so the caller need
    not copy them per head.  Returns y (BH, S, P) without the D skip, and
    the final state (BH, P, N).  On the card a chunk runs as chunks of at
    most 64 tokens (the same function; see ``csrc/ssd.cu``)."""
    BH, S, P = xdt.shape
    N = Bv.shape[-1]
    chunk = min(chunk, S)
    kernel_launch(KERNEL, backend=xdt.device.type, heads=BH, seq=S)
    if xdt.device.type == "cpu":
        return ssd_ref(xdt, logd, Bv, Cv, heads=heads)
    if BH % heads:
        raise ValueError(f"ssd: {BH} rows are not groups of {heads} heads")
    dev = xdt.device
    f32 = torch.float32
    chk = _build.checked
    ins = [chk("xdt", xdt.contiguous(), f32, (BH, S, P), dev),
           chk("logd", logd.contiguous(), f32, (BH, S), dev),
           chk("Bv", Bv.contiguous(), f32, (BH // heads, S, N), dev),
           chk("Cv", Cv.contiguous(), f32, (BH // heads, S, N), dev)]
    y = torch.empty((BH, S, P), dtype=f32, device=dev)
    hfin = torch.empty((BH, P, N), dtype=f32, device=dev)
    f = _build.bind("ssd", "ssd_fwd", _ARGS)
    _build.launch(KERNEL, f, *[t.data_ptr() for t in ins], y.data_ptr(),
                  hfin.data_ptr(), BH, S, P, N, chunk, heads,
                  _build.stream_ptr(dev))
    return y, hfin
