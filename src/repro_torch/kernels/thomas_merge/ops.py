"""Dispatch for the Thomas-merge kernel: ``csrc/thomas_merge.cu`` for CUDA
tensors, the plain version (``ref.thomas_merge_plain``) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
from repro_torch.obs.trace import kernel_launch

KERNEL = "thomas_merge"
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]


def thomas_merge(val, tidw, wrows, wvals, wtids):
    """Replication-stream apply under the Thomas write rule.  val (N, C)
    int32, tidw (N,) int64, wrows (K,) int32 (-1 = skip), wvals (K, C)
    int32, wtids (K,) int64, all contiguous.  ``val`` and ``tidw`` are
    updated in place and returned."""
    kernel_launch(KERNEL, backend=val.device.type, writes=int(wrows.shape[0]))
    if val.device.type == "cpu":
        return thomas_merge_plain(val, tidw, wrows, wvals, wtids)
    N, C = val.shape
    K = wrows.shape[0]
    dev = val.device
    chk = _build.checked
    chk("val", val, torch.int32, (N, C), dev)
    chk("tidw", tidw, torch.int64, (N,), dev)
    chk("wrows", wrows, torch.int32, (K,), dev)
    chk("wvals", wvals, torch.int32, (K, C), dev)
    chk("wtids", wtids, torch.int64, (K,), dev)
    # per-row (TID, stream index) argmax; only written rows are touched
    best = torch.empty((N,), dtype=torch.int64, device=dev)
    f = _build.bind("thomas_merge", "thomas_merge", _ARGS)
    _build.launch(KERNEL, f, val.data_ptr(), tidw.data_ptr(), best.data_ptr(),
                  wrows.data_ptr(), wvals.data_ptr(), wtids.data_ptr(), K, C,
                  _build.stream_ptr(dev))
    return val, tidw
