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
    int32, wtids (K,) int64.  ``val`` and ``tidw`` are updated in place
    and returned."""
    kernel_launch(KERNEL, backend=val.device.type, writes=int(wrows.shape[0]))
    if val.device.type == "cpu":
        return thomas_merge_plain(val, tidw, wrows, wvals, wtids)
    N, C = val.shape
    K = wrows.shape[0]
    dev = val.device
    chk = _build.checked
    ins = [chk("val", val, torch.int32, (N, C), dev),
           chk("tidw", tidw, torch.int64, (N,), dev)]
    # per-row (TID, stream index) argmax; only written rows are touched
    best = torch.empty((N,), dtype=torch.int64, device=dev)
    ws = [chk("wrows", wrows.contiguous(), torch.int32, (K,), dev),
          chk("wvals", wvals.contiguous(), torch.int32, (K, C), dev),
          chk("wtids", wtids.contiguous(), torch.int64, (K,), dev)]
    f = _build.bind("thomas_merge", "thomas_merge", _ARGS)
    _build.launch(KERNEL, f, ins[0].data_ptr(), ins[1].data_ptr(),
                  best.data_ptr(), *[t.data_ptr() for t in ws], K, C,
                  _build.stream_ptr(dev))
    return val, tidw
