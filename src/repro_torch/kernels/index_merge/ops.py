"""Dispatch for the index-merge kernel.

``index_merge`` is the batched entry point ``storage.index.apply_index_ops``
reaches from both executors and both replica replays.  For CUDA tensors it
launches ``csrc/index_merge.cu`` once, on the inserts as they come: the
kernel compacts and sorts each segment's live inserts itself and handles
empty op batches, so no argsort, gather or padding runs before it.  For
CPU tensors it runs the plain version (``ref.index_merge_unsorted_plain``:
the pads, the stable insert argsort the JAX wrapper hoists, and
``ref.index_merge_plain``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
from repro_torch.obs.trace import kernel_launch

KERNEL = "index_merge"
SMEM_LIMIT = 200 * 1024        # dynamic shared memory a block may ask for

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


def index_merge(key, prow, tid, del_pq, ins_pq, prow_pq, tid_pq):
    """Apply one (P, Q) masked delete/insert batch to P sorted segments.

    key/prow/tid: (P, cap) int32/int32/int64.  del_pq/ins_pq: (P, Q) int32
    with SENTINEL = masked out; prow_pq/tid_pq the insert payloads, in the
    inserts' column order (unsorted).  Returns (key', prow', tid',
    overflow (P,) int32), bit-identical to the reference's
    ``vmap(segment_merge_ref)``.
    """
    dev = key.device
    kernel_launch(KERNEL, backend=dev.type, segments=key.shape[0])
    if dev.type == "cpu":
        return index_merge_unsorted_plain(key, prow, tid, del_pq, ins_pq,
                                          prow_pq, tid_pq)
    return index_merge_cuda(key, prow, tid, del_pq, ins_pq,
                            prow_pq.to(prow.dtype), tid_pq.to(tid.dtype))


def index_merge_cuda(key, prow, tid, del_key, ins_key, ins_prow, ins_tid,
                     smem_limit=SMEM_LIMIT):
    """Launch ``csrc/index_merge.cu`` once: same arguments and results as
    ``ref.index_merge_unsorted_plain``.  The inserts come in any order
    (the kernel sorts each row's live ones stably by key); Kd and Ki may
    be 0.  Where a block's work area needs more than ``smem_limit`` bytes
    of shared memory it lives in a global scratch buffer, one area a
    block, of the size the .cu gives."""
    P, cap = key.shape
    Kd, Ki = del_key.shape[1], ins_key.shape[1]
    dev = key.device
    args = {"key": (key, torch.int32, (P, cap)),
            "prow": (prow, torch.int32, (P, cap)),
            "tid": (tid, torch.int64, (P, cap)),
            "del_key": (del_key, torch.int32, (P, Kd)),
            "ins_key": (ins_key, torch.int32, (P, Ki)),
            "ins_prow": (ins_prow, torch.int32, (P, Ki)),
            "ins_tid": (ins_tid, torch.int64, (P, Ki))}
    ts = [_build.checked(n, t, dt, shp, dev) for n, (t, dt, shp)
          in args.items()]
    k2 = torch.empty((P, cap), dtype=torch.int32, device=dev)
    p2 = torch.empty((P, cap), dtype=torch.int32, device=dev)
    t2 = torch.empty((P, cap), dtype=torch.int64, device=dev)
    ov = torch.empty((P,), dtype=torch.int32, device=dev)
    scratch = None
    size = _build.bind("index_merge", "index_merge_area_bytes",
                       [ctypes.c_int] * 3, ctypes.c_longlong)
    if size(cap, Kd, Ki) > smem_limit:
        size = _build.bind("index_merge", "index_merge_scratch_bytes",
                           [ctypes.c_int] * 4, ctypes.c_longlong)
        scratch = torch.empty((size(P, cap, Kd, Ki) // 4,),
                              dtype=torch.int32, device=dev)
    f = _build.bind("index_merge", "index_merge", _ARGS)
    _build.launch(KERNEL, f, *[t.data_ptr() for t in ts], P, cap, Kd, Ki,
                  k2.data_ptr(), p2.data_ptr(), t2.data_ptr(), ov.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  _build.stream_ptr(dev))
    return k2, p2, t2, ov
