"""Dispatch for the index-merge kernel.

``index_merge`` is the batched entry point ``storage.index.apply_index_ops``
reaches from both executors and both replica replays.  It pads empty op
batches with inert SENTINEL columns, runs the stable insert argsort (the
reference's per-segment sort, hoisted where the JAX wrapper hoists it),
and then launches ``csrc/index_merge.cu`` for CUDA tensors or runs the
plain version (``ref.index_merge_plain``) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.index_merge.ref import index_merge_plain
from repro_torch.obs.trace import kernel_launch
from repro_torch.storage.index import SENTINEL

KERNEL = "index_merge"
SMEM_LIMIT = 200 * 1024        # dynamic shared memory a block may ask for

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


def index_merge(key, prow, tid, del_pq, ins_pq, prow_pq, tid_pq):
    """Apply one (P, Q) masked delete/insert batch to P sorted segments.

    key/prow/tid: (P, cap) int32/int32/int64.  del_pq/ins_pq: (P, Q) int32
    with SENTINEL = masked out; prow_pq/tid_pq the insert payloads.
    Returns (key', prow', tid', overflow (P,) int32), bit-identical to the
    reference's ``vmap(segment_merge_ref)``.
    """
    P = key.shape[0]
    dev = key.device
    kernel_launch(KERNEL, backend=dev.type, segments=P)
    if del_pq.shape[1] == 0:           # inert: SENTINEL dels never hit
        del_pq = torch.full((P, 1), SENTINEL, dtype=torch.int32, device=dev)
    if ins_pq.shape[1] == 0:           # the reference's Ki == 0 pad
        ins_pq = torch.full((P, 1), SENTINEL, dtype=torch.int32, device=dev)
        prow_pq = torch.zeros((P, 1), dtype=prow.dtype, device=dev)
        tid_pq = torch.zeros((P, 1), dtype=tid.dtype, device=dev)
    iorder = torch.argsort(ins_pq, dim=1, stable=True)
    ik = ins_pq.gather(1, iorder)
    ip = prow_pq.gather(1, iorder).to(prow.dtype)
    it = tid_pq.gather(1, iorder).to(tid.dtype)
    if dev.type == "cpu":
        return index_merge_plain(key, prow, tid, del_pq, ik, ip, it)
    return index_merge_cuda(key, prow, tid, del_pq, ik, ip, it)


def index_merge_cuda(key, prow, tid, del_key, ik, ip, it,
                     smem_limit=SMEM_LIMIT):
    """Launch ``csrc/index_merge.cu``: same arguments and results as
    ``ref.index_merge_plain`` (inserts pre-sorted, Kd and Ki ≥ 1).  A
    segment's scratch words go to global memory when they need more than
    ``smem_limit`` bytes of shared memory."""
    P, cap = key.shape
    Kd, Ki = del_key.shape[1], ik.shape[1]
    dev = key.device
    args = {"key": (key, torch.int32, (P, cap)),
            "prow": (prow, torch.int32, (P, cap)),
            "tid": (tid, torch.int64, (P, cap)),
            "del_key": (del_key, torch.int32, (P, Kd)),
            "ins_key": (ik, torch.int32, (P, Ki)),
            "ins_prow": (ip, torch.int32, (P, Ki)),
            "ins_tid": (it, torch.int64, (P, Ki))}
    ts = [_build.checked(n, t, dt, shp, dev) for n, (t, dt, shp)
          in args.items()]
    if Kd < 1 or Ki < 1:
        raise ValueError("index_merge_cuda needs Kd >= 1 and Ki >= 1")
    k2 = torch.empty((P, cap), dtype=torch.int32, device=dev)
    p2 = torch.empty((P, cap), dtype=torch.int32, device=dev)
    t2 = torch.empty((P, cap), dtype=torch.int64, device=dev)
    ov = torch.empty((P,), dtype=torch.int32, device=dev)
    scratch = None
    if (cap + 1 + Ki) * 4 > smem_limit:
        scratch = torch.empty((P, cap + 1 + Ki), dtype=torch.int32,
                              device=dev)
    f = _build.bind("index_merge", "index_merge", _ARGS)
    _build.launch(KERNEL, f, *[t.data_ptr() for t in ts], P, cap, Kd, Ki,
                  k2.data_ptr(), p2.data_ptr(), t2.data_ptr(), ov.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  _build.stream_ptr(dev))
    return k2, p2, t2, ov
