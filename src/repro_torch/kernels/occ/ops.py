"""Dispatch for the OCC kernels, port of ``repro.kernels.occ.ops``.

The ordered-index probe (``csrc/scan_window.cu``) has three launch
configurations, one launch a call each, all reading the index tables in
place:

* :func:`scan_window` — the bare probe over a flat key array with a
  segment per query (``storage.index.segment_scan``);
* :func:`step_index_ops` — a partitioned queue slot's index ops, writing
  the executor's ``consume_ok`` and ``slot_tid`` itself;
* :func:`locate_index_ops` — a single-master round's index ops, writing
  the claim, scan-window and consume outputs in the flat row + index-slot
  address space itself.

:func:`occ_round` runs one OCC round as one cooperative launch of
``csrc/occ_round.cu`` (claim, validate + TID, install + release) on lock
arrays the caller holds (:func:`lock_arrays`).

Each launches its CUDA kernel for CUDA tensors, and runs its plain
version (``ref.py``) for CPU tensors; a CUDA tensor the kernel does not
take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ops import IX_ID
from repro_torch.kernels import _build
from repro_torch.kernels.occ.ref import (locate_index_ops_plain,
                                         occ_round_plain, scan_window_plain,
                                         step_index_ops_plain)
from repro_torch.obs.trace import kernel_launch
from repro_torch.storage.index import SCAN_L

VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
MAX_INDEXES = 8             # csrc/scan_window.cu MAX_INDEXES
_SCAN_ARGS = [VP] * 5 + [I32] * 2 + [VP] * 4
_SEG_ARGS = [VP, VP, VP, I32, I32]
_OPS_ARGS = [VP, I64, VP, I64, I64]
_PART_ARGS = _SEG_ARGS + _OPS_ARGS + [I32] + [VP] * 3
_SM_ARGS = _SEG_ARGS + _OPS_ARGS + [I32] * 5 + [VP] * 7
_ROUND_ARGS = [VP] * 21 + [I32] * 5 + [ctypes.c_uint, VP]


# ---------------------------------------------------------------------------
# the probe, bare: lower-bound search + bounded window gather
# ---------------------------------------------------------------------------
def scan_window(flat_key, flat_tid, q, seg_base, seg_cap, *, n_slots: int,
                max_cap: int):
    """flat_key (S,) int32 / flat_tid (S,) int64 concatenated sorted
    segments; q/seg_base/seg_cap (Q,) int32 per-query key, segment start
    and length (>= 1, at most ``max_cap``, a host int).  Returns (pos0 (Q,)
    int32, keys (Q, n_slots) int32, tids (Q, n_slots) int64).  The kernel
    searches each segment to its end; the plain version takes the
    reference's ``bit_length(max_cap) + 1`` halvings, which cover the
    longest segment, so the two agree by construction."""
    kernel_launch("scan_window", backend=flat_key.device.type,
                  queries=int(q.shape[0]))
    if flat_key.device.type == "cpu":
        return scan_window_plain(flat_key, flat_tid, q, seg_base, seg_cap,
                                 n_slots=n_slots,
                                 n_iters=int(max_cap).bit_length() + 1)
    dev = flat_key.device
    S, Q = flat_key.shape[0], q.shape[0]
    ins = [_build.checked("flat_key", flat_key, torch.int32, (S,), dev),
           _build.checked("flat_tid", flat_tid, torch.int64, (S,), dev),
           _build.checked("q", q, torch.int32, (Q,), dev),
           _build.checked("seg_base", seg_base, torch.int32, (Q,), dev),
           _build.checked("seg_cap", seg_cap, torch.int32, (Q,), dev)]
    pos = torch.empty((Q,), dtype=torch.int32, device=dev)
    keys = torch.empty((Q, n_slots), dtype=torch.int32, device=dev)
    tids = torch.empty((Q, n_slots), dtype=torch.int64, device=dev)
    f = _build.bind("scan_window", "scan_window", _SCAN_ARGS)
    _build.launch("scan_window", f, *[t.data_ptr() for t in ins], Q,
                  n_slots, pos.data_ptr(), keys.data_ptr(),
                  tids.data_ptr(), _build.stream_ptr(dev))
    return pos, keys, tids


def _segments(index, dev):
    """The C entry's view of the index tables: (keys, tids, caps) host
    arrays, the table count and P.  Every table lies on ``dev``, is
    contiguous and (P, cap_i) with cap_i >= 1."""
    n = len(index)
    if not 1 <= n <= MAX_INDEXES:
        raise ValueError(f"{n} indexes: the probe takes 1 to {MAX_INDEXES}")
    P = index[0]["key"].shape[0]
    caps = [ix["key"].shape[1] for ix in index]
    if min(caps) < 1 or P * sum(caps) >= 2 ** 31:
        raise ValueError(f"index caps {caps} at P={P}: each must be >= 1 "
                         f"and the flat slot space below 2^31")
    keys = [_build.checked(f"index[{i}].key", ix["key"], torch.int32,
                           (P, c), dev) for i, (ix, c) in
            enumerate(zip(index, caps))]
    tids = [_build.checked(f"index[{i}].tid", ix["tid"], torch.int64,
                           (P, c), dev) for i, (ix, c) in
            enumerate(zip(index, caps))]
    return ((VP * n)(*[t.data_ptr() for t in keys]),
            (VP * n)(*[t.data_ptr() for t in tids]),
            (I32 * n)(*caps), n, P)


def _ops_in(kinds, delta, rows, K, dev):
    """kinds (rows, K) int32 and delta (rows, K, >= 4) int32 on ``dev``,
    read in place through their strides (the executors pass slices of the
    whole op arrays): (pointer, row stride, pointer, row and op
    strides)."""
    if kinds.device != dev or delta.device != dev:
        raise ValueError(f"kinds on {kinds.device}, delta on "
                         f"{delta.device}: the kernel needs {dev}")
    if kinds.dtype != torch.int32 or delta.dtype != torch.int32:
        raise ValueError("kinds and delta must be int32")
    if (tuple(kinds.shape) != (rows, K) or delta.dim() != 3
            or tuple(delta.shape[:2]) != (rows, K)
            or delta.shape[2] <= IX_ID):
        raise ValueError(f"kinds {tuple(kinds.shape)} / delta "
                         f"{tuple(delta.shape)}: expected ({rows}, {K}) and "
                         f"({rows}, {K}, > {IX_ID})")
    if kinds.stride(1) != 1 or delta.stride(2) != 1:
        raise ValueError("kinds and delta need unit stride in their last "
                         "dimension")
    return (kinds.data_ptr(), kinds.stride(0), delta.data_ptr(),
            delta.stride(0), delta.stride(1))


# ---------------------------------------------------------------------------
# the probe, partitioned: one queue slot's index ops
# ---------------------------------------------------------------------------
def step_index_ops(index, kinds, delta):
    """Resolve one partitioned queue slot's index ops: (consume_ok (P, K)
    bool, slot_tid (P, K) int64).  Each partition probes its OWN
    segment."""
    Pq, K = kinds.shape
    dev = kinds.device
    kernel_launch("scan_window.partitioned", backend=dev.type,
                  queries=Pq * K)
    if dev.type == "cpu":
        return step_index_ops_plain(index, kinds, delta)
    seg = _segments(index, dev)
    if seg[4] != Pq:
        raise ValueError(f"{Pq} queue rows against {seg[4]} partitions")
    ops_in = _ops_in(kinds, delta, Pq, K, dev)
    consume_ok = torch.empty((Pq, K), dtype=torch.bool, device=dev)
    slot_tid = torch.empty((Pq, K), dtype=torch.int64, device=dev)
    f = _build.bind("scan_window", "probe_partitioned", _PART_ARGS)
    _build.launch("scan_window.partitioned", f, *seg, *ops_in, K,
                  consume_ok.data_ptr(), slot_tid.data_ptr(),
                  _build.stream_ptr(dev))
    return consume_ok, slot_tid


# ---------------------------------------------------------------------------
# the probe, single-master: one round's index ops + SCAN_L window
# ---------------------------------------------------------------------------
def locate_index_ops(index, kinds, delta, n_rows):
    """Resolve one round's index/scan ops against the current index state.

    kinds: (B, K) int32; delta: (B, K, C).  Returns per-op claim addresses,
    scan-window addresses/validity, gathered TIDs and consume validation,
    all in the flat row+index address space [0, n_rows + S) with
    ``no_addr`` = the dump slot (see repro's ``locate_index_ops_ref``)."""
    B, K = kinds.shape
    dev = kinds.device
    kernel_launch("scan_window.single_master", backend=dev.type,
                  queries=B * K)
    if dev.type == "cpu":
        return locate_index_ops_plain(index, kinds, delta, n_rows)
    seg = _segments(index, dev)
    no_addr = n_rows + seg[4] * sum(seg[2])
    ops_in = _ops_in(kinds, delta, B, K, dev)
    L1 = SCAN_L + 1
    out = {"claim_addr": torch.empty((B, K), dtype=torch.int32, device=dev),
           "claim_tid": torch.empty((B, K), dtype=torch.int64, device=dev),
           "scan_addr": torch.empty((B, K, L1), dtype=torch.int32,
                                    device=dev),
           "scan_tid": torch.empty((B, K, L1), dtype=torch.int64,
                                   device=dev),
           "scan_valid": torch.empty((B, K, L1), dtype=torch.bool,
                                     device=dev),
           "consume_ok": torch.empty((B, K), dtype=torch.bool, device=dev)}
    f = _build.bind("scan_window", "probe_single_master", _SM_ARGS)
    _build.launch("scan_window.single_master", f, *seg, *ops_in, B, K,
                  n_rows, no_addr, L1, *[t.data_ptr() for t in out.values()],
                  _build.stream_ptr(dev))
    out["no_addr"] = no_addr
    return out


# ---------------------------------------------------------------------------
# one OCC round (single-master): claim -> validate + TID -> install
# ---------------------------------------------------------------------------
def lock_arrays(n_lock: int, B: int, deterministic: bool, device):
    """The lock arrays one ``run_single_master`` call hands to every
    round: (lock, rlock or None), (n_lock,) int32 filled with the sentinel
    lane ``B``; rlock (Calvin's read locks) only if ``deterministic``."""
    def one():
        return torch.full((n_lock,), B, dtype=torch.int32, device=device)
    return one(), (one() if deterministic else None)


def occ_round(val, tidw, rows, kind, delta_v, wmask, amask, active, epoch,
              last_tid, ix=None, has_claim=None, deterministic=False,
              lock=None, rlock=None):
    """One OCC round: gather → lock → validate → TID → install, the
    function of the reference's ``occ_round_ref``.  ``val`` (N, C) int32
    and ``tidw`` (N,) int64 are updated in place.

    ``lock`` (and, with ``deterministic``, ``rlock``) are (NT+1,) int32
    arrays every entry of which is the sentinel lane B (:func:`lock_arrays`;
    NT = ``ix["no_addr"]``, or N without an index); the round leaves them
    so.  Without ``lock`` the round builds fresh arrays.  Returns
    (val, tidw, commit_now, new_tid, new, w)."""
    N, C = val.shape
    B, M = rows.shape
    dev = val.device
    NT = N if ix is None else int(ix["no_addr"])
    kernel_launch("occ_round", backend=dev.type, lanes=B)
    if lock is None:
        lock, rlock = lock_arrays(NT + 1, B, deterministic, dev)
    elif deterministic and rlock is None:
        raise ValueError("a Calvin round needs the read-lock array rlock")
    rlock = rlock if deterministic else None
    if dev.type == "cpu":
        out = occ_round_plain(val, tidw, rows, kind, delta_v, wmask, amask,
                              active, epoch, last_tid, lock, rlock, ix=ix,
                              has_claim=has_claim)
        return (val, tidw, *out)
    chk = _build.checked
    ins = [chk("val", val, torch.int32, (N, C), dev),
           chk("tidw", tidw, torch.int64, (N,), dev),
           chk("rows", rows, torch.int32, (B, M), dev),
           chk("kind", kind, torch.int32, (B, M), dev),
           chk("delta", delta_v, torch.int32, (B, M, C), dev),
           chk("wmask", wmask, torch.bool, (B, M), dev),
           chk("amask", amask, torch.bool, (B, M), dev),
           chk("active", active, torch.bool, (B,), dev),
           chk("last_tid", last_tid, torch.int64, (B,), dev)]
    K = L = 0
    if ix is not None:
        K, L = ix["scan_addr"].shape[1], ix["scan_addr"].shape[2]
        ins += [chk("claim_addr", ix["claim_addr"], torch.int32, (B, K), dev),
                chk("claim_tid", ix["claim_tid"], torch.int64, (B, K), dev),
                chk("scan_addr", ix["scan_addr"], torch.int32, (B, K, L),
                    dev),
                chk("scan_tid", ix["scan_tid"], torch.int64, (B, K, L), dev),
                chk("scan_valid", ix["scan_valid"], torch.bool, (B, K, L),
                    dev),
                chk("has_claim", has_claim, torch.bool, (B, K), dev)]
    else:
        ins += [None] * 6
    ins += [chk("lock", lock, torch.int32, (NT + 1,), dev),
            None if rlock is None
            else chk("rlock", rlock, torch.int32, (NT + 1,), dev)]
    commit = torch.empty((B,), dtype=torch.bool, device=dev)
    new_tid = torch.empty((B,), dtype=torch.int64, device=dev)
    new = torch.empty((B, M, C), dtype=torch.int32, device=dev)
    w = torch.empty((B, M), dtype=torch.bool, device=dev)
    f = _build.bind("occ_round", "occ_round", _ROUND_ARGS)
    _build.launch("occ_round", f,
                  *[None if t is None else t.data_ptr() for t in ins],
                  commit.data_ptr(), new_tid.data_ptr(), new.data_ptr(),
                  w.data_ptr(), B, M, C, K, L, int(epoch) & 0xFFFFFFFF,
                  _build.stream_ptr(dev))
    return val, tidw, commit, new_tid, new, w
