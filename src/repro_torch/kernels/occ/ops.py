"""Dispatch for the OCC kernels, port of ``repro.kernels.occ.ops``.

``scan_window`` and ``occ_round`` launch the CUDA kernels of
``csrc/scan_window.cu`` and ``csrc/occ_round.cu`` for CUDA tensors and run
their plain versions (``ref.py``) for CPU tensors.  ``locate_index_ops``
(single-master phase) and ``step_index_ops`` (partitioned phase) build the
per-op segment arguments of the probe around ``scan_window``, as the JAX
package's fused path does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.ops import (IX_EXPECT, IX_HI, IX_ID, IX_LO,
                                  SCAN_CONSUME, is_index_kind, reads_index,
                                  writes_index)
from repro_torch.kernels import _build
from repro_torch.kernels.occ.ref import (install_plain, lock_build_plain,
                                         scan_window_plain, validate_plain)
from repro_torch.obs.trace import kernel_launch
from repro_torch.storage.index import SCAN_L, SENTINEL, key_partition

VP = ctypes.c_void_p
I32 = ctypes.c_int
_SCAN_ARGS = [VP] * 5 + [I32] * 3 + [VP] * 4
_LOCK_ARGS = [VP, VP, I32, VP, ctypes.c_longlong, I32, VP]
_VALIDATE_ARGS = [VP] * 21 + [I32] * 5 + [ctypes.c_uint, VP]
_INSTALL_ARGS = [VP] * 6 + [I32] * 3 + [VP]


# ---------------------------------------------------------------------------
# scan_window: lower-bound search + bounded window gather
# ---------------------------------------------------------------------------
def scan_window(flat_key, flat_tid, q, seg_base, seg_cap, *, n_slots: int,
                n_iters: int):
    """flat_key (S,) int32 / flat_tid (S,) int64 concatenated sorted
    segments; q/seg_base/seg_cap (Q,) int32 per-query key, segment start
    and length.  Returns (pos0 (Q,) int32, keys (Q, n_slots) int32,
    tids (Q, n_slots) int64)."""
    kernel_launch("scan_window", backend=flat_key.device.type,
                  queries=int(q.shape[0]))
    if flat_key.device.type == "cpu":
        return scan_window_plain(flat_key, flat_tid, q, seg_base, seg_cap,
                                 n_slots=n_slots, n_iters=n_iters)
    dev = flat_key.device
    S, Q = flat_key.shape[0], q.shape[0]
    q, seg_base, seg_cap = (q.contiguous(), seg_base.contiguous(),
                            seg_cap.contiguous())
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
                  n_slots, n_iters, pos.data_ptr(), keys.data_ptr(),
                  tids.data_ptr(), _build.stream_ptr(dev))
    return pos, keys, tids


def _flat_segments(index):
    """Static layout of the concatenated index segments: per-index flat
    offsets, caps, total slots, and the search-iteration bound."""
    P = index[0]["key"].shape[0]
    caps = [idx["key"].shape[1] for idx in index]
    offs = np.cumsum([0] + [P * c for c in caps])
    n_iters = int(max(caps)).bit_length() + 1
    return P, caps, [int(o) for o in offs], int(offs[-1]), n_iters


def _seg_select(caps, offs, sel, iid, part):
    """Per-op segment base/length in the concatenated key space.  Ops not
    matching any index resolve against segment 0 and are masked out by the
    caller."""
    seg_base = torch.zeros(iid.shape, dtype=torch.int32, device=iid.device)
    seg_cap = torch.full(iid.shape, caps[0], dtype=torch.int32,
                         device=iid.device)
    for i, c in enumerate(caps):
        mine = sel & (iid == i)
        seg_base = torch.where(mine, offs[i] + part * c, seg_base)
        seg_cap = torch.where(mine, c, seg_cap)
    return seg_base.to(torch.int32), seg_cap


def _flat_index(index):
    return (torch.cat([ix["key"].reshape(-1) for ix in index]),
            torch.cat([ix["tid"].reshape(-1) for ix in index]))


def _clip(x, hi):
    """jnp.clip(x, 0, hi) with a tensor upper bound."""
    return torch.minimum(x.clamp(min=0), hi)


# ---------------------------------------------------------------------------
# index-op location (single-master): probe + SCAN_L window
# ---------------------------------------------------------------------------
def locate_index_ops(index, kinds, delta, n_rows):
    """Resolve one round's index/scan ops against the current index state.

    kinds: (B, K) int32; delta: (B, K, C).  Returns per-op claim addresses,
    scan-window addresses/validity, gathered TIDs and consume validation,
    all in the flat row+index address space [0, n_rows + S) with
    ``no_addr`` = the dump slot (see repro's ``locate_index_ops_ref``)."""
    B, K = kinds.shape
    P, caps, offs, S, n_iters = _flat_segments(index)
    no_addr = n_rows + S
    dev = kinds.device

    lo = delta[..., IX_LO]                                     # (B, K)
    hi = delta[..., IX_HI]
    iid = delta[..., IX_ID]
    p_of = key_partition(lo).clamp(0, P - 1)
    sel = is_index_kind(kinds) & (iid >= 0) & (iid < len(index))
    seg_base, seg_cap = _seg_select(caps, offs, sel, iid, p_of)

    flat_key, flat_tid = _flat_index(index)
    pos0, keys_at, tids_at = scan_window(
        flat_key, flat_tid, lo.reshape(-1), seg_base.reshape(-1),
        seg_cap.reshape(-1), n_slots=SCAN_L + 1, n_iters=n_iters)
    pos0 = pos0.reshape(B, K)
    keys_at = keys_at.reshape(B, K, SCAN_L + 1)
    tids_at = tids_at.reshape(B, K, SCAN_L + 1)

    window = pos0[..., None] + torch.arange(SCAN_L + 1, dtype=torch.int32,
                                            device=dev)
    slots = _clip(window, seg_cap[..., None] - 1)
    cmask = sel & writes_index(kinds)
    claim_addr = torch.where(cmask, n_rows + seg_base
                             + _clip(pos0, seg_cap - 1),
                             no_addr).to(torch.int32)
    claim_tid = torch.where(cmask, tids_at[..., 0], 0)
    smask = sel & reads_index(kinds)
    in_or_boundary = torch.cat(
        [torch.ones((B, K, 1), dtype=torch.bool, device=dev),
         keys_at[..., :-1] < hi[..., None]], dim=-1) \
        & (window < seg_cap[..., None])
    sv = smask[..., None] & in_or_boundary
    scan_addr = torch.where(sv, n_rows + seg_base[..., None] + slots,
                            no_addr).to(torch.int32)
    scan_tid = torch.where(sv, tids_at, 0)
    first_key = torch.where(sel, keys_at[..., 0], SENTINEL)
    consume_ok = (first_key == delta[..., IX_EXPECT]) & (first_key < hi) \
        & (first_key != SENTINEL)
    return {"claim_addr": claim_addr, "claim_tid": claim_tid,
            "scan_addr": scan_addr, "scan_tid": scan_tid,
            "scan_valid": sv, "consume_ok": consume_ok, "no_addr": no_addr}


# ---------------------------------------------------------------------------
# one OCC round (single-master): lock build -> validate -> install
# ---------------------------------------------------------------------------
def occ_round(val, tidw, rows, kind, delta_v, wmask, amask, active, epoch,
              last_tid, ix=None, has_claim=None, deterministic=False):
    """One OCC round: gather → lock → validate → TID → install, the
    function of the reference's ``occ_round_ref``.  ``val`` (N, C) int32
    and ``tidw`` (N,) int64 are updated in place.  Returns
    (val, tidw, commit_now, new_tid, new, w)."""
    N = val.shape[0]
    B = rows.shape[0]
    NT = N if ix is None else int(ix["no_addr"])
    lanes = torch.arange(B, dtype=torch.int32, device=val.device)[:, None]

    def claims(pairs):
        """(addr, lane) claim streams; masked claims -> (NT, B)."""
        addr = torch.cat([torch.where(m, a, NT).reshape(-1)
                          for a, m, _ in pairs]).to(torch.int32)
        lane = torch.cat([torch.where(m, ln, B).reshape(-1)
                          for _, m, ln in pairs]).to(torch.int32)
        return addr, lane

    wpairs = [(rows, wmask, lanes)]
    if ix is not None:
        wpairs.append((ix["claim_addr"], has_claim, lanes))
    lock = lock_build(*claims(wpairs), NT=NT, B=B)
    rlock = None
    if deterministic:
        # Calvin: every access, reads included, claims its address
        rpairs = [(rows, amask, lanes)]
        if ix is not None:
            rpairs += [(ix["scan_addr"], ix["scan_valid"]
                        & active[:, None, None], lanes[..., None]),
                       (ix["claim_addr"], has_claim, lanes)]
        rlock = lock_build(*claims(rpairs), NT=NT, B=B)
    commit, new_tid, new, w = occ_validate(
        val, tidw, lock, rlock, rows, kind, delta_v, wmask, amask, active,
        last_tid, epoch, ix=ix, has_claim=has_claim)
    occ_install(val, tidw, rows, new, w, new_tid)
    return val, tidw, commit, new_tid, new, w


def lock_build(addr, lane, *, NT: int, B: int):
    """Launch 1 of the round: lock (NT+1,) int32 = B everywhere, then the
    scatter-min of ``lane`` over ``addr`` (claims with lane B are inert)."""
    dev = addr.device
    kernel_launch("occ_round.lock_build", backend=dev.type,
                  claims=int(addr.shape[0]))
    if dev.type == "cpu":
        return lock_build_plain(addr, lane, NT=NT, B=B)
    Kc = addr.shape[0]
    _build.checked("addr", addr, torch.int32, (Kc,), dev)
    _build.checked("lane", lane, torch.int32, (Kc,), dev)
    lock = torch.empty((NT + 1,), dtype=torch.int32, device=dev)
    f = _build.bind("occ_round", "occ_lock_build", _LOCK_ARGS)
    _build.launch("occ_round.lock_build", f, addr.data_ptr(),
                  lane.data_ptr(), Kc, lock.data_ptr(), NT + 1, B,
                  _build.stream_ptr(dev))
    return lock


def occ_validate(val, tidw, lock, rlock, rows, kind, delta_v, wmask, amask,
                 active, last_tid, epoch, ix=None, has_claim=None):
    """Launch 2 of the round: per-lane validate + TID (Calvin's rule when
    ``rlock`` is given).  Returns (commit (B,) bool, new_tid (B,) int64,
    new (B, M, C) int32, w (B, M) bool)."""
    dev = val.device
    kernel_launch("occ_round.validate", backend=dev.type,
                  lanes=int(rows.shape[0]))
    if dev.type == "cpu":
        return validate_plain(val, tidw, lock, rlock, rows, kind, delta_v,
                              wmask, amask, active, last_tid, epoch, ix=ix,
                              has_claim=has_claim)
    N, C = val.shape
    B, M = rows.shape
    NT1 = lock.shape[0]
    chk = _build.checked
    ins = [chk("val", val, torch.int32, (N, C), dev),
           chk("tidw", tidw, torch.int64, (N,), dev),
           chk("lock", lock, torch.int32, (NT1,), dev),
           None if rlock is None
           else chk("rlock", rlock, torch.int32, (NT1,), dev),
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
    commit = torch.empty((B,), dtype=torch.bool, device=dev)
    new_tid = torch.empty((B,), dtype=torch.int64, device=dev)
    new = torch.empty((B, M, C), dtype=torch.int32, device=dev)
    w = torch.empty((B, M), dtype=torch.bool, device=dev)
    f = _build.bind("occ_round", "occ_validate", _VALIDATE_ARGS)
    _build.launch("occ_round.validate", f,
                  *[None if t is None else t.data_ptr() for t in ins],
                  commit.data_ptr(), new_tid.data_ptr(), new.data_ptr(),
                  w.data_ptr(), B, M, C, K, L, int(epoch) & 0xFFFFFFFF,
                  _build.stream_ptr(dev))
    return commit, new_tid, new, w


def occ_install(val, tidw, rows, new, w, new_tid):
    """Launch 3 of the round: winners' post-images and TIDs into val/tidw
    in place (winner rows are unique)."""
    dev = val.device
    kernel_launch("occ_round.install", backend=dev.type,
                  lanes=int(rows.shape[0]))
    if dev.type == "cpu":
        return install_plain(val, tidw, rows, new, w, new_tid)
    N, C = val.shape
    B, M = rows.shape
    chk = _build.checked
    ins = [chk("val", val, torch.int32, (N, C), dev),
           chk("tidw", tidw, torch.int64, (N,), dev),
           chk("rows", rows, torch.int32, (B, M), dev),
           chk("new", new, torch.int32, (B, M, C), dev),
           chk("w", w, torch.bool, (B, M), dev),
           chk("new_tid", new_tid, torch.int64, (B,), dev)]
    f = _build.bind("occ_round", "occ_install", _INSTALL_ARGS)
    _build.launch("occ_round.install", f, *[t.data_ptr() for t in ins],
                  B, M, C, _build.stream_ptr(dev))


# ---------------------------------------------------------------------------
# per-queue-slot consume validation (partitioned)
# ---------------------------------------------------------------------------
def step_index_ops(index, kinds, delta):
    """Resolve one partitioned queue slot's index ops: (consume_ok (P, K),
    slot_tid (P, K)).  Each partition probes its OWN segment."""
    Pq, K = kinds.shape
    P, caps, offs, S, n_iters = _flat_segments(index)
    lo = delta[..., IX_LO]
    hi = delta[..., IX_HI]
    iid = delta[..., IX_ID]
    part = torch.arange(Pq, dtype=torch.int32,
                        device=kinds.device)[:, None].expand(Pq, K)
    sel = (iid >= 0) & (iid < len(index))
    seg_base, seg_cap = _seg_select(caps, offs, sel, iid, part)
    flat_key, flat_tid = _flat_index(index)
    pos0, keys_at, tids_at = scan_window(
        flat_key, flat_tid, lo.reshape(-1), seg_base.reshape(-1),
        seg_cap.reshape(-1), n_slots=1, n_iters=n_iters)
    first_key = keys_at.reshape(Pq, K)
    t_at = tids_at.reshape(Pq, K)
    ok = (first_key == delta[..., IX_EXPECT]) & (first_key < hi) \
        & (first_key != SENTINEL)
    consume_ok = torch.where(sel & (kinds == SCAN_CONSUME), ok, True)
    slot_tid = torch.where(sel, t_at, 0)
    return consume_ok, slot_tid
