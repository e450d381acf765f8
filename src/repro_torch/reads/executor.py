"""Snapshot read executor: point-read gathers and index probes over one
retained replica snapshot.  Port of ``repro.reads.executor``.

Read-only transactions carry only READ point ops and SCAN_READ index
probes (their first ``IDX_OPS`` op slots), so serving a batch needs no
locks, no validation rounds, and no scatter — a gather of ``val/tid`` plus
the probes over the chosen replica's committed index segments.  ``arow``
maps each transaction's home partition to the ARRAY ROW of that partition
in the replica's physical layout (identity for the full copy), so the
same program serves every replica.

The probes of one index are ONE ``scan_window`` launch (the bare
configuration, ``kernels.occ.ops.scan_window``) over the index's key
table read in place: one query per (transaction, op slot) that scans that
index, each in its own segment (``arow * cap``).  Which slots scan which
index is known on the host (the op arrays come from the request pool), so
only those slots are queried; the reference probes every slot for every
index and masks, which gives the same result.  The window's TIDs come out
of the kernel; ``prow`` and the pointed rows are gathered after it.

On the card the program runs on a stream of the executor's own that waits
only on the snapshot's ``ready`` event (recorded after the catalog's copy
at the fence), so a read served during the partitioned phase does not
queue behind the epoch's work; ``run`` returns once that stream's work is
done.  On the CPU the same code runs the plain ``scan_window``.

Results are raw committed state — the caller (:class:`ReadTier`) tags
them with the snapshot epoch they were drained against.
``reference_read`` is the numpy oracle the staleness property tests
compare against, bit-for-bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ops import IDX_OPS, IX_HI, IX_ID, IX_LO, SCAN_READ
from repro_torch.kernels.occ.ops import scan_window
from repro_torch.storage.index import SCAN_L, SENTINEL


def _read_program(snap, arow, rows, kinds, deltas):
    """snap {'val' (P,R,C), 'tid' (P,R), 'idx' [{key,prow,tid} (P,cap_i)]}
    on one device; arow (B,), rows/kinds (B,M), deltas (B,M,C) host numpy.
    Returns the read payload dict of tensors on the snapshot's device.
    The host arrays reach the device in two copies: one int64 buffer of
    rows and scatter positions, one int32 buffer of probe arguments."""
    val, tid = snap["val"], snap["tid"]
    idx = snap.get("idx") or []
    dev = val.device
    B, M = rows.shape
    K = min(IDX_OPS, M)
    L = SCAN_L
    is_scan = kinds[:, :K] == SCAN_READ              # (B, K) host
    # per index: the (b, k) slots that scan it, and their queries
    probes = []
    if idx:
        lo = deltas[:, :K, IX_LO]
        hi = deltas[:, :K, IX_HI]
        iid = deltas[:, :K, IX_ID]
        for i, ix in enumerate(idx):
            b, k = np.nonzero(is_scan & (iid == i))
            if b.size:
                probes.append((i, ix["key"].shape[1], b, k))
    h64 = np.concatenate([arow, rows.reshape(-1)]
                         + [np.concatenate([b, k]) for _, _, b, k in probes])
    h32 = np.concatenate([np.concatenate([lo[b, k], hi[b, k],
                                          arow[b] * cap,
                                          np.full(b.size, cap)])
                          for _, cap, b, k in probes] or [np.zeros(0)])
    d64 = torch.as_tensor(h64, device=dev)
    d32 = torch.as_tensor(h32.astype(np.int32), device=dev)
    a_t = d64[:B]
    r_t = d64[B:B + B * M].view(B, M)
    out = {"val": val[a_t[:, None], r_t], "tid": tid[a_t[:, None], r_t]}
    if not idx:
        return out
    scan_key = torch.full((B, K, L), SENTINEL, dtype=torch.int32, device=dev)
    scan_prow = torch.zeros((B, K, L), dtype=torch.int32, device=dev)
    scan_tid = torch.zeros((B, K, L), dtype=torch.int64, device=dev)
    scan_live = torch.zeros((B, K, L), dtype=torch.bool, device=dev)
    span = torch.arange(L + 1, device=dev)
    o64, o32 = B + B * M, 0
    for i, cap, b, k in probes:
        Q = b.size
        bk = d64[o64:o64 + 2 * Q].view(2, Q)
        q = d32[o32:o32 + 4 * Q].view(4, Q)          # lo, hi, base, cap
        o64, o32 = o64 + 2 * Q, o32 + 4 * Q
        ix = idx[i]
        pos0, keys_w, tids_w = scan_window(
            ix["key"].reshape(-1), ix["tid"].reshape(-1), q[0], q[2], q[3],
            n_slots=L + 1, max_cap=cap)
        raw = pos0.long()[:, None] + span            # (Q, L+1)
        slots = raw.clamp(0, cap - 1)
        in_r = (raw < cap) & (keys_w >= q[0][:, None]) \
            & (keys_w < q[1][:, None]) & (keys_w != SENTINEL)
        prow = ix["prow"].reshape(-1)[q[2].long()[:, None] + slots]
        at = (bk[0], bk[1])
        scan_key[at] = keys_w[:, :L]
        scan_prow[at] = prow[:, :L]
        scan_tid[at] = tids_w[:, :L]
        scan_live[at] = in_r[:, :L]
    # the scanned window joins the read result: gather the pointed rows
    prow_safe = scan_prow.long().clamp(0, val.shape[1] - 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out.update({
        "scan_key": torch.where(scan_live, scan_key, SENTINEL),
        "scan_prow": torch.where(scan_live, scan_prow, zero),
        "scan_tid": torch.where(scan_live, scan_tid, 0),
        "scan_live": scan_live,
        "scan_val": torch.where(scan_live[..., None],
                                val[a_t[:, None, None], prow_safe], zero),
    })
    return out


class SnapshotReadExecutor:
    """Runs :func:`_read_program` on a snapshot's device.  The reference
    pads each batch to a power of two to bound its jit recompiles; every
    lane here is computed on its own, so padding changes no result and is
    left out."""

    def __init__(self):
        self._streams: dict = {}

    def _stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def run(self, snap: dict, arow, rows, kinds, deltas) -> dict:
        arow = np.asarray(arow, np.int64)
        rows = np.asarray(rows, np.int64)
        kinds = np.asarray(kinds, np.int32)
        deltas = np.asarray(deltas, np.int64)
        dev = snap["val"].device
        if dev.type != "cuda":
            return _read_program(snap, arow, rows, kinds, deltas)
        stream = self._stream(dev)
        ready = snap.get("ready")
        if ready is not None:
            stream.wait_event(ready)
        with torch.cuda.stream(stream):
            out = _read_program(snap, arow, rows, kinds, deltas)
            done = torch.cuda.Event()
            done.record(stream)
        # the outputs were made on the read stream and the snapshot read
        # there: both are settled once this returns, so the caching
        # allocator may hand their memory to any stream afterwards
        done.synchronize()
        return out


def reference_read(snap: dict, arow, rows, kinds, deltas) -> dict:
    """Numpy oracle mirroring `_read_program` bit-for-bit (tests only)."""
    val = np.asarray(snap["val"])
    tid = np.asarray(snap["tid"])
    idx = snap.get("idx") or []
    arow = np.asarray(arow, np.int64)
    rows = np.asarray(rows, np.int64)
    kinds = np.asarray(kinds)
    deltas = np.asarray(deltas)
    B, M = rows.shape
    out = {"val": val[arow[:, None], rows], "tid": tid[arow[:, None], rows]}
    if not idx:
        return out
    K, L = min(IDX_OPS, M), SCAN_L
    scan_key = np.full((B, K, L), SENTINEL, np.int32)
    scan_prow = np.zeros((B, K, L), np.int32)
    scan_tid = np.zeros((B, K, L), np.uint32)
    scan_live = np.zeros((B, K, L), bool)
    scan_val = np.zeros((B, K, L, val.shape[2]), np.int32)
    for b in range(B):
        for k in range(K):
            if kinds[b, k] != SCAN_READ:
                continue
            i = int(deltas[b, k, IX_ID])
            lo, hi = int(deltas[b, k, IX_LO]), int(deltas[b, k, IX_HI])
            seg = np.asarray(idx[i]["key"][arow[b]])
            cap = seg.shape[0]
            pos0 = int(np.searchsorted(seg, lo))
            for j in range(L):
                raw = pos0 + j
                s = min(max(raw, 0), cap - 1)
                key = int(seg[s])
                live = raw < cap and lo <= key < hi and key != SENTINEL
                if live:
                    scan_key[b, k, j] = key
                    scan_prow[b, k, j] = np.asarray(idx[i]["prow"][arow[b]])[s]
                    scan_tid[b, k, j] = np.asarray(idx[i]["tid"][arow[b]])[s]
                    scan_live[b, k, j] = True
                    scan_val[b, k, j] = val[arow[b], scan_prow[b, k, j]]
    out.update({"scan_key": scan_key, "scan_prow": scan_prow,
                "scan_tid": scan_tid, "scan_live": scan_live,
                "scan_val": scan_val})
    return out
