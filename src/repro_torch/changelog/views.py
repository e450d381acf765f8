"""Incrementally-maintained columnar materialized views over the ChangeLog,
port of ``repro.changelog.views``.

The analytics subscriber: a columnar projection of the TPC-C store (the
value columns the decision-support aggregates here read — ``VIEW_COLS``)
maintained incrementally from the SAME ordered op stream the replicas
replay, slab by slab, on the device that holds the projection.

Correctness rests on the stream's existing guarantees, not new ones:

* partitioned slabs scatter the log's POST-IMAGE values by the rule
  ``replay_partitioned`` commits with: of the writes to one row, the last
  in (queue slot, op) order wins (``core.partitioned.last_writes`` within
  a slot, later slots over earlier ones), duplicate stock rows of one
  NewOrder included.  The post-images are in the log, so no op is
  re-applied and the whole slab is one scatter of its last writes;
* the single-master stream merges under the Thomas write rule: one
  ``thomas_merge`` launch (``core.replication.thomas_apply``) on the
  (P·R, 3) projection, reading the log's rows in place (row −1 where a
  write did not commit) — identical TID comparisons pick identical
  winners, so the projected columns equal the replica's.

At every commit fence the working projection is COPIED into the committed
one (the port updates the working projection in place, so an alias would
take every later write) and the CH-benCHmark-style aggregates are
computed from it on the device in int64, moved to the host and STAMPED
``(epoch, aggregates)`` into a bounded history — queryable between fences
(``latest``), with fence-granular time-travel to any retained epoch
(``time_travel``).  ``recompute`` is the from-scratch host numpy oracle
over a full committed (P, R, C) value array.  A §4.5 revert copies the
committed projection back into the working one; a disk reload rebuilds
both via ``on_reset``.

Aggregates (per partition == per warehouse):

* ``revenue``   (P, N_DIST) int64 — Σ order-line amounts per district
  over the retained order ring;
* ``stock_low`` (P,)        int32 — stock rows with quantity below the
  threshold (StockLevel's decision-support cousin);
* ``undelivered`` (P, N_DIST) int32 — NEW-ORDER ring slots not yet
  tombstoned by Delivery (o_id column != 0);
* ``order_latency`` (P, N_DIST, len(LATENCY_BUCKETS)+1) int32 — per-
  district histogram of NewOrder→Delivery latency (in order-ids) over the
  delivered orders retained in the ring: cumulative counts per bucket
  edge plus a trailing total column.

All four read the retained ring state — reused ring slots overwrite in
place, so "revenue" is revenue over the ring window, exactly what the
oracle recomputes.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.core.replication import thomas_apply
from repro_torch.db.tpcc import N_DIST

#: value columns the views project: col 0 (next_o_id / s_qty / o_id ...),
#: col 2 (order-line amount / d_ytd ...) and col 5 (order latency in
#: order-ids, stamped by Delivery on the orders row)
VIEW_COLS = (0, 2, 5)

#: order-latency histogram bucket edges (latency in order-ids, i.e. how
#: far next_o_id advanced past an order before Delivery consumed it);
#: cumulative counts per edge + a trailing total ("+inf") column
LATENCY_BUCKETS = (1, 2, 4, 8, 16, 32)

_AGG_DTYPES = {"revenue": np.int64, "stock_low": np.int32,
               "undelivered": np.int32, "order_latency": np.int32}


def _slices(cfg, P):
    """The four ring/table column slices of a (P, R, len(VIEW_COLS))
    projection the aggregates read (numpy or torch alike)."""
    ring = cfg.order_ring
    return (
        lambda x: x[:, cfg.off_order_line:
                    cfg.off_order_line + N_DIST * ring * 15, 1],
        lambda x: x[:, cfg.off_stock:cfg.off_stock + cfg.n_items, 0],
        lambda x: x[:, cfg.off_new_order:
                    cfg.off_new_order + N_DIST * ring, 0],
        lambda x: x[:, cfg.off_orders:cfg.off_orders + N_DIST * ring,
                    2].reshape(P, N_DIST, ring))


class MaterializedViews:
    """ChangeLog subscriber maintaining columnar TPC-C aggregates."""

    def __init__(self, cfg, stock_threshold: int = 15, retain: int = 8):
        self.cfg = cfg
        self.stock_threshold = int(stock_threshold)
        self.retain = int(retain)
        self.proj = None               # (P, R, len(VIEW_COLS)) projection
        self.ptid = None               # (P, R) working TIDs
        self._c_proj = None            # committed projection (own buffer)
        self._c_ptid = None
        self._stamps: deque = deque()  # (epoch, {name: np.ndarray})
        # maintenance counters (analytics bench / summary surface)
        self.slabs_applied = 0
        self.writes_applied = 0
        self.master_merges = 0
        self.commits = 0
        self.reverts = 0

    # -- stream application ---------------------------------------------
    def on_slab(self, log, info):
        """Scatter one slab's post-image column projection: each row takes
        the post-image of its last write in (queue slot, op) order — the
        result of ``replay_partitioned``'s per-slot pad-row scatters, with
        every write index unique."""
        if self.proj is None:
            return
        P, R, Cp = self.proj.shape
        dev = self.proj.device
        row, write = log["row"].to(dev), log["write"].to(dev)   # (P, T, M)
        T, M = row.shape[1], row.shape[2]
        flat = (torch.arange(P, device=dev) * R)[:, None, None] + row
        flat = torch.where(write, flat, P * R).reshape(-1)
        order = torch.arange(T * M, device=dev).expand(P, T * M).reshape(-1)
        last = torch.full((P * R + 1,), -1, dtype=torch.int64, device=dev
                          ).scatter_reduce(0, flat, order, "amax")
        win = (order == last[flat]) & (flat < P * R)
        cols = list(VIEW_COLS)
        vals = log["val"].to(dev)[..., cols].reshape(-1, Cp)
        tids = log["tid"].to(dev).reshape(-1)
        at = flat[win]
        self.proj.view(P * R, Cp)[at] = vals[win]
        self.ptid.view(P * R)[at] = tids[win]
        self.slabs_applied += 1
        self.writes_applied += int(write.sum())

    def on_master(self, stream):
        """Thomas-merge the single-master stream's projected post-images
        on the flat row space: one ``thomas_merge`` launch at C = 3."""
        if self.proj is None or stream["log"] is None:
            return
        P, R, Cp = self.proj.shape
        dev = self.proj.device
        lg = stream["log"]
        C = lg["val"].shape[-1]
        rows = lg["row"].to(dev).reshape(-1)     # -1 where not committed
        vals = lg["val"].to(dev).reshape(-1, C)[:, list(VIEW_COLS)]
        tids = lg["tid"].to(dev).reshape(-1)
        thomas_apply(self.proj.view(P * R, Cp), self.ptid.view(P * R),
                     rows.contiguous(), vals, tids.contiguous())
        self.master_merges += 1
        self.writes_applied += int(lg["write"].sum())

    # -- fences ----------------------------------------------------------
    def on_commit(self, epoch, record):
        if self.proj is None:
            return
        self._c_proj.copy_(self.proj)
        self._c_ptid.copy_(self.ptid)
        self.commits += 1
        self._stamp(epoch)

    def on_revert(self, epoch, n_slabs):
        if self._c_proj is None:
            return
        self.proj.copy_(self._c_proj)
        self.ptid.copy_(self._c_ptid)
        self.reverts += 1

    def on_reset(self, val, tid, epoch):
        """Disk reload (§4.5.1), or the first attach: rebuild the
        projection, on the arrays' device, from the committed arrays
        (copies: the caller's arrays may be overwritten later) and stamp
        that fence."""
        val = torch.as_tensor(val)
        self.proj = torch.stack([val[..., c] for c in VIEW_COLS], dim=-1)
        self.ptid = torch.as_tensor(tid, device=self.proj.device).clone()
        self._c_proj = self.proj.clone()
        self._c_ptid = self.ptid.clone()
        self._stamp(epoch)

    def _stamp(self, epoch):
        epoch = int(epoch)
        if self._stamps and self._stamps[-1][0] == epoch:
            return                                   # idempotent per fence
        self._stamps.append((epoch, self._aggregates(self._c_proj)))
        while len(self._stamps) > self.retain:
            self._stamps.popleft()

    # -- aggregates ------------------------------------------------------
    def _aggregates(self, proj) -> dict:
        """The aggregates of a (P, R, len(VIEW_COLS)) projection tensor,
        computed on its device in int64 (sums and counts are exact) and
        moved to the host in one copy, with the oracle's dtypes."""
        P = proj.shape[0]
        ol, st, no, lat = (f(proj) for f in _slices(self.cfg, P))
        live = lat > 0
        aggs = {
            "revenue": ol.long().reshape(P, N_DIST, -1).sum(-1),
            "stock_low": (st < self.stock_threshold).sum(-1),
            "undelivered": (no.reshape(P, N_DIST, -1) != 0).sum(-1),
            "order_latency": torch.stack(
                [(live & (lat <= b)).sum(-1) for b in LATENCY_BUCKETS]
                + [live.sum(-1)], dim=-1),
        }
        flat = torch.cat([a.reshape(-1) for a in aggs.values()]).cpu()
        out, o = {}, 0
        for k, a in aggs.items():
            out[k] = flat[o:o + a.numel()].numpy().reshape(
                tuple(a.shape)).astype(_AGG_DTYPES[k])
            o += a.numel()
        return out

    def _aggregates_np(self, proj) -> dict:
        """The reference's host numpy aggregates (the oracle's path)."""
        P = proj.shape[0]
        ol, st, no, lat = (f(proj) for f in _slices(self.cfg, P))
        live = lat > 0
        return {
            "revenue": ol.astype(np.int64).reshape(
                P, N_DIST, -1).sum(axis=-1),
            "stock_low": (st < self.stock_threshold).sum(
                axis=-1).astype(np.int32),
            "undelivered": (no.reshape(P, N_DIST, -1) != 0).sum(
                axis=-1).astype(np.int32),
            "order_latency": np.stack(
                [(live & (lat <= b)).sum(axis=-1)
                 for b in LATENCY_BUCKETS] + [live.sum(axis=-1)],
                axis=-1).astype(np.int32),
        }

    def recompute(self, val) -> dict:
        """From-scratch oracle: the same aggregates off a full committed
        (P, R, C) value array, in host numpy — what every stamped fence
        must bit-equal (integer sums are exact and order-free)."""
        v = val.cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        return self._aggregates_np(np.stack([v[..., c] for c in VIEW_COLS],
                                            axis=-1))

    # -- queries ---------------------------------------------------------
    @property
    def attached(self) -> bool:
        return self.proj is not None

    def latest(self):
        """(epoch, aggregates) of the freshest committed fence stamp."""
        return self._stamps[-1] if self._stamps else None

    def retained_epochs(self) -> list[int]:
        return [e for e, _ in self._stamps]

    def time_travel(self, epoch: int):
        """The aggregates exactly as stamped at fence ``epoch`` (None if
        no longer retained)."""
        for e, aggs in self._stamps:
            if e == int(epoch):
                return aggs
        return None
