"""ChangeLog: the one ordered op stream every replica consumer rides.

Port of ``repro.changelog.log`` (logs are dicts of torch tensors).

STAR's correctness hinges on a single ordered stream of record + index
operations — the full replica replays it, the physical secondary homes
roll-ship it, the WAL persists it, the read tier's catalog stamps its
watermark, and the fence byte model attributes its slabs.  Before this
module each of those consumers was hand-fed by the engines with its own
slab bookkeeping; now the engines PUBLISH once and every consumer is a
:class:`Subscriber`.

Stream structure (exactly the §5 shape the engines execute):

* an epoch's partitioned phase emits ``S = n_slabs`` ordered **slabs** —
  contiguous queue-slot ranges ``[T*s//S, T*(s+1)//S)`` — published in
  order via :meth:`ChangeLog.publish_slab` while the next slab executes;
* the single-master phase emits one round-ordered **master stream**
  (value post-images + index-op rounds) via :meth:`publish_master`;
* the commit fence retires the epoch via :meth:`commit` — consumed slabs
  move to the committed **slab ledger** ``(epoch, slab)`` (the read
  tier's watermark source, tests pin exactly-once application from it)
  and subscribers see ``on_commit`` with the whole epoch's record;
* a §4.5 revert calls :meth:`revert` — the in-flight record is discarded
  and the slab high-watermark resets, so a re-executed epoch re-publishes
  from slab 0 onto committed state exactly once.

The ledger is a bounded telemetry window: overflow is EXPLICIT drop-
oldest, counted in :attr:`ledger_dropped` and surfaced through engine
stats (it used to be silent truncation — a revert near the bound could
not be audited).

Subscriber protocol (all methods optional, duck-typed)::

    class Subscriber:
        needs_write_mask = False      # True: info carries per-partition
                                      # dirty masks (host transfer cost)
        def on_slab(self, log, info): ...   # ordered, in publish order
        def on_master(self, stream): ...    # {"log","kinds","delta"}
        def on_commit(self, epoch, record): ...
        def on_revert(self, epoch, n_slabs): ...
        def on_reset(self, val, tid, epoch): ...   # disk reload (§4.5.1)

``on_slab``'s ``info`` is ``{"epoch", "slab", "dirty"}`` where ``dirty``
is a (P,) bool per-partition write mask (None unless some subscriber
sets ``needs_write_mask``) — the read tier's mid-epoch slab-watermark
gate feeds on it.  ``on_commit``'s ``record`` is
``{"part": plog | None, "sm": slog | None, "cross_kinds", "cross_delta"}``
— the WAL sink fans it to the per-worker logs inside the fence.

Byte attribution (:meth:`attribute`) is the SINGLE source both engines'
``op_bytes_overlapped`` / ``op_bytes_fence`` stats and the fence network
model derive from, wrapping :func:`repro_torch.core.replication
.epoch_stream_bytes` + :func:`~repro_torch.core.replication.split_overlapped`
— the pinned invariant (overlapped + fence == total == Σ slab sizes) is
tested once against this object instead of per engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import replication as repl
from repro_torch.obs import trace as obs


@dataclass
class Attribution:
    """One epoch's op-stream byte attribution (the single source)."""
    value_bytes_alt: int               # if value replication had shipped
    slab_bytes: list[int] = field(default_factory=list)
    index_op_bytes: int = 0            # index ops riding the stream
    overlapped: int = 0                # shipped DURING execution (head)
    fence: int = 0                     # the unshipped tail the fence waits on

    @property
    def total(self) -> int:
        return sum(self.slab_bytes)


class ChangeLog:
    """Owns one engine's ordered epoch/slab op stream + its subscribers."""

    LEDGER_CAP = 4096                  # committed-slab telemetry window

    def __init__(self, n_slabs: int, ledger_cap: int | None = None):
        assert n_slabs >= 1, n_slabs
        self.n_slabs = int(n_slabs)
        self.ledger_cap = int(ledger_cap if ledger_cap is not None
                              else self.LEDGER_CAP)
        self._subs: list = []
        self._needs_mask = False
        # in-flight epoch record
        self._slab_logs: list = []     # published slab logs, in order
        self._plog_cache = None        # concat of _slab_logs (lazy)
        self._master = None            # {"log","kinds","delta"}
        self.slab_hwm = 0              # published slabs of in-flight epoch
        # committed history
        self.ledger: list[tuple[int, int]] = []    # committed (epoch, slab)
        self.ledger_dropped = 0        # explicit drop-oldest overflow count

    # -- subscribers -----------------------------------------------------
    def subscribe(self, sub):
        """Register a subscriber (fired in registration order — the full
        replica registers before the secondaries before the sinks, so the
        replay order the engines relied on is preserved)."""
        self._subs.append(sub)
        self._needs_mask = any(getattr(s, "needs_write_mask", False)
                               for s in self._subs)
        return sub

    def _fire(self, method: str, *args):
        for sub in self._subs:
            fn = getattr(sub, method, None)
            if fn is not None:
                fn(*args)

    # -- slab framing ----------------------------------------------------
    def slab_bounds(self, T: int) -> list[int]:
        """The §5 slab frame: T queue slots split into ``n_slabs``
        contiguous chunks — the SAME bounds the byte model
        (``repl.slab_op_bytes``) attributes with."""
        S = max(1, min(self.n_slabs, T))
        return [T * s // S for s in range(S + 1)]

    # -- publication (in stream order) -----------------------------------
    def publish_slab(self, log, epoch: int):
        """Publish one committed slab of the partitioned op stream.  Fires
        every subscriber's ``on_slab`` synchronously (the engines call
        this while the NEXT slab executes, so subscriber work overlaps
        execution) and advances the slab high-watermark."""
        dirty = None
        if self._needs_mask:
            # (P,) bool: partitions this slab wrote — host transfer of the
            # write mask, paid only when a subscriber asked for it
            dirty = log["write"].any(2).any(1).cpu().numpy()
        info = {"epoch": int(epoch), "slab": self.slab_hwm, "dirty": dirty}
        self._slab_logs.append(log)
        self._plog_cache = None
        # the subscriber seam IS the ship path: one span per published slab
        # covers replica replay + secondary roll-ship + MV apply + WAL
        with obs.span("changelog.slab_ship", cat="ship",
                      epoch=int(epoch), slab=self.slab_hwm,
                      subscribers=len(self._subs)):
            self._fire("on_slab", log, info)
        self.slab_hwm += 1

    def publish_master(self, log, kinds=None, delta=None):
        """Publish the single-master phase's stream: the round-ordered
        value/index log plus the batch's static op arrays (index-op
        replay and WAL recovery re-apply (kind, operand), which the log
        itself does not carry)."""
        self._master = {"log": log, "kinds": kinds, "delta": delta}
        with obs.span("changelog.master_ship", cat="ship",
                      subscribers=len(self._subs)):
            self._fire("on_master", self._master)

    def epoch_plog(self):
        """The in-flight epoch's whole partitioned log — the ordered
        concatenation of its published slabs (cached; slab axis 1)."""
        if self._plog_cache is None:
            if not self._slab_logs:
                return None
            if len(self._slab_logs) == 1:
                self._plog_cache = self._slab_logs[0]
            else:
                self._plog_cache = {
                    k: torch.cat([lg[k] for lg in self._slab_logs], dim=1)
                    for k in self._slab_logs[0]}
        return self._plog_cache

    # -- byte attribution (the single source) ----------------------------
    def attribute(self, batch, plog, has_index: bool, pad_fn) -> Attribution:
        """Attribute one epoch's partitioned-stream bytes: per-slab sizes
        on the same ``slab_bounds`` frame, the overlapped/fence split, and
        the index-op share.  All zeros when the batch carries no byte
        tables (see ``repl.epoch_stream_bytes``)."""
        vb_alt, slab_bytes, ib = repl.epoch_stream_bytes(
            batch, plog, has_index, self.n_slabs, pad_fn)
        head, tail = repl.split_overlapped(slab_bytes)
        return Attribution(value_bytes_alt=vb_alt, slab_bytes=slab_bytes,
                           index_op_bytes=ib, overlapped=head, fence=tail)

    # -- commit / revert / reset ----------------------------------------
    def commit(self, epoch: int) -> tuple[int, int]:
        """Commit fence: retire the in-flight slabs into the committed
        ledger (explicit drop-oldest at ``ledger_cap``), hand the whole
        epoch record to subscribers, clear the in-flight state.  Returns
        ``(slabs_retired, ledger_entries_dropped)``."""
        shipped = self.slab_hwm
        for s in range(shipped):
            self.ledger.append((int(epoch), s))
        dropped = max(0, len(self.ledger) - self.ledger_cap)
        if dropped:
            del self.ledger[:dropped]          # drop-oldest, counted
            self.ledger_dropped += dropped
        record = {"part": self.epoch_plog(),
                  "sm": self._master["log"] if self._master else None,
                  "cross_kinds": self._master["kinds"] if self._master
                  else None,
                  "cross_delta": self._master["delta"] if self._master
                  else None}
        with obs.span("changelog.commit", cat="fence", epoch=int(epoch),
                      slabs=shipped):
            self._fire("on_commit", int(epoch), record)
        self._clear()
        return shipped, dropped

    def revert(self, epoch: int) -> int:
        """§4.5 revert: discard the in-flight epoch's record and reset the
        slab high-watermark — the re-executed epoch re-publishes from
        slab 0 onto committed state, so every consumer applies each
        committed slab exactly once.  Returns the slabs discarded."""
        discarded = self.slab_hwm
        self._fire("on_revert", int(epoch), discarded)
        self._clear()
        return discarded

    def reset_from_state(self, val, tid, epoch: int):
        """§4.5.1 disk reload: the stream history is gone — subscribers
        rebuild their state from the recovered committed arrays."""
        self._fire("on_reset", val, tid, int(epoch))

    def _clear(self):
        self._slab_logs = []
        self._plog_cache = None
        self._master = None
        self.slab_hwm = 0

    # -- watermark (read-tier stamping) ----------------------------------
    def watermark(self, committed_epoch: int) -> tuple[int, int]:
        """The snapshot watermark the catalog stamps: (last committed
        fence epoch, that epoch's retired slab count from the ledger)."""
        return repl.snapshot_watermark(committed_epoch, self.ledger)
