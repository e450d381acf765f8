"""Bounded-staleness read-replica serving tier (SCAR-style snapshot
reads), port of ``repro.reads``.

STAR's asymmetric replication keeps a full copy of the database on the
master and an operation replica; the read tier serves read-only
transactions directly from those copies' COMMITTED snapshots *between*
epoch fences, validated by epoch/slab watermarks instead of OCC:

* :class:`~repro_torch.reads.catalog.SnapshotCatalog` — stamps every
  replica copy with its last-applied fence epoch + slab high-watermark,
  keeps its own copy of each retained snapshot, and exposes
  ``freshness(replica) = current_epoch - applied_epoch``;
* :class:`~repro_torch.reads.executor.SnapshotReadExecutor` — point-read
  gathers plus one ``scan_window`` launch per index over a chosen
  replica's ``val/tid`` + index segments, lock-free, on a stream of its
  own on the card;
* :class:`~repro_torch.reads.tier.ReadTier` — the serving loop: drains
  the read admission lane, load-balances across eligible replicas within
  the ``max_staleness_epochs`` bound, falls back to the OCC path when no
  replica is fresh enough (over-stale data is NEVER returned).
"""
from repro_torch.reads.catalog import SnapshotCatalog
from repro_torch.reads.executor import SnapshotReadExecutor, reference_read
from repro_torch.reads.tier import ReadTier, ReadTierStats

__all__ = ["ReadTier", "ReadTierStats", "SnapshotCatalog",
           "SnapshotReadExecutor", "reference_read"]
