"""Storage subsystem: array-resident tables + ordered secondary indexes
(``engine.StorageEngine``, ``index``), and the free-function two-version
tables that ``db/table.py`` re-exports."""
from repro_torch.storage.engine import (Database, StorageEngine, TableSpec,
                                        flat_tid, flat_val, global_key,
                                        make_database, make_table,
                                        snapshot_commit, revert_to_snapshot)
from repro_torch.storage.index import (IndexSpec, PART_SHIFT, SCAN_L,
                                       SENTINEL, apply_index_ops, full_key,
                                       key_partition, make_index,
                                       segment_scan)

__all__ = [
    "Database", "StorageEngine", "TableSpec", "IndexSpec",
    "flat_tid", "flat_val", "global_key", "make_database", "make_table",
    "snapshot_commit", "revert_to_snapshot",
    "PART_SHIFT", "SCAN_L", "SENTINEL", "apply_index_ops", "full_key",
    "key_partition", "make_index", "segment_scan",
]
