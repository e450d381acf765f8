"""Databases and workloads of the port (``tpcc``, ``ycsb``, ``wal``,
``hashtable``); the two-version table functions through ``table``, as
``repro.db`` exports them."""
from repro_torch.db.table import (Database, TableSpec, make_database,
                                  revert_to_snapshot, snapshot_commit)

__all__ = ["Database", "TableSpec", "make_database", "snapshot_commit",
           "revert_to_snapshot"]
