"""Compatibility shim, the port of ``repro/db/table.py``: the two-version
tables (§4.5.2) live in ``repro_torch.storage.engine`` next to the ordered
secondary indexes; this module re-exports their names."""
from repro_torch.storage.engine import (Database, TableSpec, flat_tid,  # noqa: F401
                                        flat_val, global_key, make_database,
                                        make_table, snapshot_commit,
                                        revert_to_snapshot)
