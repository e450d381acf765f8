"""Storage subsystem: array-resident tables + ordered secondary indexes
(``engine.StorageEngine``, ``index``)."""
