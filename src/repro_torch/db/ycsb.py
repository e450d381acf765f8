"""YCSB workload (§7.1.1), port of ``repro.db.ycsb``: 1 table, 10 int-word columns, 10 ops/txn,
90/10 read/write, uniform access, 200K records/partition (scalable), default
10% cross-partition transactions.

The generator emits the unified txn format consumed by both executors:
single-partition txns routed per partition (P, T, M) and cross-partition txns
as a flat batch (B, M) with global rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ops import READ, SET

C = 10             # int32 words per row
M = 10             # ops per transaction
ROW_BYTES = 100    # paper: 10 columns x 10 random bytes


@dataclass(frozen=True)
class YCSBConfig:
    n_partitions: int
    records_per_partition: int = 200_000
    cross_ratio: float = 0.10
    write_ops: int = 1             # of 10 -> the 90/10 mix
    seed: int = 0
    # --- access skew (paper default: uniform). zipf_theta > 0 draws row
    # ids rank-ordered from a bounded Zipf(theta); hot_set_size/
    # hot_access_frac overlay a hot-key scenario (frac of ops hit the first
    # hot_set_size rows uniformly) on top of whichever base distribution.
    zipf_theta: float = 0.0
    hot_set_size: int = 0
    hot_access_frac: float = 0.0

    @property
    def total_rows(self):
        return self.n_partitions * self.records_per_partition


_ZIPF_CDF_CACHE: dict = {}


def _zipf_cdf(n: int, theta: float):
    """Inverse-CDF table for a bounded rank-ordered Zipf over n keys."""
    key = (n, round(theta, 6))
    if key not in _ZIPF_CDF_CACHE:
        w = np.arange(1, n + 1, dtype=np.float64) ** -theta
        _ZIPF_CDF_CACHE[key] = np.cumsum(w / w.sum())
    return _ZIPF_CDF_CACHE[key]


def sample_rows(cfg: YCSBConfig, rng: np.random.Generator, shape):
    """Draw partition-local row ids under the configured access skew.
    Uniform by default (one rng call — bit-identical to the seed generator);
    rank r is row id r, so high theta concentrates load on low row ids."""
    if cfg.zipf_theta > 0.0:
        cdf = _zipf_cdf(cfg.records_per_partition, cfg.zipf_theta)
        rows = np.searchsorted(cdf, rng.random(shape)).astype(np.int32)
    else:
        rows = rng.integers(0, cfg.records_per_partition, shape).astype(np.int32)
    if cfg.hot_set_size > 0 and cfg.hot_access_frac > 0.0:
        hot = rng.random(shape) < cfg.hot_access_frac
        rows = np.where(hot, rng.integers(0, cfg.hot_set_size, shape),
                        rows).astype(np.int32)
    return rows


def make_raw(cfg: YCSBConfig, n_txns: int, rng: np.random.Generator):
    """Raw unrouted request arrays — the streaming-generator core shared by
    the offline `make_batch` and the online service clients.

    Returns {'parts' (B,M), 'rows' (B,M), 'kinds' (B,M), 'deltas' (B,M,C),
    'user_abort' (B,), 'home' (B,), 'declared_cross' (B,)} where `home` is
    the partition the client *declares* (routers must detect mis-declared
    singles themselves)."""
    P = cfg.n_partitions

    is_cross = rng.random(n_txns) < cfg.cross_ratio
    home = rng.integers(0, P, n_txns).astype(np.int32)

    # op partitions: single-partition -> home; cross -> random partitions
    op_part = np.repeat(home[:, None], M, axis=1)
    cross_parts = rng.integers(0, P, (n_txns, M)).astype(np.int32)
    # ensure cross txns touch ≥2 partitions: first op stays home
    cross_parts[:, 0] = home
    op_part = np.where(is_cross[:, None], cross_parts, op_part)

    op_idx = sample_rows(cfg, rng, (n_txns, M))
    kinds = np.full((n_txns, M), READ, np.int32)
    wpos = rng.integers(0, M, (n_txns, cfg.write_ops))
    for j in range(cfg.write_ops):
        kinds[np.arange(n_txns), wpos[:, j]] = SET
    deltas = rng.integers(0, 2**31 - 1, (n_txns, M, C), dtype=np.int64).astype(np.int32)

    return {"parts": op_part.astype(np.int32), "rows": op_idx, "kinds": kinds,
            "deltas": deltas, "user_abort": np.zeros(n_txns, bool),
            "home": home, "declared_cross": is_cross,
            # read-tier eligibility: an all-READ op list (write_ops=0
            # configs) can be served from a replica snapshot
            "read_only": (kinds == READ).all(axis=1)}


def route_single(cfg, home, rows, kinds, deltas, T):
    """Group single-partition txns by home partition into (P, T, M) arrays."""
    P = cfg.n_partitions
    n = home.shape[0]
    out = {
        "valid": np.zeros((P, T), bool),
        "row": np.zeros((P, T, M), np.int32),
        "kind": np.zeros((P, T, M), np.int32),
        "delta": np.zeros((P, T, M, C), np.int32),
        "user_abort": np.zeros((P, T), bool),
    }
    fill = np.zeros(P, np.int32)
    for i in range(n):
        p = home[i]
        t = fill[p]
        if t >= T:
            continue
        out["valid"][p, t] = True
        out["row"][p, t] = rows[i]
        out["kind"][p, t] = kinds[i]
        out["delta"][p, t] = deltas[i]
        fill[p] += 1
    return out, int(fill.sum())


def make_batch(cfg: YCSBConfig, n_txns: int, seed: int | None = None):
    """Returns dict with 'ptxn' (P,T,…), 'cross' (B,M,…), metadata."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    R = cfg.records_per_partition
    raw = make_raw(cfg, n_txns, rng)
    P = cfg.n_partitions
    is_cross, home = raw["declared_cross"], raw["home"]
    op_part, op_idx = raw["parts"], raw["rows"]
    kinds, deltas = raw["kinds"], raw["deltas"]

    single = ~is_cross
    n_single = int(single.sum())
    T = max(1, int(np.ceil(n_single / P * 1.3)) + 2)
    ptxn, routed = route_single(
        cfg, home[single], op_idx[single], kinds[single], deltas[single], T)

    cross = {
        "valid": np.ones(int(is_cross.sum()), bool),
        "row": (op_part[is_cross].astype(np.int64) * R
                + op_idx[is_cross]).astype(np.int32),
        "kind": kinds[is_cross],
        "delta": deltas[is_cross],
        "user_abort": np.zeros(int(is_cross.sum()), bool),
    }
    row_bytes = np.full((M,), ROW_BYTES, np.int32)
    # paper §7.5: a YCSB write updates the whole record -> op bytes = row bytes
    return {
        "ptxn": ptxn, "cross": cross,
        "n_single": routed, "n_cross": int(is_cross.sum()),
        "row_bytes": row_bytes, "op_bytes": row_bytes.copy(),
    }


def schema_rows(cfg: YCSBConfig):
    return cfg.records_per_partition
