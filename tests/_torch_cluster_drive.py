"""One scripted run of a cluster engine, shared by the JAX reference (run
in a subprocess over a 4-device CPU mesh) and the PyTorch port, so both
sides take the same steps: epochs, a ``commit=False`` epoch and its
revert, a mid-stream abort, node scribble + donor restore, full-replica
loss + rebuild, and a disk-style ``load_committed``.  It imports neither
framework: each side passes an adapter with ``copies(eng)`` (every copy
and index segment as numpy arrays, keyed by name), ``load(eng, val, tid,
idx)`` and ``scribble_node(eng, node)``.  Returns ``{label: numpy
array}``."""
import copy

import numpy as np

METRIC_KEYS = ("committed_single", "committed_cross", "p_committed",
               "c_committed", "node_committed", "slabs",
               "op_bytes_overlapped", "op_bytes_fence", "index_overflow",
               "starved", "p_cskip", "c_cskip")
ABORT_KEYS = ("aborted_at_slab", "slabs_executed", "slabs_consumed")


def ycsb_batches(mod, P, R, n_txns):
    cfg = mod.YCSBConfig(n_partitions=P, records_per_partition=R)
    return cfg, None, lambda i: mod.make_batch(cfg, n_txns, seed=i), \
        lambda b, m: None


def tpcc_batches(mod, cfg_kw, n_txns, seed=7):
    cfg = mod.TPCCConfig(**cfg_kw)
    state = mod.TPCCState(cfg)
    init = mod.init_values(cfg, np.random.default_rng(seed), state=state)
    return cfg, init, lambda i: mod.make_batch(cfg, state, n_txns, seed=i), \
        lambda b, m: mod.apply_consume_feedback(state, b, m)


def drive(eng, make, feedback, adapter, n_epochs=4, batches=None):
    """``batches``: optional list that receives a copy of every epoch's
    batch (the carried-state test replays them)."""
    out = {}
    step = iter(range(1000))

    def batch():
        b = make(next(step))
        if batches is not None:
            batches.append(copy.deepcopy(b))
        return b

    def metrics(tag, m):
        for k in METRIC_KEYS + ABORT_KEYS:
            if m.get(k) is not None:
                out[f"{tag}/{k}"] = np.asarray(m[k])

    def copies(tag):
        for k, v in adapter.copies(eng).items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/consistent"] = np.asarray(eng.consistent())
        out[f"{tag}/epoch"] = np.asarray(eng.epoch)
        out[f"{tag}/committed_epoch"] = np.asarray(eng.committed_epoch)
        out[f"{tag}/slabs_discarded"] = np.asarray(eng.stats.slabs_discarded)
        out[f"{tag}/ledger"] = np.asarray(eng.slab_ledger).reshape(-1, 2)

    for ep in range(n_epochs):
        b = batch()
        m = eng.run_epoch(b)
        feedback(b, m)
        metrics(f"ep{ep}", m)
        copies(f"ep{ep}")

    # an epoch whose fence a dead node misses: run to the fence, revert
    b = batch()
    metrics("doomed", eng.run_epoch(b, commit=False))
    eng.revert_to_snapshot()
    copies("reverted")
    m = eng.run_epoch(b)
    feedback(b, m)
    metrics("redo", m)
    copies("redo")

    # a mid-stream death at slab 1: slab 0 already shipped
    b = batch()
    metrics("abort", eng.run_epoch(b, abort_check=lambda s: s == 1))
    eng.revert_to_snapshot()
    copies("abort_reverted")
    m = eng.run_epoch(b)
    feedback(b, m)
    metrics("after_abort", m)
    copies("after_abort")

    # node 1's memory dies; its block comes back from the full replica
    adapter.scribble_node(eng, 1)
    copies("scribbled")
    eng.restore_nodes_from_full([1])
    copies("restored_full")

    # every full replica dies; the partial set rebuilds it
    eng.scribble_full()
    copies("scribbled_full")
    eng.rebuild_full_from_partials()
    copies("rebuilt")

    # a disk reload of a committed state (a changed one, so that it shows)
    c = adapter.copies(eng)
    val = c["part_val"].copy()
    val[0, :4] += 7
    idx = [{k: c[f"part_idx/{i}/{k}"] for k in ("key", "prow", "tid")}
           for i in range(sum(1 for k in c if k.startswith("part_idx/")
                              and k.endswith("/key")))]
    adapter.load(eng, val, c["part_tid"], idx or None)
    copies("loaded")
    b = batch()
    m = eng.run_epoch(b)
    feedback(b, m)
    metrics("after_load", m)
    copies("final")
    return out
