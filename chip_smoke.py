"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. build: compile the seven CUDA sources of ``src/repro_torch/csrc`` (one
   nvcc each, in parallel) and print the card's name and power limit;
2. kernel parity: run one warm STAR epoch at full TPC-C widths (the main
   path's configuration below) while recording the arguments of the first
   main-path call of every kernel wrapper; then run each kernel on those
   arguments and hold the result bit-equal against its plain PyTorch
   version run on the CPU (tolerance 0: every value is an integer), time
   both on the card with CUDA events, and compute the kernel's bound.
   The index probe is held in its three launch configurations: single-
   master (``locate_index_ops``) and partitioned (``step_index_ops``) on
   their recorded calls, bare (``scan_window``) at both shapes, then on
   crafted indexes (every slot SENTINEL, full segments, ragged caps) and
   ops (keys past every key, partitions and IX_ID out of range, strided
   op slices).  The OCC round is held in Silo mode, in Calvin mode (with
   a read-lock array), without claims and without an index, its lock
   arrays all B after each call.  torch.profiler counts one kernel a call
   of every probe configuration and of the round, and each call's aten
   operators and host time are reported.  index_merge is held at both
   recorded shapes (partitioned and
   single-master), in shared memory and in global scratch, and on
   crafted batches (ties, double deletes, overflow, empty segments, empty
   batches, ragged caps, a large sort); both shapes are timed beside the
   stable argsort and gathers the card path ran before it until the
   kernel sorted its own inserts, and torch.profiler counts the kernels
   one call launches (at most two).  thomas_merge is held on the epoch's
   single-master log through ``thomas_apply_batch`` (the log's flattened
   views, no copy), through the bare entry on the same stream, and on
   crafted streams (K = 0, every row -1, one row under one TID, stale
   TIDs, TIDs at 2^32 - 1, word copies, two calls back to back);
   torch.profiler counts one kernel a call of ``thomas_apply_batch``;
3. engine parity: the full-mix configuration of
   benchmarks/fig11_throughput.py (P=4, 4,000 items, 100 customers a
   district, order ring 128, 512 transactions an epoch) for 3 epochs on
   the card with the kernels and on the CPU with the plain versions:
   master, replica and indexes bit-equal after every epoch;
4. main path: P=16 warehouses at the spec's widths (100,000 items, 3,000
   customers a district, 10 districts; order ring 256, the most the
   orders_by_cust key layout holds), the full mix, 2,048 transactions an
   epoch, 16 OCC rounds: 4 measured epochs after the warm one, with
   ``replica_consistent()`` at every fence, every kernel launched (the
   probe in both phases) and every lock array the executor handed to the
   round all B after the epochs; then one more epoch under
   ``torch.profiler`` for the card's busy time;
8. the service path (run after phase 4): ``TxnService`` over a
   ``StarEngine`` on the card, in the three scenarios of
   examples/serve_txn.py on YCSB at the paper's scale (16 partitions x
   200,000 records, 10 int32 columns, 10 ops, 90/10 read/write, 10 %
   cross-partition), 2.0 s each with 32 slots a partition and 32 master
   lanes: steady Poisson at 1,500 txn/s with the WAL on (4 workers, a
   checkpoint every 4 epochs), then ``recover_full`` on the card
   bit-equal to the committed state; bursty over Zipf(0.9) at 1,000
   txn/s; overload at 30,000 txn/s with queue caps 64/128, shedding,
   its queues within the caps.  ``replica_consistent()`` at every fence,
   ``occ_round`` and ``thomas_merge`` launched in each.  The steady
   scenario's epochs up to its 8th non-empty batch are replayed through a
   fresh engine on the card and one on the CPU: master and replica
   bit-equal and the commit masks equal (to the service run's too).
   Then TPC-C's full mix at phase 4's scale through the service for 3.0 s
   with the consume feedback, all four STAR kernels launched and the
   probe in both phases, and its epochs up to the 4th non-empty batch
   replayed the same way, indexes included (so the probe, index_merge,
   occ_round and thomas_merge are held against their plain versions at
   the service's shapes); and the fig11 configuration for 5 epochs with
   the WAL,
   ``recover_full`` on the card bit-equal, indexes included;
9. the read path (run after phase 8): phase 8's TPC-C service run again,
   with the read tier (``ReadTier(max_staleness_epochs=2,
   sec_refresh_every=2)``, fig12's knobs) and the analytics lane; then 4
   more epochs of 512 transactions on the same engine whose read-only
   transactions are offered to the read lane after their fence and
   served at bound 2 (freshness 0 and 1).  ``replica_consistent()`` at
   every fence, the views' committed projection equal to the master
   snapshot's ``VIEW_COLS`` at every fence and each fence's stamp equal
   to ``recompute`` of that fence's committed values; 0 stale reads,
   reads served mid-epoch, every read within the bound; the first 4
   distinct (replica, epoch) snapshots served in each part equal to
   their fence, every group served from them equal to ``reference_read``
   and to the CPU executor on a host copy; the lanes' own launches of
   ``scan_window`` (at most one an index a group) and ``thomas_merge``
   (one a views merge) counted from 0, and the first call of each held
   bit-equal to its plain version on the CPU and timed (the new call
   shapes); the snapshot copy timed a view and the dirty gate's host
   copy a slab;
5. LM kernel parity: Hymba-1.5B at its published widths and depth in
   bf16, random weights from a seed, serves 8 requests of 2,048 tokens
   plus 2 new ones through ``ServeEngine.generate`` while the first call
   of each LM kernel wrapper is recorded; both flash-attention
   configurations are first held against their plain version on a sweep
   of small shapes (f32 and bf16, every head dim, ragged lengths, causal,
   windowed and bidirectional masks, regular and padded head maps, rings
   with empty slots, fully masked rows); rmsnorm first on a sweep
   (1 to 16,384 rows, widths 1,600 to 12,288, bf16 and f32, with and
   without a residual, both forms of the kernel), then timed at the decode
   shape alone and in a chain that mirrors a decode block; then
   rmsnorm (bf16), flash
   attention (bf16, prefill and decode, unexpanded K/V with the head map)
   and the SSD scan (f32; first on a sweep of small shapes at 1e-4: P,
   N, chunk, heads, ragged lengths, weak and strong decay, Mamba2-130M's
   widths) are held against their plain versions on the
   recorded card inputs, each within the tolerance stated at its check,
   and timed beside one PyTorch call that computes the same function where
   there is one (SDPA needs K/V expanded to every query head: that
   gather's time is reported beside it and left out of its figure);
6. serve parity: Hymba at full width, depth cut to 2 layers, float32, the
   same weights on the card and the CPU: one 2,048-token prompt, then 8
   decode steps with the same token fed to both; every logit within
   ``TOL_SERVE``;
7. serve path: ``ServeEngine.generate`` on the full model, 8 x 2,048
   prompt tokens and 64 decode steps, after an untimed one: 3 timed runs
   (the median by total time is reported, all three beside it), the LM
   kernels' launch counts from the first (rmsnorm's also where its
   prefill ends); then a prefill, and a prefill
   with 8 decode steps, under ``torch.profiler`` for where the time goes.

Before phase 2 it times the least kernel, a one-element ``fill_``, by
torch.profiler (the launch floor).

Kernel times are device times: CUDA events around a call enqueued while
a spin kernel keeps the card busy, so the wrapper's host time is not
counted; the median of 20 calls (5 for the slow plain versions of the LM
kernels).  Bounds are the larger of bytes over 3.35 TB/s (each input read
once, each output written once, counting what this run's inputs need)
and operations over the card's peak rate for their type: int32 16.7 T/s,
float32 67 TFLOP/s outside the tensor cores, TF32 495 TFLOP/s (the SSD
scan's 3xTF32 products count three times), bf16 989 TFLOP/s.

``python3 chip_smoke.py --ab PARENT`` compares two checkouts on one card
in one call instead: PARENT is a directory holding another checkout's
``src/repro_torch`` (the parent commit unpacked with ``git archive``, for
example).  It runs phase 4's measured epochs and profiled epoch, phase
7's prefill and the SSD kernel on its recorded prefill arguments, with
each tree's kernels, in four processes: parent, this tree, this tree,
parent.  Each process also times the probe (both phases), the OCC round
and ``thomas_apply_batch`` through the executors' wrappers on the
arguments its warm epoch recorded, and rmsnorm at the decode shape:
device time by CUDA events and by torch.profiler, kernels, aten
operators and host time a call, and the decode chain of
:func:`norm_chain`; and rmsnorm at the prefill shape and at the row
counts of RMS_AB_ROWS (D = 1,600) by CUDA events.  It prints the card's
name and power limit, then one ``AB {...}`` JSON line a process.

``python3 chip_smoke.py --lanes N`` runs phase 8's TPC-C service run
instead, in N pairs without and with phase 9's read tier and analytics
lane (order alternating, one untimed run first), and prints the card's
name and power limit and one ``LANES {...}`` JSON line a run.

It prints the build time, the ``nvidia-smi`` name and power limit, one
JSON line of kernels (with each STAR kernel's launches in every service
run and by the read path's lanes), one of main-path figures, one of
service-path figures, one of read-path figures, one of serve-path figures and, last, the ``{"ok": true, "device": ...}`` line.  It needs one CUDA
card and the repository around it; without either it exits non-zero and
prints no result.
"""
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12       # HBM3 rate of an H100 SXM (data sheet)
H100_INT32_OPS_PER_S = 16.7e12   # 132 SMs x 64 INT32 lanes x 1.98 GHz
H100_MAX_CLOCK_HZ = 1.98e9
MAIN = dict(n_partitions=16, n_items=100_000, cust_per_district=3_000,
            order_ring=256, mix="full", delivery_gen_lag=2048)
MAIN_TXNS, MAIN_EPOCHS, MAX_ROUNDS = 2048, 4, 16
H100_BF16_FLOPS = 989e12         # dense tensor cores (data sheet)
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12         # dense tensor cores (data sheet)
SERVE_ARCH = "hymba-1.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64
PARITY_LAYERS, PARITY_DECODE, PROFILE_STEPS = 2, 8, 8
SERVE_RUNS = 3                   # measured generates; the median is reported
TOL_BF16_NORM = 1e-2             # reasons beside each check
TOL_F32_NORM = 1e-6              # tests/test_kernels.py's rmsnorm bound
RMS_CHAIN = 32                   # decode blocks in rmsnorm's timed chain
# rmsnorm's sweep: rows (with csrc/rmsnorm.cu's REG_ROWS, the most rows
# its register form takes, and one more) by widths: Hymba's d_model and
# d_inner, one not a multiple of 8, the widest
RMS_SWEEP_ROWS = (1, 8, 64, 65, 16384)
RMS_SWEEP_WIDTHS = (1600, 3200, 1601, 12288)
RMS_AB_ROWS = (8, 32, 64, 65, 128, 256, 1024, 4096, 16384)   # --ab timings
TOL_BF16_FLASH = 2e-2
TOL_F32_FLASH = 1e-5
TOL_SSD = 1e-3
TOL_SSD_SWEEP = 1e-4             # tests/test_kernels.py's SSD bound
TOL_SERVE = 1e-3
FIG11 = dict(n_partitions=4, n_items=4000, cust_per_district=100,
             order_ring=128, mix="full", delivery_gen_lag=512)
FIG11_TXNS, FIG11_EPOCHS = 512, 3
# phase 8: the service path (examples/serve_txn.py's scenarios)
YCSB_P = 16                      # x 200,000 records (the module's default)
SERVICE_S, SERVICE_TPCC_S = 2.0, 3.0
SERVICE_SLOTS, SERVICE_LANES = 32, 32
SERVICE_TPCC_RATE = 1500.0
SERVICE_REPLAY = 8               # steady batches replayed card vs CPU
SERVICE_TPCC_REPLAY = 4          # tpcc_full batches replayed card vs CPU
SERVICE_WAL_EPOCHS = 5           # fig11 epochs logged for index recovery
# phase 9: the read tier and the analytics lane (fig12's read-tier knobs)
READ_K, READ_REFRESH = 2, 2      # staleness bound, replica view cadence
READ_SNAPSHOTS = 4               # distinct (replica, epoch) snapshots checked
READ_DIRECT_EPOCHS = 4           # epochs whose reads serve after the fence
READ_DIRECT_TXNS = 512
# the pl.pallas_call site of each TPU kernel
REPLACES = {
    "scan_window": "src/repro/kernels/occ/kernel.py:129",
    "occ_round": "src/repro/kernels/occ/kernel.py:421",
    "index_merge": "src/repro/kernels/index_merge/kernel.py:170",
    "thomas_merge": "src/repro/kernels/thomas_merge/kernel.py:77",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:30",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:92",
    "mamba2_ssd": "src/repro/kernels/mamba2_ssd/kernel.py:75",
}
SOURCE = {
    "scan_window": "src/repro_torch/csrc/scan_window.cu",
    "occ_round": "src/repro_torch/csrc/occ_round.cu",
    "index_merge": "src/repro_torch/csrc/index_merge.cu",
    "thomas_merge": "src/repro_torch/csrc/thomas_merge.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "mamba2_ssd": "src/repro_torch/csrc/ssd.cu",
}


# occ_round_pallas's three pallas_call sites (lock build, install,
# validate), all replaced by the one cooperative kernel
REPLACES_ROUND = ["src/repro/kernels/occ/kernel.py:174",
                  "src/repro/kernels/occ/kernel.py:301",
                  "src/repro/kernels/occ/kernel.py:421"]


class Failure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def tree_map(fn, x):
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return fn(x)


def tree_leaves(x):
    if isinstance(x, dict):
        return [y for v in x.values() for y in tree_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in tree_leaves(v)]
    return [x]


def to(x, device):
    import torch
    return tree_map(lambda t: t.detach().to(device, copy=True)
                    if isinstance(t, torch.Tensor) else t, x)


def equal(a, b):
    import torch
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and torch.equal(x.cpu(), y.cpu())):
                return False
        elif x != y:
            return False
    return True


def max_abs_err(a, b):
    """Largest absolute difference between the tensors of two equal-shaped
    trees (as int64: every kernel output is an integer or a flag)."""
    import torch
    errs = [int((x.cpu().long() - y.cpu().long()).abs().max())
            for x, y in zip(tree_leaves(a), tree_leaves(b))
            if isinstance(x, torch.Tensor) and x.numel()]
    return max(errs, default=0)


def cuda_ms(fn, reps=20, warm=3, setup=None):
    """Median device time of ``fn()`` in ms: CUDA events around each call,
    with the card kept busy by a spin kernel while the host enqueues the
    call, so that the Python wrapper's host time between the events does
    not count.  ``setup()`` (untimed) runs before each call."""
    import torch
    for _ in range(warm):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # spin at least twice as long as one host enqueue of fn takes, at the
    # card's top clock (a lower clock spins longer)
    cycles = int(2 * H100_MAX_CLOCK_HZ * (time.perf_counter() - t0)) + 10**6
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


class Recorder:
    """Wraps kernel wrappers so that the first main-path call of each is
    recorded (a copy of its arguments, taken before the call: some kernels
    update their inputs in place)."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, name, key_of):
        orig = getattr(module, name)

        def wrapper(*args, **kw):
            key = key_of(*args, **kw)
            if key is not None and key not in self.calls:
                dev = next(t.device for t in tree_leaves(args)
                           if hasattr(t, "device"))
                self.calls[key] = to((args, kw), dev)
            return orig(*args, **kw)

        setattr(module, name, wrapper)
        self._undo.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


def mk_engine(cfg_kw, seed, device, **kw):
    import numpy as np
    from repro_torch.core.engine import StarEngine
    from repro_torch.db import tpcc
    cfg = tpcc.TPCCConfig(**cfg_kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(seed), state=state)
    eng = StarEngine(cfg.n_partitions, cfg.rows_per_partition, init_val=init,
                     indexes=tpcc.index_specs(cfg), max_rounds=MAX_ROUNDS,
                     device=device, **kw)
    return cfg, state, eng


def same_store(a, b):
    """Two stores (or state dicts) bit-equal, records and indexes."""
    from repro_torch.convert import to_numpy_state
    import numpy as np
    x, y = to_numpy_state(a), to_numpy_state(b)
    return (np.array_equal(x["val"], y["val"])
            and np.array_equal(x["tid"], y["tid"])
            and all(np.array_equal(i[f], j[f])
                    for i, j in zip(x["indexes"], y["indexes"])
                    for f in ("key", "prow", "tid")))


# ---------------------------------------------------------------------------
# phase 2: kernels at main-path shapes
# ---------------------------------------------------------------------------
def wrap_occ(rec):
    """Record the first call of the probe in each phase and of the OCC
    round, where the executors call them."""
    from repro_torch.core import partitioned, single_master
    rec.wrap(partitioned, "step_index_ops", lambda *a, **k: "step_index_ops")
    rec.wrap(single_master, "locate_index_ops",
             lambda *a, **k: "locate_index_ops")
    rec.wrap(single_master, "occ_round", lambda *a, **k: "occ_round")


def record_warm_epoch(eng, batch):
    """Run ``batch`` through ``eng`` with the kernel wrappers recorded."""
    from repro_torch.core import replication
    from repro_torch.core.ops import IDX_OPS
    from repro_torch.kernels.index_merge import ops as im_ops
    rec = Recorder()
    wrap_occ(rec)
    P = eng.P
    # the first merge of each shape: (P, P*K) in the partitioned phase,
    # (P, B*K) in the single-master one
    rec.wrap(im_ops, "index_merge_cuda",
             lambda key, prow, tid, dk, ik, ip, it:
             "index_merge/part" if ik.shape[1] <= P * IDX_OPS
             else "index_merge/sm")
    rec.wrap(replication, "thomas_apply_batch",
             lambda *a, **k: "thomas_apply_batch")
    try:
        m = eng.run_epoch(batch)
    finally:
        rec.restore()
    return m, rec.calls


def sort_gather(ik, ip, it):
    """What the card path ran before each index_merge launch until the
    kernel sorted its own inserts: a stable argsort and three gathers."""
    import torch
    o = torch.argsort(ik, dim=1, stable=True)
    return ik.gather(1, o), ip.gather(1, o), it.gather(1, o)


def device_kernels(body):
    """torch.profiler's kernels for ``body()``: {name: (device µs, count)}.
    Spin kernels run before the body (a 20 ms one, then 32 short ones)
    and after it (32 short ones) inside the profiled window and are left
    out: the profiler can miss a few kernels of a window (in some
    processes it counted 0 for the one kernel of a wrapper call, and 46
    of 50 calls, most often after a long profiled window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def spins(n):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(0.02 * H100_MAX_CLOCK_HZ))
        spins(32)
        body()
        torch.cuda.synchronize()
        spins(32)
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out[e.key] = (us, e.count)
    return out


def kernels_in(fn):
    """Kernels the card ran for one ``fn()``, from torch.profiler."""
    return sum(n for _, n in device_kernels(fn).values())


def prof_ms(fn, reps=50, setup=None):
    """torch.profiler over ``reps`` calls of ``fn()`` after a warm one,
    each call synchronised: (the card's kernel time a call in ms, kernels
    a call).  Unlike :func:`cuda_ms` it leaves out the gaps between
    launches.  ``setup()`` runs before each call; the kernels it launches
    (found by profiling it alone) are left out."""
    import torch
    skip = set(device_kernels(setup)) if setup is not None else set()
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
            torch.cuda.synchronize()
    per = device_kernels(calls)
    us = sum(t for k, (t, _) in per.items() if k not in skip)
    n = sum(c for k, (_, c) in per.items() if k not in skip)
    return us / reps / 1e3, n / reps


def aten_calls(fn):
    """The aten operators one ``fn()`` dispatches on the host, outermost
    ones only (torch.profiler, CPU activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.name.startswith("aten::") and e.cpu_parent is None)


def host_us(fn, reps=200):
    """Host time of one ``fn()`` in µs, the mean of ``reps`` calls enqueued
    back to back (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def call_figures(fn, setup=None):
    """Device time (CUDA events and profiler), kernels, aten operators and
    host time of one call of a kernel wrapper."""
    pm, n = prof_ms(fn, setup=setup)
    return {"ms": cuda_ms(fn, setup=setup), "prof_ms": pm,
            "prof_kernels_per_call": n, "kernels_per_call": kernels_in(fn),
            "aten_calls": aten_calls(fn), "host_us": host_us(fn)}


def max_cap(index):
    """The longest segment of an index list (the bare probe's bound)."""
    return max(ix["key"].shape[1] for ix in index)


def probe_cases(dev):
    """The probe's three configurations on crafted indexes and ops, each
    bit-equal to its plain version on the CPU: an index whose every slot
    is SENTINEL, full segments (no SENTINEL), ragged caps (2,880, 1, 33)
    with empty and full partitions; queries at live keys, one below and
    one past a partition's keys, SENTINEL, the lowest int32, partitions
    outside [0, P), IX_ID outside the index list, every kind; and the
    executors' strided op slices.  Returns the case names."""
    import torch
    from repro_torch.core.ops import IX_EXPECT, IX_HI, IX_ID, IX_LO
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.storage.index import SCAN_L
    from repro_torch.storage.index import SENTINEL as S
    gen = torch.Generator().manual_seed(23)
    P, B, K, C = 4, 64, 12, 10
    i32 = torch.int32

    def rint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=gen))

    def table(cap, fills):
        key = torch.full((P, cap), S, dtype=i32)
        tid = torch.zeros((P, cap), dtype=torch.int64)
        for p, n in enumerate(fills):
            local = torch.randperm(1 << 16, generator=gen)[:n].sort().values
            key[p, :n] = ((p << 24) | local).to(i32)
            tid[p, :n] = torch.randint(0, 1 << 32, (n,), generator=gen)
        return {"key": key, "prow": torch.zeros((P, cap), dtype=i32),
                "tid": tid}

    def ops(index, rows):
        kinds = torch.randint(0, 10, (rows, K), generator=gen, dtype=i32)
        delta = torch.randint(-50, 50, (rows, K, C), generator=gen,
                              dtype=i32)
        n = len(index)
        for r in range(rows):
            for k in range(K):
                i, part = rint(-2, n + 2), rint(-1, P + 2)
                seg = index[i if 0 <= i < n else 0]["key"][
                    min(max(part, 0), P - 1)]
                live = seg[seg != S]
                c = rint(0, 7)
                if c == 0 and live.numel():
                    v = int(live[rint(0, live.numel())])
                elif c == 1 and live.numel():
                    v = int(live[-1]) + 1
                elif c == 2 and live.numel():
                    v = int(live[0]) - 1
                elif c == 3:
                    v = S
                elif c == 4:
                    v = -(1 << 31)
                elif c == 5:
                    v = part << 24
                else:
                    v = rint(-(1 << 30), 1 << 30)
                pos = int(torch.searchsorted(seg, torch.tensor(v, dtype=i32)))
                nxt = int(seg[pos]) if pos < seg.numel() else v
                delta[r, k, IX_LO] = v
                delta[r, k, IX_HI] = max(min(v + rint(-2, 1 << 12), S),
                                         -(1 << 31))
                delta[r, k, IX_EXPECT] = nxt if rint(0, 2) else v
                delta[r, k, IX_ID] = i
        return kinds, delta

    def strided(kinds, delta):
        """the same ops as slices of wider op arrays, on the card"""
        wk = torch.cat([kinds, kinds[:, :5]], 1).to(dev)
        wd = torch.cat([delta, delta[:, :5]], 1).to(dev)
        return wk[:, :K], wd[:, :K]

    indexes = {
        "ragged": [table(2880, [0, 1, 1500, 2880]), table(1, [0, 1, 1, 0]),
                   table(33, [33, 0, 32, 33])],
        "empty": [table(2880, [0] * P), table(1, [0] * P),
                  table(33, [0] * P)],
        "full": [table(33, [33] * P), table(2880, [2880] * P)],
    }
    names = []
    for name, index in indexes.items():
        di = to(index, dev)
        kinds, delta = ops(index, B)
        want = occ_ref.locate_index_ops_plain(index, kinds, delta, 1000)
        check(equal(occ_ops.locate_index_ops(di, *to((kinds, delta), dev),
                                             1000), want),
              f"probe case {name}: single-master differs")
        check(equal(occ_ops.locate_index_ops(di, *strided(kinds, delta),
                                             1000), want),
              f"probe case {name}: single-master on strided ops differs")
        pk, pd = kinds[:P], delta[:P]
        want = occ_ref.step_index_ops_plain(index, pk, pd)
        check(equal(occ_ops.step_index_ops(di, *to((pk, pd), dev)), want),
              f"probe case {name}: partitioned differs")
        check(equal(occ_ops.step_index_ops(di, *strided(pk, pd)), want),
              f"probe case {name}: partitioned on strided ops differs")
        for cfg, build, a, ns in (
                ("sm", occ_ref.sm_probe_args, (kinds, delta), SCAN_L + 1),
                ("part", occ_ref.part_probe_args, (pk, pd), 1)):
            *flat, _, n_iters = build(index, *a)
            want = occ_ref.scan_window_plain(*flat, n_slots=ns,
                                             n_iters=n_iters)
            got = occ_ops.scan_window(*to(flat, dev), n_slots=ns,
                                      max_cap=max_cap(index))
            check(equal(got, want), f"probe case {name}: bare ({cfg}) "
                  f"differs")
        names += [f"{name}/{c}" for c in ("single_master",
                                           "single_master_strided",
                                           "partitioned",
                                           "partitioned_strided",
                                           "bare_sm", "bare_part")]
    torch.cuda.synchronize()
    print(f"probe: {len(names)} crafted cases bit-equal")
    return names


def probe_checks(calls, dev, report):
    """The probe's three launch configurations on the main path's recorded
    arguments: single-master (the row's figures), partitioned and bare at
    both phases' shapes, each bit-equal to its plain version on the CPU
    and one kernel a call; then the crafted cases."""
    import torch
    from repro_torch.core.ops import IX_ID, is_index_kind
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.storage.index import SCAN_L
    cpu = torch.device("cpu")
    L1 = SCAN_L + 1

    def work(index, kinds, delta, sel, n_slots, out_bytes):
        """bytes and operations: each op's kind and 4 delta words read and
        its outputs written; a selected op's search (the keys of a binary
        search) and window (keys and TIDs)"""
        Q = kinds.numel()
        n_sel = int(sel.sum())
        lg = max(ix["key"].shape[1] for ix in index).bit_length()
        return (Q * (4 + 16 + out_bytes) + n_sel * (4 * lg + 12 * n_slots),
                Q * 4 + n_sel * (lg + 8 * n_slots))

    (index, kinds, delta, n_rows), _ = calls["locate_index_ops"]
    iid = delta[..., IX_ID].cpu()
    sel_sm = (is_index_kind(kinds.cpu()) & (iid >= 0)
              & (iid < len(index)))
    nb, no = work(index, kinds, delta, sel_sm, L1, 4 + 8 + 1 + L1 * 13)
    row = report("scan_window", occ_ops.locate_index_ops,
                 occ_ref.locate_index_ops_plain,
                 (index, kinds, delta, n_rows), {}, nbytes=nb, nops=no)
    a = to((index, kinds, delta, n_rows), dev)
    row["single_master"] = dict(
        call_figures(lambda: occ_ops.locate_index_ops(*a)),
        queries=kinds.numel(), selected=int(sel_sm.sum()))
    sm_args = (index, kinds, delta)

    (pindex, pk, pd), _ = calls["step_index_ops"]
    got = occ_ops.step_index_ops(*to((pindex, pk, pd), dev))
    want = occ_ref.step_index_ops_plain(*to((pindex, pk, pd), cpu))
    check(equal(got, want), "probe (partitioned) differs from its plain "
          "version")
    piid = pd[..., IX_ID].cpu()
    sel_p = (piid >= 0) & (piid < len(pindex))
    nb, no = work(pindex, pk, pd, sel_p, 1, 1 + 8)
    a = to((pindex, pk, pd), dev)
    row["partitioned"] = dict(
        call_figures(lambda: occ_ops.step_index_ops(*a)),
        queries=pk.numel(), selected=int(sel_p.sum()),
        max_abs_err=max_abs_err(got, want),
        plain_ms=cuda_ms(lambda: occ_ref.step_index_ops_plain(*a)),
        bound_ms=max(nb / H100_BYTES_PER_S, no / H100_INT32_OPS_PER_S) * 1e3)

    # the bare configuration (segment_scan's) on both phases' probes: the
    # queries of every op, flat segments built by the plain glue
    row["bare"] = {}
    for cfg, build, args, ns in (
            ("single_master", occ_ref.sm_probe_args, sm_args, L1),
            ("partitioned", occ_ref.part_probe_args, (pindex, pk, pd), 1)):
        *flat, _, n_iters = build(*to(args, cpu))
        want = occ_ref.scan_window_plain(*flat, n_slots=ns, n_iters=n_iters)
        fd = to(flat, dev)
        mc = max_cap(args[0])
        got = occ_ops.scan_window(*fd, n_slots=ns, max_cap=mc)
        check(equal(got, want), f"probe (bare, {cfg} shape) differs from "
              f"its plain version")
        row["bare"][cfg] = dict(
            call_figures(lambda: occ_ops.scan_window(
                *fd, n_slots=ns, max_cap=mc)),
            queries=int(flat[2].numel()), n_slots=ns)
    for cfg, fig in [("single_master", row["single_master"]),
                     ("partitioned", row["partitioned"])] + [
            (f"bare {c}", f) for c, f in row["bare"].items()]:
        check(fig["kernels_per_call"] == 1, f"probe ({cfg}): "
              f"{fig['kernels_per_call']} kernels a call")
    row["kernels_per_call"] = 1
    row["crafted_cases"] = probe_cases(dev)


def round_checks(calls, dev, report):
    """The OCC round on the main path's recorded arguments, Silo (the
    row's figures) and Calvin, bit-equal to its plain version on the CPU
    with the lock arrays all B after it, one kernel a call; then rounds
    with no claims and without an index, in both modes."""
    import torch
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    cpu = torch.device("cpu")

    def plain(*a, ix=None, has_claim=None, deterministic=False, lock=None,
              rlock=None):
        out = occ_ref.occ_round_plain(*a, lock,
                                      rlock if deterministic else None,
                                      ix=ix, has_claim=has_claim)
        return (a[0], a[1], *out)

    def with_locks(fn):
        """fn's outputs, then its lock arrays as they are after it"""
        return lambda *a, **k: (*fn(*a, **k), k.get("lock"), k.get("rlock"))

    def checked_round(what, args, kw):
        got = with_locks(occ_ops.occ_round)(*to(args, dev), **to(kw, dev))
        torch.cuda.synchronize()
        want = with_locks(plain)(*to(args, cpu), **to(kw, cpu))
        check(equal(got, want), f"occ_round ({what}) differs from its plain "
              f"version")
        B = args[2].shape[0]
        for t in got[-2:]:
            check(t is None or bool((t == B).all()),
                  f"occ_round ({what}): a lock entry is not B after it")

    args, kw = calls["occ_round"]
    val, tidw, rows, kind, delta_v, wmask, amask, active = args[:8]
    ix, has_claim = kw["ix"], kw["has_claim"]
    B, M = rows.shape
    N, C = val.shape
    K, L = ix["scan_addr"].shape[1], ix["scan_addr"].shape[2]
    v0, t0 = val.to(dev), tidw.to(dev)

    def reset(a):
        """Restore the tables the round installs into."""
        a[0].copy_(v0)
        a[1].copy_(t0)
    n_claim = int(has_claim.sum())
    n_scan = int(ix["scan_valid"].sum())
    n_w = int(wmask.sum())
    # claims: masks read, an atomic and a release a claim; validate: the
    # ops, masks, rows' values, TIDs and locks, the index claims and scan
    # slots (a flag each, address, lock word and TID where it is set),
    # the outputs; install: the winners' values and TIDs written
    nbytes = (B * M * 2 + B * K + (n_w + n_claim) * 8
              + B * M * (4 + 4 + 4 * C) + B * (1 + 8)
              + B * M * (4 * C + 8 + 4) + n_claim * (4 + 8 + 4)
              + B * K * L + n_scan * (4 + 8 + 4)
              + B * (1 + 8) + B * M * (4 * C + 1)
              + n_w * (4 * C + 8))
    nops = B * M * (2 * C + 8) + (n_claim + n_scan) * 4 + (n_w + n_claim) * 2
    row = report("occ_round", with_locks(occ_ops.occ_round),
                 with_locks(plain), args, kw, nbytes=nbytes, nops=nops,
                 reset=reset)
    row["replaces_sites"] = REPLACES_ROUND
    a, k = to(args, dev), to(kw, dev)
    row["silo"] = call_figures(lambda: occ_ops.occ_round(*a, **k),
                               setup=lambda: reset(a))
    kc = dict(kw, deterministic=True, rlock=torch.full_like(kw["lock"], B))
    checked_round("Calvin", args, kc)
    kcd = to(kc, dev)
    row["calvin"] = call_figures(lambda: occ_ops.occ_round(*a, **kcd),
                                 setup=lambda: reset(a))
    for mode in ("silo", "calvin"):
        n = row[mode]["kernels_per_call"]
        check(n == 1, f"occ_round ({mode}): {n} kernels a call")
    row["kernels_per_call"] = 1

    # crafted: a round with no claims; a round without an index
    cases = []
    off = torch.zeros_like(wmask)
    quiet = (*args[:5], off, off, torch.zeros_like(active), *args[8:])
    for det in (False, True):
        mode = "calvin" if det else "silo"
        kq = dict(kw, has_claim=torch.zeros_like(has_claim),
                  deterministic=det, rlock=torch.full_like(kw["lock"], B))
        checked_round(f"{mode}, no claims", quiet, kq)
        lk = torch.full((N + 1,), B, dtype=torch.int32)
        kn = dict(kw, ix=None, has_claim=None, deterministic=det, lock=lk,
                  rlock=lk.clone())
        checked_round(f"{mode}, no index", args, kn)
        cases += [f"{mode}/no_claims", f"{mode}/no_index"]
    row["crafted_cases"] = cases
    print(f"occ_round: Silo and Calvin bit-equal, lock arrays all B, "
          f"{len(cases)} crafted rounds")


def index_merge_cases(dev):
    """index_merge on crafted batches, bit-equal to the plain version on
    the CPU, each through the shared-memory and the global-scratch path
    (``smem_limit=0``) and through the public wrapper: insert keys tied
    with distinct payloads (stability), inserts equal to existing keys,
    double deletes, overflow, empty and all-SENTINEL segments, Kd or Ki 0
    or 1, caps that are not a multiple of the 512-slot tile, negative
    keys, and a sort of 4,500 live inserts.  Returns the case names."""
    import torch
    from repro_torch.kernels.index_merge.ops import (index_merge,
                                                     index_merge_cuda)
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    from repro_torch.storage.index import SENTINEL as S
    gen = torch.Generator().manual_seed(21)
    i32 = torch.int32

    def rnd(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=i32)

    def segs(fill, cap, space, lo=0):
        """sorted segments of distinct keys in [lo, lo + space), fill[p]
        live keys in segment p, the rest canonical free slots"""
        key = torch.full((len(fill), cap), S, dtype=i32)
        for p, n in enumerate(fill):
            ks = torch.randperm(space, generator=gen)[:n].sort().values
            key[p, :n] = (ks + lo).to(i32)
        live = key != S
        prow = torch.where(live, rnd(0, 1 << 20, key.shape), 0)
        tid = torch.where(live, torch.randint(0, 1 << 32, key.shape,
                                              generator=gen), 0)
        return key, prow, tid

    def batch(ik, dk):
        """payloads for inserts ik: prow = a distinct number a column"""
        P, Ki = ik.shape
        ip = torch.arange(P * Ki, dtype=i32).reshape(P, Ki) + 7
        it = torch.randint(0, 1 << 32, (P, Ki), generator=gen)
        live = ik != S
        return dk, ik, torch.where(live, ip, 0), torch.where(live, it, 0)

    def masked(x, frac):
        return torch.where(torch.rand(x.shape, generator=gen) < frac, x, S)

    cases = {}
    # ties: 64 inserts a segment over 6 keys, some of them existing
    k, p, t = segs([100, 150, 40], 300, 400)
    cases["ties"] = (k, p, t, *batch(rnd(0, 6, (3, 64)),
                                     masked(rnd(0, 400, (3, 20)), 0.5)))
    # inserts equal to existing keys (side="right": existing first)
    k, p, t = segs([120, 200, 60], 300, 1000)
    ik = k.gather(1, rnd(0, 60, (3, 48)).long())
    cases["equal_existing"] = (k, p, t, *batch(masked(ik, 0.8),
                                               rnd(0, 1000, (3, 10))))
    # double deletes: existing keys deleted twice, absent keys, masked
    k, p, t = segs([250, 90, 299], 300, 2000)
    dk = k.gather(1, rnd(0, 90, (3, 40)).long())
    dk = torch.cat([dk, dk[:, :15], rnd(0, 2000, (3, 10))], 1)
    cases["double_deletes"] = (k, p, t, *batch(
        masked(rnd(0, 2000, (3, 30)), 0.5), masked(dk, 0.9)))
    # overflow: n_live + n_ins > cap
    k, p, t = segs([295, 300, 10], 300, 5000)
    cases["overflow"] = (k, p, t, *batch(rnd(0, 5000, (3, 60)),
                                         masked(rnd(0, 5000, (3, 8)), 0.5)))
    # an empty segment, all-SENTINEL inserts, all-SENTINEL deletes
    k, p, t = segs([0, 80, 80], 300, 500)
    ik = rnd(0, 500, (3, 32))
    ik[1] = S
    dk = k.gather(1, rnd(0, 80, (3, 12)).long())
    dk[2] = S
    cases["empty_and_sentinel"] = (k, p, t, *batch(ik, dk))
    # Kd or Ki 0 and 1 (the reference pads those itself)
    k, p, t = segs([30, 5], 40, 100)
    for nd, ni in ((0, 9), (7, 0), (1, 1), (0, 0)):
        dk = k.gather(1, rnd(0, 5, (2, nd)).long())
        cases[f"kd{nd}_ki{ni}"] = (k, p, t, *batch(rnd(0, 100, (2, ni)),
                                                   dk))
    # caps around the tile: 5, 256, 513 slots
    for cap in (5, 256, 513):
        k, p, t = segs([cap // 2, cap - 1], cap, 4 * cap)
        cases[f"cap{cap}"] = (k, p, t, *batch(
            masked(rnd(0, 4 * cap, (2, 24)), 0.7),
            k.gather(1, rnd(0, cap // 2 + 1, (2, 6)).long())))
    # negative keys and a large sort (4,500 live inserts of 5,000)
    k, p, t = segs([2000, 3500], 8000, 1 << 20, lo=-(1 << 19))
    cases["large_sort"] = (k, p, t, *batch(
        masked(rnd(-(1 << 19), 1 << 19, (2, 5000)), 0.9),
        k.gather(1, rnd(0, 2000, (2, 300)).long())))
    for name, case in cases.items():
        want = index_merge_unsorted_plain(*case)
        a = to(case, dev)
        for lim in (None, 0):
            kw = {} if lim is None else {"smem_limit": lim}
            check(equal(index_merge_cuda(*a, **kw), want),
                  f"index_merge case {name} (smem_limit={lim}) differs "
                  f"from its plain version")
        check(equal(index_merge(*a), want),
              f"index_merge case {name}: the wrapper differs")
    print(f"index_merge: {len(cases)} crafted cases bit-equal, in shared "
          f"memory and in global scratch")
    return list(cases)


def kernel_checks(calls, dev):
    """Parity, timing and bound of every kernel on its recorded arguments.
    Returns {name: report} (launches filled in later)."""
    import torch
    from repro_torch.kernels.index_merge import ops as im_ops
    from repro_torch.kernels.index_merge.ops import index_merge_cuda
    from repro_torch.kernels.index_merge.ref import index_merge_unsorted_plain
    cpu = torch.device("cpu")
    out = {}

    def report(name, kernel, plain, args, kw, nbytes, nops,
               plain_is_library=False, reset=None):
        """kernel/plain: callables on (*args, **kw) -> result tree; the
        kernel on copies on the card, the plain version on copies on the
        CPU.  ``plain_is_library``: the plain version is itself the one
        PyTorch call that computes the function, so its time is also the
        library time.  ``reset(args)`` restores inputs a call updates in
        place before each timed call."""
        got = kernel(*to(args, dev), **to(kw, dev))
        torch.cuda.synchronize()
        want = plain(*to(args, cpu), **to(kw, cpu))
        check(equal(got, want), f"{name}: kernel differs from its plain "
              f"version")
        err = max_abs_err(got, want)
        ka, pa, kd = to(args, dev), to(args, dev), to(kw, dev)
        ms = cuda_ms(lambda: kernel(*ka, **kd),
                     setup=reset and (lambda: reset(ka)))
        plain_ms = cuda_ms(lambda: plain(*pa, **kd),
                           setup=reset and (lambda: reset(pa)))
        lib_ms = plain_ms if plain_is_library else None
        pm = prof_ms(lambda: kernel(*ka, **kd),
                     setup=reset and (lambda: reset(ka)))[0]
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = nops / H100_INT32_OPS_PER_S * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "prof_ms": pm, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": lib_ms, "bytes": int(nbytes), "ops": int(nops)}
        return out[name]

    # -- the probe and the round: every configuration on its recorded
    # arguments, the crafted cases, one kernel a call
    probe_checks(calls, dev, report)
    round_checks(calls, dev, report)

    # -- index_merge at both phases' shapes, inserts unsorted as the
    # executors hand them over; the scratch path on the same arguments
    im = {}
    for key in ("index_merge/part", "index_merge/sm"):
        args, kw = calls[key]
        want = index_merge_unsorted_plain(*to(args, cpu))
        check(equal(index_merge_cuda(*to(args, dev)), want),
              f"{key} differs from its plain version")
        check(equal(index_merge_cuda(*to(args, dev), smem_limit=0), want),
              f"{key} (global scratch) differs from its plain version")
        P, cap = args[0].shape
        Kd, Ki = args[3].shape[1], args[4].shape[1]
        lg = max(cap, Ki).bit_length()
        im[key] = dict(args=args, nbytes=P * cap * 16 * 2
                       + P * (Kd * 4 + Ki * 16 + 4),
                       nops=P * (Kd + Ki + 2 * cap) * lg * 3,
                       shape=[P, cap, Kd, Ki])
    sm = im["index_merge/sm"]
    report("index_merge", index_merge_cuda, index_merge_unsorted_plain,
           sm["args"], {}, nbytes=sm["nbytes"], nops=sm["nops"])
    row = out["index_merge"]
    for key, r in im.items():
        a = to(r["args"], dev)
        ms = cuda_ms(lambda: index_merge_cuda(*a))
        sg = cuda_ms(lambda: sort_gather(*a[4:]))
        b = max(r["nbytes"] / H100_BYTES_PER_S,
                r["nops"] / H100_INT32_OPS_PER_S) * 1e3
        n = kernels_in(lambda: im_ops.index_merge(*a))
        check(n <= 2, f"{key}: one call launched {n} kernels")
        row[key.split("/")[1]] = {"shape_P_cap_Kd_Ki": r["shape"], "ms": ms,
                                  "bound_ms": b, "sort_gather_ms": sg,
                                  "kernels_per_call": n}
    row["kernels_per_call"] = row["sm"]["kernels_per_call"]
    row["crafted_cases"] = index_merge_cases(dev)

    # -- thomas_merge on the epoch's single-master value stream, read in
    # place, then through the bare entry and on crafted streams
    thomas_checks(calls, dev, report)
    return out


def thomas_cases(dev):
    """thomas_merge on crafted streams, each bit-equal to its plain version
    on the CPU: an empty stream (K = 0), every row -1, every write to one
    row under one TID (the last wins), TIDs at or below the rows' (none
    wins), TIDs at 2^32 - 1, an odd C and a C of 20 (word copies), and two
    calls back to back on one table.  Returns the case names."""
    import torch
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
    gen = torch.Generator().manual_seed(29)
    N, C, K = 4096, 10, 3000
    i32 = torch.int32
    val = torch.randint(-99, 99, (N, C), generator=gen, dtype=i32)
    tid = torch.randint(0, 1000, (N,), generator=gen)
    tid[:8] = 2**32 - 2
    vals = torch.randint(-2**31, 2**31 - 1, (K, C), generator=gen, dtype=i32)

    def rows(hi, n=K):
        return torch.randint(-1, hi, (n,), generator=gen, dtype=i32)

    def tids(lo, hi, n=K):
        return torch.randint(lo, hi, (n,), generator=gen)
    top = tids(0, 2)
    top = torch.where(top == 1, 2**32 - 1, 2**32 - 2)
    cases = {
        "empty": (val, tid, rows(N, 0), vals[:0], tids(0, 9, 0)),
        "all skipped": (val, tid, torch.full((K,), -1, dtype=i32), vals,
                        tids(0, 2000)),
        "one row, one TID": (val, tid, torch.full((K,), 77, dtype=i32), vals,
                             torch.full((K,), 5000)),
        "stale": (val, tid, rows(N), vals, tids(0, 1)),
        "top TID": (val, tid, rows(16), vals, top),
        "odd C": (val[:, :3].contiguous(), tid, rows(64),
                  vals[:, :3].contiguous(), tids(0, 1500)),
        "many writes a row": (val, tid, rows(40), vals, tids(0, 1500)),
        "wide C": (val.repeat(1, 2), tid, rows(N), vals.repeat(1, 2),
                   tids(0, 1500)),
    }
    for what, (v, t, r, wv, wt) in cases.items():
        want = thomas_merge_plain(v.clone(), t.clone(), r, wv, wt)
        got = thomas_merge(*to((v, t, r, wv, wt), dev))
        torch.cuda.synchronize()
        check(equal(got, want), f"thomas_merge {what}: kernel differs from "
              f"its plain version")
    got = thomas_merge(*to(cases["one row, one TID"], dev))
    check(got[0][77].tolist() == vals[-1].tolist() and int(got[1][77]) == 5000,
          "thomas_merge: of equal TIDs the last write did not win")
    # back to back on one table: the second call sees the first's table,
    # not its scratch
    a, b = cases["many writes a row"], cases["top TID"]
    want = thomas_merge_plain(val.clone(), tid.clone(), *a[2:])
    want = thomas_merge_plain(*want, *b[2:])
    d = to((val, tid), dev)
    thomas_merge(*d, *to(a[2:], dev))
    got = thomas_merge(*d, *to(b[2:], dev))
    torch.cuda.synchronize()
    check(equal(got, want), "thomas_merge: two calls back to back differ "
          "from the plain version")
    return list(cases) + ["back to back"]


def thomas_checks(calls, dev, report):
    """thomas_merge on the warm epoch's single-master log as the engine
    hands it to ``thomas_apply_batch`` (the log's flattened views), then
    through the bare entry on the same stream, then on crafted streams;
    one kernel a call under torch.profiler, and the aten operators and
    host time of ``thomas_apply_batch``."""
    import torch
    from repro_torch.core import replication
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
    (val, tidw, lg), _ = calls["thomas_apply_batch"]
    C = val.shape[1]
    log = to({k: lg[k] for k in ("row", "val", "tid")}, dev)
    # the stream the kernel reads: the log's flattened views
    args = (val, tidw, lg["row"].reshape(-1), lg["val"].reshape(-1, C),
            lg["tid"].reshape(-1))
    wrows = args[2]
    Kw = wrows.numel()
    a_dev = to(args, dev)
    thomas_merge(*a_dev)
    n_win = int((a_dev[1] != tidw).sum())
    n_live = int((wrows >= 0).sum())
    tid0 = tidw.to(dev)

    def reset(a):
        """Restore the TID column (values rewritten are the same)."""
        a[1].copy_(tid0)
    # every row id; a live write's TID and its row's TID; a winner's
    # values read and written and its TID written
    row = report("thomas_merge", thomas_merge, thomas_merge_plain, args, {},
                 nbytes=Kw * 4 + n_live * (8 + 8)
                 + n_win * (4 * C + 4 * C + 8),
                 nops=Kw + n_live * 3, reset=reset)
    # the log as the engine hands it over, through thomas_apply_batch
    check(equal(replication.thomas_apply_batch(*to((val, tidw), dev), log),
                thomas_merge_plain(*to(args, torch.device("cpu")))),
          "thomas_apply_batch differs from the plain version")
    row["crafted_cases"] = thomas_cases(dev)
    n = kernels_in(lambda: replication.thomas_apply_batch(a_dev[0], a_dev[1],
                                                          log))
    check(n == 1, f"thomas_apply_batch: one call launched {n} kernels")
    fig = call_figures(
        lambda: replication.thomas_apply_batch(a_dev[0], a_dev[1], log),
        setup=lambda: reset(a_dev))
    row.update(log_shape=list(lg["row"].shape), writes=Kw, live=n_live,
               winners=n_win, kernels_per_call=n,
               apply_batch={k: fig[k] for k in ("prof_kernels_per_call",
                                                "aten_calls", "host_us")})


def profile_epoch(eng, cfg, state):
    """One more main-path epoch under torch.profiler: the card's busy time
    (sum of kernel self times) against the epoch's wall time, and the
    kernels that take most of it.  Runs after the measured epochs, so its
    overhead touches none of their numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.db import tpcc
    b = tpcc.make_batch(cfg, state, MAIN_TXNS, seed=MAIN_EPOCHS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = eng.run_epoch(b)
        wall = time.perf_counter() - t0
    check(eng.replica_consistent(), "profiled epoch: replica diverged")
    tpcc.apply_consume_feedback(state, b, m)
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    if busy == 0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "top_kernels": [[k[:80], us / 1e3, n] for us, k, n in rows[:10]]}


# ---------------------------------------------------------------------------
# phase 8: the online transaction service on the card
# ---------------------------------------------------------------------------
STAR_KERNELS = ("scan_window", "occ_round", "index_merge", "thomas_merge")


def by_kernel(counts):
    """Launch counts summed per kernel over its launch configurations
    (``<name>.<config>``)."""
    return {k: sum(n for c, n in counts.items()
                   if c == k or c.startswith(k + ".")) for k in STAR_KERNELS}


def serve_checked(svc, duration_s, feedback_state=None):
    """``svc.run(duration_s)`` with ``replica_consistent()`` checked at
    every fence and every batch run recorded (a copy, with the epoch's
    commit masks), the kernels' launch counts set to 0 just before and
    read just after.  Returns (summary with the engine's epoch split over
    the run added, records, launches by configuration,
    kernel_launch_counts() over the run)."""
    import copy
    import torch
    from repro_torch.kernels import _build
    from repro_torch.obs.trace import kernel_launch_counts
    eng = svc.engine
    run_epoch = eng.run_epoch
    records = []

    def checked(batch, ingest=None):
        b = copy.deepcopy(batch)
        m = run_epoch(batch, ingest=ingest)
        check(eng.replica_consistent(), f"service: replica diverged at "
              f"fence {eng.committed_epoch}")
        records.append((b, {k: m[k].copy() for k in ("p_committed",
                                                     "c_committed")}))
        return m
    eng.run_epoch = checked
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}
    torch.cuda.synchronize()
    before = kernel_launch_counts()
    _build.reset_launch_counts()
    try:
        out = svc.run(duration_s=duration_s)
    finally:
        eng.run_epoch = run_epoch
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    after = kernel_launch_counts()
    wrapper = {k: after[k] - before.get(k, 0) for k in after
               if after[k] != before.get(k, 0)}
    for c in svc.clients:
        if hasattr(c, "shutdown"):
            c.shutdown()
    # the engine's split of the run's epochs (warm-up included: its
    # epochs run inside svc.run before the clock starts)
    out["engine_split"] = {f: getattr(eng.stats, f) - stats0[f]
                           for f in split}
    return out, records, launches, wrapper


def service_figures(out, launches, wrapper, wall):
    keys = ("throughput_txn_s", "p50_ms", "p99_ms", "p999_ms", "mean_ms",
            "committed", "user_aborted", "epochs", "offered", "admitted",
            "shed", "backpressured", "rerouted", "starved_requeues",
            "max_part_depth", "max_master_depth", "ingest_overlap_s",
            "epoch_time_s", "engine_split")
    fig = {k: out[k] for k in keys}
    fig.update(wall_s=wall, launches=launches,
               launches_by_kernel=by_kernel(launches),
               kernel_launch_counts=wrapper)
    return fig


def replay_card_vs_cpu(records, make, n, what, dev):
    """A service run's batches, the warm-up's empty ones included, up to
    its ``n``-th non-empty one, replayed through a fresh engine on the card
    and one on the CPU (``make(device)`` builds each): master and replica
    bit-equal after every epoch, indexes included, the commit masks equal
    to each other and to the service run's."""
    import copy
    import numpy as np
    live = np.cumsum([b["n_single"] + b["n_cross"] > 0 for b, _ in records])
    check(live.size and live[-1] >= n, f"{what}: the service formed only "
          f"{int(live[-1]) if live.size else 0} non-empty batches")
    upto = int(np.searchsorted(live, n)) + 1
    sides = [make(d) for d in (dev, "cpu")]
    for i, (b, want) in enumerate(records[:upto]):
        ms = [e.run_epoch(copy.deepcopy(b)) for e in sides]
        g, h = sides
        check(same_store(g.store, h.store)
              and same_store(g.replica_store, h.replica_store),
              f"{what} replay: card and CPU differ after epoch {i}")
        for k in ("p_committed", "c_committed"):
            check(np.array_equal(ms[0][k], ms[1][k])
                  and np.array_equal(ms[0][k], want[k]),
                  f"{what} replay: {k} differs at epoch {i}")
    print(f"service replay: {what}'s first {upto} epochs ({n} non-empty) "
          f"bit-equal on the card and the CPU")
    return n


def service_path(dev):
    """Phase 8: ``TxnService`` on the card — the three scenarios of
    examples/serve_txn.py on YCSB at the paper's scale (the steady one
    with durability, then ``recover_full`` on the card), and TPC-C's full
    mix at the main path's scale, each of the steady and TPC-C runs'
    batches replayed card against CPU.  Returns (figures, {kernel:
    launches by run})."""
    import tempfile
    from pathlib import Path as _P
    import torch
    from repro_torch.core.engine import StarEngine
    from repro_torch.db import tpcc, ycsb
    from repro_torch.db.wal import Durability, recover_full
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService, YCSBSource)
    base = ycsb.YCSBConfig(n_partitions=YCSB_P)
    skew = ycsb.YCSBConfig(n_partitions=YCSB_P, zipf_theta=0.9)
    print(f"service path: YCSB P={base.n_partitions} x "
          f"{base.records_per_partition} records, {ycsb.C} int32 columns, "
          f"{ycsb.M} ops, cross {base.cross_ratio}; slots "
          f"{SERVICE_SLOTS}, lanes {SERVICE_LANES}")
    figures, launches = {}, {}
    wal = {}
    for name, cfg, rate, process, caps in (
            ("steady", base, 1500.0, "poisson", (256, 512)),
            ("burst_zipf", skew, 1000.0, "bursty", (256, 512)),
            ("overload", base, 30_000.0, "poisson", (64, 128))):
        tmp = tempfile.TemporaryDirectory() if name == "steady" else None
        dur = (Durability(tmp.name, n_workers=4, checkpoint_every=4)
               if tmp else None)
        eng = StarEngine(cfg.n_partitions, cfg.records_per_partition,
                         durability=dur, device=dev)
        client = OpenLoopClient(YCSBSource(cfg, seed=1), rate_txn_s=rate,
                                process=process, seed=7)
        svc = TxnService(eng, [client], AdmissionConfig(*caps, "shed"),
                         slots_per_partition=SERVICE_SLOTS,
                         master_lanes=SERVICE_LANES)
        t0 = time.perf_counter()
        out, records, ln, wr = serve_checked(svc, SERVICE_S)
        fig = service_figures(out, ln, wr, time.perf_counter() - t0)
        fig.update(offered_rate_txn_s=rate, process=process,
                   part_cap=caps[0], master_cap=caps[1])
        figures[name] = fig
        launches[f"ycsb_{name}"] = fig["launches_by_kernel"]
        print(f"service {name}: {out['throughput_txn_s']:.1f} txn/s, p50 "
              f"{out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms, "
              f"{out['committed']} committed in {out['epochs']} epochs, "
              f"shed {out['shed']}, launches {fig['launches_by_kernel']}")
        check(out["committed"] > 0, f"service {name}: nothing committed")
        for k in ("occ_round", "thomas_merge"):
            check(fig["launches_by_kernel"][k] > 0,
                  f"service {name}: {k} never launched")
        if name == "overload":
            check(out["shed"] > 0, "overload: nothing shed")
            check(out["max_part_depth"] <= caps[0]
                  and out["max_master_depth"] <= caps[1],
                  "overload: a queue grew past its cap")
        if dur is not None:
            d = _P(tmp.name)
            dur.close()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rv, rt, rix, e_c = recover_full(d, device=dev)
            torch.cuda.synchronize()
            t_rec = time.perf_counter() - t0
            snap = eng.store.snapshot
            check(rix is None and torch.equal(rv, snap["val"])
                  and torch.equal(rt, snap["tid"]),
                  "recover_full on the card differs from the committed "
                  "state")
            wal = {"entries": dur.entries_logged,
                   "checkpoints": dur.checkpoints,
                   "wal_bytes": sum(f.stat().st_size
                                    for f in d.glob("wal_*.log")),
                   "checkpoint_bytes": sum(f.stat().st_size
                                           for f in d.glob("ckpt_*")),
                   "recovered_from_epoch": e_c,
                   "committed_epoch": eng.committed_epoch,
                   "recover_full_s": t_rec}
            print(f"durability: {wal['entries']} entries, "
                  f"{wal['wal_bytes']} log bytes, {wal['checkpoints']} "
                  f"checkpoints; recover_full on the card in {t_rec:.3f} s "
                  f"bit-equal to the committed state")
            tmp.cleanup()
            steady = records
        del eng, svc, records
        torch.cuda.empty_cache()
    replayed = {"ycsb_steady": replay_card_vs_cpu(
        steady, lambda d: StarEngine(base.n_partitions,
                                     base.records_per_partition, device=d),
        SERVICE_REPLAY, "steady", dev)}
    del steady

    # TPC-C's full mix through the service at the main path's scale
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m))
    t0 = time.perf_counter()
    out, records, ln, wr = serve_checked(svc, SERVICE_TPCC_S)
    fig = service_figures(out, ln, wr, time.perf_counter() - t0)
    fig.update(offered_rate_txn_s=SERVICE_TPCC_RATE,
               index_overflow=eng.stats.index_overflow,
               consume_skips=eng.stats.consume_skips)
    figures["tpcc_full"] = fig
    launches["tpcc_full"] = fig["launches_by_kernel"]
    print(f"service tpcc_full: {out['throughput_txn_s']:.1f} txn/s, p50 "
          f"{out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms, "
          f"{out['committed']} committed in {out['epochs']} epochs, "
          f"launches {fig['launches_by_kernel']}")
    check(out["committed"] > 0, "service tpcc_full: nothing committed")
    for k in STAR_KERNELS:
        check(fig["launches_by_kernel"][k] > 0,
              f"service tpcc_full: {k} never launched")
    for c in ("scan_window.partitioned", "scan_window.single_master"):
        check(ln.get(c, 0) > 0 and wr.get(c, 0) > 0,
              f"service tpcc_full: {c} never launched")
    del eng, svc
    torch.cuda.empty_cache()
    # the TPC-C batches replayed card against CPU: the probe in both
    # phases, index_merge, occ_round with the index and thomas_merge held
    # against their plain versions at the service's shapes
    replayed["tpcc_full"] = replay_card_vs_cpu(
        records, lambda d: mk_engine(MAIN, 0, d)[2], SERVICE_TPCC_REPLAY,
        "tpcc_full", dev)
    del records
    torch.cuda.empty_cache()

    # the WAL with the ordered indexes: recover_full replays the index
    # chunks on the card through index_merge
    with tempfile.TemporaryDirectory() as d:
        dur = Durability(d, n_workers=2, checkpoint_every=3)
        cfg, state, eng = mk_engine(FIG11, 0, dev, durability=dur)
        for ep in range(SERVICE_WAL_EPOCHS):
            b = tpcc.make_batch(cfg, state, FIG11_TXNS, seed=ep)
            tpcc.apply_consume_feedback(state, b, eng.run_epoch(b))
        dur.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rv, rt, rix, e_c = recover_full(d, device=dev)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        check(same_store({"val": rv, "tid": rt, "indexes": rix},
                         eng.store.snapshot),
              "recover_full (TPC-C, indexes) on the card differs from the "
              "committed state")
        wal["tpcc_indexes"] = {"epochs": SERVICE_WAL_EPOCHS,
                               "recovered_from_epoch": e_c,
                               "entries": dur.entries_logged,
                               "recover_full_s": t_rec}
        print(f"durability with indexes: {SERVICE_WAL_EPOCHS} fig11 "
              f"epochs, recover_full on the card from epoch {e_c} in "
              f"{t_rec:.3f} s bit-equal, indexes included")
        del eng
    return {"ycsb": {"n_partitions": base.n_partitions,
                     "records_per_partition": base.records_per_partition,
                     "cols": ycsb.C, "ops": ycsb.M,
                     "cross_ratio": base.cross_ratio},
            "slots_per_partition": SERVICE_SLOTS,
            "master_lanes": SERVICE_LANES, "duration_s": SERVICE_S,
            "tpcc_duration_s": SERVICE_TPCC_S, "scenarios": figures,
            "wal": wal, "replayed_card_vs_cpu": replayed}, launches


# ---------------------------------------------------------------------------
# phase 9: the read tier and the analytics lane
# ---------------------------------------------------------------------------
def shape_figures(kernel, plain, args, kw, nbytes, nops, reset=None):
    """One recorded call of a kernel wrapper at a new call shape: bit-equal
    to its plain version on CPU copies, both timed on the card (CUDA
    events; the kernel also by torch.profiler, one kernel a call), the
    bound from this call's bytes and operations."""
    import torch
    cpu = torch.device("cpu")
    dev = next(t.device for t in tree_leaves(args) if hasattr(t, "device"))
    got = kernel(*to(args, dev), **kw)
    torch.cuda.synchronize()
    want = plain(*to(args, cpu), **kw)
    ka, pa = to(args, dev), to(args, dev)
    setup_k = reset and (lambda: reset(ka))
    setup_p = reset and (lambda: reset(pa))
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = nops / H100_INT32_OPS_PER_S * 1e3
    return {"equal": equal(got, want), "max_abs_err": max_abs_err(got, want),
            "ms": cuda_ms(lambda: kernel(*ka, **kw), setup=setup_k),
            "prof_ms": prof_ms(lambda: kernel(*ka, **kw), setup=setup_k)[0],
            "kernels_per_call": kernels_in(lambda: kernel(*ka, **kw)),
            "plain_ms": cuda_ms(lambda: plain(*pa, **kw), setup=setup_p),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations", "library_ms": None,
            "bytes": int(nbytes), "ops": int(nops)}


def read_kernel_checks(calls, kernels):
    """The read executor's first ``scan_window`` call and the views' first
    ``thomas_merge`` call (phase 9's new call shapes), each against its
    plain version and timed; the figures go into the kernels' rows."""
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.kernels.occ.ops import scan_window
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain

    (fk, ft, q, base, cap), kw = calls["read/scan_window"]
    Q, ns = int(q.numel()), kw["n_slots"]
    lg = int(kw["max_cap"]).bit_length()

    def plain_probe(*a, n_slots, max_cap):
        return occ_ref.scan_window_plain(
            *a, n_slots=n_slots, n_iters=int(max_cap).bit_length() + 1)
    # each query's key, segment start and length read, its position and
    # window (keys and TIDs) written, the keys of its binary search read
    fig = shape_figures(scan_window, plain_probe, (fk, ft, q, base, cap),
                        kw, nbytes=Q * (12 + 4 + 12 * ns + 4 * lg),
                        nops=Q * (4 + lg + 8 * ns))
    check(fig.pop("equal"), "read executor's scan_window call differs from "
          "its plain version")
    check(fig["kernels_per_call"] == 1, f"read scan_window: "
          f"{fig['kernels_per_call']} kernels a call")
    fig.update(queries=Q, n_slots=ns, segment=int(kw["max_cap"]),
               table_slots=int(fk.numel()))
    kernels["scan_window"]["read_executor"] = fig

    (val, tidw, rows, vals, tids), _ = calls["views/thomas_merge"]
    C, Kw = int(val.shape[1]), int(rows.numel())
    a_dev = to((val, tidw, rows, vals, tids), val.device)
    thomas_merge(*a_dev)
    n_win = int((a_dev[1] != tidw).sum())
    n_live = int((rows >= 0).sum())
    tid0 = tidw.clone()

    def reset(a):
        """Restore the TID column (values rewritten are the same)."""
        a[1].copy_(tid0)
    fig = shape_figures(thomas_merge, thomas_merge_plain,
                        (val, tidw, rows, vals, tids), {},
                        nbytes=Kw * 4 + n_live * (8 + 8)
                        + n_win * (4 * C + 4 * C + 8),
                        nops=Kw + n_live * 3, reset=reset)
    check(fig.pop("equal"), "views' thomas_merge call differs from its "
          "plain version")
    check(fig["kernels_per_call"] == 1, f"views thomas_merge: "
          f"{fig['kernels_per_call']} kernels a call")
    fig.update(rows=int(val.shape[0]), cols=C, writes=Kw, live=n_live,
               winners=n_win)
    kernels["thomas_merge"]["views_master"] = fig


def read_path(dev, kernels):
    """Phase 9: TPC-C's full mix at phase 4's scale through ``TxnService``
    with the read tier (bound 2, the replica view refreshed every 2nd
    fence) and the analytics lane, at phase 8's rate for phase 8's
    duration; then ``READ_DIRECT_EPOCHS`` epochs on the same engine whose
    read-only transactions are served after their fence at bound 2.  At
    every fence: ``replica_consistent()``, the views' committed projection
    equal to the master snapshot's ``VIEW_COLS``, and (after the run) the
    stamped aggregates equal to ``recompute`` of that fence's committed
    values.  The first ``READ_SNAPSHOTS`` distinct (replica, epoch)
    snapshots served in each part: each retained snapshot equal to its
    fence, and each group's outputs equal to ``reference_read`` and to the
    CPU executor on a host copy.  Returns the ``read_path`` figures; the
    STAR kernels' rows gain ``read_launches`` and the new call shapes."""
    import numpy as np
    import torch
    from repro_torch.changelog import VIEW_COLS, AnalyticsLane
    from repro_torch.changelog import views as views_mod
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    from repro_torch.reads import (ReadTier, SnapshotReadExecutor,
                                   reference_read)
    from repro_torch.reads import executor as ex_mod
    from repro_torch.storage.engine import FIELDS
    from repro_torch.service import (AdmissionConfig, AdmissionController,
                                     OpenLoopClient, TPCCSource, TxnService)
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    tier = ReadTier(max_staleness_epochs=READ_K,
                    sec_refresh_every=READ_REFRESH)
    lane = AnalyticsLane(cfg)
    views = lane.views
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m), read_tier=tier, analytics=lane)
    print(f"read path: TPC-C P={cfg.n_partitions} with ReadTier(k={READ_K}"
          f", sec_refresh_every={READ_REFRESH}) and AnalyticsLane at "
          f"{SERVICE_TPCC_RATE:.0f} txn/s for {SERVICE_TPCC_S} s")

    # the lanes' own launches (the executor's probes, the views' merges),
    # and their first calls recorded
    lane_launches = {k: 0 for k in STAR_KERNELS}
    rec = Recorder()

    def count(module, name, kernel):
        orig = getattr(module, name)

        def counted(*a, **k):
            n0 = _build.launch_counts().get(kernel, 0)
            out = orig(*a, **k)
            lane_launches[kernel] += _build.launch_counts().get(kernel, 0) \
                - n0
            return out
        setattr(module, name, counted)
        rec._undo.append((module, name, orig))
    count(ex_mod, "scan_window", "scan_window")
    count(views_mod, "thomas_apply", "thomas_merge")
    rec.wrap(ex_mod, "scan_window", lambda *a, **k: "read/scan_window")
    rec.wrap(views_mod, "thomas_apply", lambda *a, **k: "views/thomas_merge")

    # every fence: the replica, the views' committed projection; the
    # committed values kept (on the card) for recompute after the run
    fences = {}
    run_epoch = eng.run_epoch

    def fenced(batch, ingest=None):
        m = run_epoch(batch, ingest=ingest)
        e = eng.committed_epoch
        check(eng.replica_consistent(), f"read path: replica diverged at "
              f"fence {e}")
        if views.attached:
            snap = eng.store.snapshot
            check(torch.equal(views._c_proj,
                              snap["val"][..., list(VIEW_COLS)])
                  and torch.equal(views._c_ptid, snap["tid"]),
                  f"read path: the views' committed projection differs "
                  f"from the master snapshot at fence {e}")
            stamp_e, aggs = views.latest()
            check(stamp_e == e, f"read path: views stamped {stamp_e} at "
                  f"fence {e}")
            fences[e] = (aggs, snap["val"].clone())
        return m
    eng.run_epoch = fenced

    # every served group: freshness within the bound; the first
    # READ_SNAPSHOTS distinct snapshots of each part kept with the groups
    # served from them (their inputs copied before the pool reuses them)
    part = {"name": "service"}
    kept = {}
    freshness = []
    serve = tier.serve

    def served(admission, now_s=0.0, limit=None, mid_epoch=False):
        res = serve(admission, now_s, limit, mid_epoch)
        pool = admission.pool
        for r in res:
            freshness.append(r["freshness"])
            check(r["freshness"] <= (0 if mid_epoch else READ_K),
                  f"read path: a read served at freshness {r['freshness']}")
            key = (part["name"], r["replica"], r["epoch"])
            mine = [k for k in kept if k[0] == part["name"]]
            if key not in kept and len(mine) >= READ_SNAPSHOTS:
                continue
            ent = tier.catalog.entries[r["replica"]]
            snap = next(s for e, s, _ in ent.snaps if e == r["epoch"])
            sl = r["slots"]
            kept.setdefault(key, (snap, []))[1].append((
                ent.row_of_partition[pool.home[sl].astype(np.int64)],
                pool.row[sl].copy(), pool.kind[sl].copy(),
                pool.delta[sl].copy(), r["out"]))
        return res
    tier.serve = served

    # the lanes' host time outside the executor (which its stats time):
    # the views' stream callbacks, the catalog's stamps, the query mix
    lane_s = {}

    def timed(obj, name, key):
        f = getattr(obj, name)

        def t(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                lane_s[key] = lane_s.get(key, 0.0) + time.perf_counter() - t0
        setattr(obj, name, t)
    for name in ("on_slab", "on_master", "on_commit"):
        timed(views, name, f"views.{name}")
    timed(tier, "observe_epoch", "reads.observe_epoch")
    timed(lane, "serve", "analytics.serve")
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = svc.run(duration_s=SERVICE_TPCC_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run_launches = by_kernel(_build.launch_counts())
        read_launches = dict(lane_launches)
        lane_host_s = dict(lane_s)
        engine_split = {f: getattr(eng.stats, f) - stats0[f] for f in split}
        merges, batches = views.master_merges, tier.stats.batches
        for c in svc.clients:
            if hasattr(c, "shutdown"):
                c.shutdown()
        print(f"read path service: {out['throughput_txn_s']:.1f} write "
              f"txn/s p50 {out['p50_ms']:.2f} p99 {out['p99_ms']:.2f} ms; "
              f"{out['read_served']} reads ({out['read_mid_epoch_served']} "
              f"mid-epoch) p50 {out['read_p50_ms']:.2f} p99 "
              f"{out['read_p99_ms']:.2f} ms; {out['epochs']} epochs; "
              f"lane launches {read_launches}")

        # reads served after their fence at bound READ_K: the epochs'
        # read-only transactions offered to the read lane after each fence
        part["name"] = "after_fence"
        direct = {"epochs": READ_DIRECT_EPOCHS, "txns": READ_DIRECT_TXNS,
                  "offered": 0, "served": 0, "by_freshness": {}}
        served0, fallbacks0 = tier.stats.served, tier.stats.fallbacks
        for ep in range(READ_DIRECT_EPOCHS):
            raw = tpcc.make_raw(cfg, state, READ_DIRECT_TXNS,
                                np.random.default_rng(900 + ep))
            batch = tpcc.make_batch(cfg, state, 0, raw=raw)
            m = eng.run_epoch(batch)
            tpcc.apply_consume_feedback(state, batch, m)
            tier.observe_epoch(eng, m)
            lane.serve(eng.committed_epoch)
            sel = np.nonzero(raw["read_only"])[0]
            if not sel.size:
                continue
            adm = AdmissionController(cfg.n_partitions,
                                      cfg.rows_per_partition,
                                      max_ops=raw["rows"].shape[1],
                                      n_cols=raw["deltas"].shape[2],
                                      read_lane=True)
            req = {k: raw[k][sel] for k in ("parts", "rows", "kinds",
                                            "deltas", "user_abort", "home",
                                            "read_only")}
            n = sel.size
            req.update(txn_id=np.arange(n, dtype=np.int64),
                       tenant=np.zeros(n, np.int32), arrival_s=np.zeros(n))
            check(not adm.offer(req, 0.0).any(), "read path: the read "
                  "lane refused a read")
            direct["offered"] += n
            for r in tier.serve(adm):
                f = r["freshness"]
                direct["by_freshness"][f] = \
                    direct["by_freshness"].get(f, 0) + int(r["slots"].size)
        direct["served"] = tier.stats.served - served0
        direct["fallbacks"] = tier.stats.fallbacks - fallbacks0
        check(direct["served"] + direct["fallbacks"] == direct["offered"]
              and direct["served"] > 0, "read path: reads after the fence "
              "were dropped or none served")
    finally:
        # drop the instance attributes the wrappers were set as: a bound
        # method put back on its own object would keep it (and the
        # snapshots it holds) alive in a reference cycle
        rec.restore()
        for obj, names in ((eng, ("run_epoch",)), (tier, ("serve",
                                                          "observe_epoch")),
                           (lane, ("serve",)),
                           (views, ("on_slab", "on_master", "on_commit"))):
            for n in names:
                vars(obj).pop(n, None)

    s = tier.stats
    check(s.stale_violations == 0, f"read path: {s.stale_violations} "
          f"stale reads")
    check(out["read_mid_epoch_served"] > 0, "read path: no read served "
          "mid-epoch")
    check(max(freshness) <= READ_K, "read path: a read past the bound")
    for k in ("scan_window", "thomas_merge"):
        check(read_launches[k] > 0, f"read path: the lanes never launched "
              f"{k}")
    n_idx = len(eng.store.indexes)
    check(read_launches["scan_window"] <= batches * n_idx,
          "read path: more than one probe launch per index per group")
    check(read_launches["thomas_merge"] == merges, "read path: the views' "
          "master merges are not one launch each")
    for k, row in kernels.items():
        row["read_launches"] = read_launches.get(k, 0)

    # the stamps against recompute of each fence's committed values
    for e, (aggs, val) in sorted(fences.items()):
        want = views.recompute(val)
        check(all(np.array_equal(aggs[k], want[k])
                  and aggs[k].dtype == want[k].dtype for k in want),
              f"read path: the views' stamp differs from recompute at "
              f"fence {e}")
    # the kept snapshots: each equal to its fence, each group's outputs
    # equal to reference_read and the CPU executor on a host copy
    cpu_exec = SnapshotReadExecutor()
    n_groups = 0
    for (pn, rid, e), (snap, groups) in kept.items():
        check(e not in fences or torch.equal(snap["val"], fences[e][1]),
              f"read path: the retained snapshot {rid}@{e} changed after "
              f"its fence")
        host = {"val": snap["val"].cpu(), "tid": snap["tid"].cpu(),
                "idx": [{f: ix[f].cpu() for f in FIELDS}
                        for ix in snap["idx"]]}
        for arow, rows, kinds, deltas, got in groups:
            want = reference_read(host, arow, rows, kinds, deltas)
            cpu = cpu_exec.run(host, arow, rows, kinds, deltas)
            check(equal(got, cpu) and all(
                np.array_equal(got[k].cpu().numpy(), want[k])
                for k in want), f"read path: a group served from "
                  f"{rid}@{e} differs from reference_read")
            n_groups += 1
    check(sum(1 for k in kept if k[0] == "service") > 0
          and sum(1 for k in kept if k[0] == "after_fence") > 0,
          "read path: no snapshot kept in one of the parts")

    # the new call shapes against their plain versions, timed
    read_kernel_checks(rec.calls, kernels)

    # a fence's snapshot copies: one view's arrays cloned, timed
    view = eng.read_views()[0]
    arrays = [view["val"], view["tid"]] + [ix[f] for ix in view["idx"]
                                           for f in FIELDS]
    copy_ms = cuda_ms(lambda: [a.clone() for a in arrays], reps=10)
    view_bytes = sum(a.numel() * a.element_size() for a in arrays)
    n_fences = len(fences)
    copies = tier.catalog.stamp_copies
    n_obs = 1 + out["epochs"] + READ_DIRECT_EPOCHS   # observe_epoch calls
    # the dirty gate's host copy of a slab's write set
    M = client.source.M
    w = torch.zeros((cfg.n_partitions, SERVICE_SLOTS, M), dtype=torch.bool,
                    device=dev)
    gate_us = host_us(lambda: w.any(2).any(1).cpu().numpy(), reps=50)
    fig = {k: out[k] for k in (
        "read_served", "read_txn_s", "read_p50_ms", "read_p99_ms",
        "read_fallbacks", "read_max_freshness", "read_mid_epoch_served",
        "read_mid_epoch_deferred", "read_serve_time_s",
        "read_stale_violations", "read_by_replica", "ingest_overlap_s",
        "epoch_time_s", "epochs", "committed", "user_aborted",
        "analytics_q_p50_ms", "analytics_q_p99_ms", "analytics_serves",
        "analytics_mv_slabs", "analytics_mv_writes")}
    fig.update(
        write_txn_s=out["throughput_txn_s"], write_p50_ms=out["p50_ms"],
        write_p99_ms=out["p99_ms"], write_p999_ms=out["p999_ms"],
        read_post_fence_served=out["read_served"]
        - out["read_mid_epoch_served"],
        read_batches=batches, wall_s=wall, offered_rate_txn_s=SERVICE_TPCC_RATE,
        duration_s=SERVICE_TPCC_S, max_staleness_epochs=READ_K,
        sec_refresh_every=READ_REFRESH,
        launches_by_kernel=run_launches, read_launches=read_launches,
        lane_host_s=lane_host_s, engine_split=engine_split,
        views_master_merges=merges, fences_checked=n_fences,
        snapshots_checked=len(kept), groups_checked=n_groups,
        after_fence=direct,
        snapshot_copy={"bytes_per_view": view_bytes,
                       "ms_per_view": copy_ms, "copies": copies,
                       "observed_fences": n_obs,
                       "bytes_per_fence": tier.catalog.stamp_bytes / n_obs,
                       "ms_per_fence": copy_ms * copies / n_obs,
                       "retain": tier.catalog.retain},
        dirty_gate_host_us=gate_us)
    print(f"read path: {n_fences} fences checked (views = master "
          f"VIEW_COLS, stamps = recompute), {len(kept)} snapshots and "
          f"{n_groups} groups bit-equal to reference_read; after the fence "
          f"{direct['served']} of {direct['offered']} reads served "
          f"{direct['by_freshness']}; snapshot copy {view_bytes} bytes "
          f"{copy_ms:.3f} ms a view")
    del eng, svc, tier, lane, views, fences, kept, rec, client
    gc.collect()
    torch.cuda.empty_cache()
    return fig


# ---------------------------------------------------------------------------
# phases 5-7: the LM serving path (Hymba-1.5B)
# ---------------------------------------------------------------------------
def allclose_err(got, want, tol):
    """(max abs difference of two tensor trees, whether every element is
    within ``tol + tol * |want|``): each tolerance is atol = rtol."""
    import torch
    err = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.float(), w.float()
        check(g.shape == w.shape, f"shape {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite output")
        d = (g - w).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if not bool((d <= tol + tol * w.abs()).all()):
            return err, False
    return err, True


def record_generate(eng, prompts, n):
    """``eng.generate(prompts, n)`` with the first main-path call of each
    LM kernel wrapper recorded (a copy of its arguments)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers, mamba2
    rec = Recorder()

    def norm_key(x, w, residual=None, **kw):
        """norm2 at prefill and decode shapes; gate_norm at prefill."""
        T = x.numel() // x.shape[-1]
        if residual is not None:
            return "rmsnorm/prefill" if T > SERVE_BATCH else "rmsnorm/decode"
        if x.shape[-1] == eng.cfg.d_inner and T > SERVE_BATCH:
            return "rmsnorm/gate"
        return None
    rec.wrap(layers, "rmsnorm", norm_key)
    rec.wrap(fa_ops, "attention", lambda q, *a, **k:
             "flash/prefill" if q.shape[1] > 1 else "flash/decode")
    rec.wrap(mamba2, "ssd", lambda *a, **k: "ssd")
    try:
        eng.generate(prompts, n)
    finally:
        rec.restore()
    return rec.calls


def flash_sweep(fa_ops, attention_ref, dev):
    """Both flash-attention configurations against their plain version on
    small shapes that reach every branch of the kernel: f32 (1e-5: both
    sum in f32, in another order) and bf16 (2e-2), every head dim, lengths
    that are not multiples of the 64-row tiles, causal, windowed and
    bidirectional masks, a regular GQA map and Hymba's padded one (32
    query heads over 7 kv heads), more query heads on one kv head than a
    decode pass keeps (16 over 1), rings with empty slots, rows that see
    no key (the mean of v), decode over one and several slot splits."""
    import torch
    gen = torch.Generator().manual_seed(11)
    hymba = [min(h // 5, 6) for h in range(32)]

    def ring(Sk, pos):
        """slot positions of a ring of Sk slots after writing 0..pos"""
        sp = torch.full((Sk,), -1, dtype=torch.int32)
        for p in range(max(0, pos + 1 - Sk), pos + 1):
            sp[p % Sk] = p
        return sp
    ar = lambda n, off=0: torch.arange(off, off + n, dtype=torch.int32)
    # (B, H, Hkv, kv_head, q_pos, k_pos, causal, window)
    cases = [
        (2, 4, 2, None, ar(100), ar(100), True, None),
        (1, 32, 7, hymba, ar(150), ar(150), True, 40),
        (2, 4, 2, None, ar(70), ar(130), False, None),
        # keys start at 10 and some slots are empty: queries 0-9 see none
        (1, 32, 7, hymba, ar(70),
         torch.where(ar(130) % 7 == 3, -1, ar(130, 10)), True, 48),
        (3, 8, 2, None, ar(1, 299), ring(300, 299), True, None),
        (2, 32, 7, hymba, ar(1, 1500), ring(1000, 1500), True, 256),
        (2, 16, 1, None, ar(1, 50), ring(64, 50), True, 24),
        (2, 32, 7, hymba, ar(1, 5), ar(200, 10), True, None),  # sees none
        (1, 8, 4, None, ar(1, 10), ring(90, 80), False, None),
    ]
    worst = {}
    for dtype, tol in ((torch.float32, TOL_F32_FLASH),
                       (torch.bfloat16, TOL_BF16_FLASH)):
        for D in fa_ops.HEAD_DIMS:
            for B, H, Hkv, kvh, qp, kp, causal, window in cases:
                Sq, Sk = qp.shape[0], kp.shape[0]
                q, k, v = (torch.randn((B, S, n, D), generator=gen).to(
                    dev, dtype) for S, n in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
                args = (q, k, v, qp.to(dev), kp.to(dev))
                kw = dict(causal=causal, window=window, kv_head=kvh)
                got = fa_ops.attention(*args, **kw)
                want = attention_ref(*args, **kw)
                torch.cuda.synchronize()
                err, ok = allclose_err(got, want, tol)
                what = (f"flash sweep {dtype} D={D} B={B} H={H}/{Hkv} "
                        f"Sq={Sq} Sk={Sk} causal={causal} window={window}")
                check(ok, f"{what}: kernel differs from its plain version "
                      f"by {err} (tolerance {tol})")
                key = f"{str(dtype)[6:]} {'decode' if Sq == 1 else 'prefill'}"
                worst[key] = max(worst.get(key, 0.0), err)
    print("flash sweep: " + ", ".join(f"{k} max abs err {e:.3g}"
                                      for k, e in worst.items()))
    return worst


def ssd_sweep(ssd, ssd_ref, dev):
    """The SSD kernel against its plain version on small shapes at
    TOL_SSD_SWEEP: P in {16, 32, 64} x N in {8, 16, 128} x chunk in
    {16, 64, 256} x heads in {1, 3}, each with S = chunk + 37 (not a
    multiple of the chunk) and logd near 0 (-|n|/100), as in
    tests/test_kernels.py (-|n|/5) and strongly negative (-4|n| - 1), so
    every block width (P 16, 32, 64) and both forms of C's fragments (N up
    to 32 in registers, N 128 from shared memory); an unaligned shape
    (P 6, N 5: the 4-byte copy path); N 256 (the one-stage load ring); and
    Mamba2-130M's widths (P 64, N 128) at 2,048 tokens; a 16 x 512 state,
    which no block holds, must be refused.  The
    plain version runs in float64 on the same inputs: its float32
    sequential recurrence drifts from float64 by more than the bound over
    a few hundred weakly decaying steps, more than the kernel does, so in
    float32 it could not tell a fault from its own rounding.  Returns the
    largest difference."""
    import torch
    gen = torch.Generator().manual_seed(13)
    decays = {"near0": (0.01, 0.0), "moderate": (0.2, 0.0),
              "strong": (4.0, 1.0)}
    cases = [(P, N, chunk, heads, d, chunk + 37)
             for P in (16, 32, 64) for N in (8, 16, 128)
             for chunk in (16, 64, 256) for heads in (1, 3) for d in decays]
    cases += [(6, 5, 16, 1, "moderate", 77),
              (32, 256, 64, 1, "moderate", 101),
              (64, 128, 256, 1, "moderate", 2048)]
    worst = 0.0
    for P, N, chunk, heads, d, S in cases:
        BH = 6
        scale, shift = decays[d]
        xdt = torch.randn((BH, S, P), generator=gen)
        logd = -(torch.randn((BH, S), generator=gen).abs() * scale + shift)
        Bv, Cv = (torch.randn((BH // heads, S, N), generator=gen)
                  for _ in range(2))
        args = [t.to(dev) for t in (xdt, logd, Bv, Cv)]
        got = ssd(*args, chunk=chunk, heads=heads)
        want = ssd_ref(*[t.double() for t in args], heads=heads)
        torch.cuda.synchronize()
        err, ok = allclose_err(got, want, TOL_SSD_SWEEP)
        check(ok, f"ssd sweep P={P} N={N} chunk={chunk} heads={heads} "
              f"logd {d} S={S}: kernel differs from its plain "
              f"version by {err} (tolerance {TOL_SSD_SWEEP})")
        worst = max(worst, err)
    big = [t.to(dev) for t in (torch.zeros((1, 8, 16)), torch.zeros((1, 8)),
                               torch.zeros((1, 8, 512)),
                               torch.zeros((1, 8, 512)))]
    try:
        ssd(*big, chunk=8)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "ssd: a 16 x 512 state, which no block holds, ran")
    print(f"ssd sweep: {len(cases)} shapes, max abs err {worst:.3g} "
          f"(tolerance atol = rtol = {TOL_SSD_SWEEP})")
    return worst


def rmsnorm_sweep(dev):
    """rmsnorm against its plain version on the same card inputs at T in
    RMS_SWEEP_ROWS (1 to 16,384, with the kernel's threshold between its
    two forms and one row past it) x D in RMS_SWEEP_WIDTHS, bf16
    (TOL_BF16_NORM) and float32 (TOL_F32_NORM), with and without a
    residual: both forms of the kernel, the register form at 1 to 4
    vectors a thread and the shared-memory form in both vector widths
    (D = 1,601 is not a multiple of 8) and past 48 KB of shared memory
    (D = 12,288).  Returns the largest difference by dtype."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator().manual_seed(17)
    worst = {}
    n = 0
    for dtype, tol in ((torch.bfloat16, TOL_BF16_NORM),
                       (torch.float32, TOL_F32_NORM)):
        for T in RMS_SWEEP_ROWS:
            for D in RMS_SWEEP_WIDTHS:
                x, r = (torch.randn((T, D), generator=gen).to(dev, dtype)
                        for _ in range(2))
                w = torch.randn((D,), generator=gen).to(dev, dtype)
                for res in (r, None):
                    got = rmsnorm(x, w, res)
                    want = rmsnorm_ref(x, w, res)
                    torch.cuda.synchronize()
                    err, ok = allclose_err(got, want, tol)
                    check(ok, f"rmsnorm sweep {dtype} T={T} D={D} "
                          f"residual={res is not None}: kernel differs from "
                          f"its plain version by {err} (tolerance {tol})")
                    key = str(dtype)[6:]
                    worst[key] = max(worst.get(key, 0.0), err)
                    n += 1
                del x, r, w, got, want
    torch.cuda.empty_cache()
    print(f"rmsnorm sweep: {n} cases, " + ", ".join(
        f"{k} max abs err {e:.3g}" for k, e in worst.items()))
    return worst


def norm_chain(rmsnorm, y, s, w, W, eps):
    """RMS_CHAIN Hymba decode blocks' worth of the norm, an (8 x D) x (D x
    D) matmul and the norm again, each on the one before it; ``rmsnorm``
    None: the matmuls alone."""
    for _ in range(RMS_CHAIN):
        if rmsnorm is not None:
            y, s = rmsnorm(y, w, s, eps=eps)
        y = y @ W
        if rmsnorm is not None:
            y, s = rmsnorm(y, w, s, eps=eps)
    return y


def rmsnorm_decode(call):
    """rmsnorm at the decode shape (the recorded norm2 call: T = 8, D =
    1,600, bf16, with a residual): device time by CUDA events and by
    torch.profiler, and a chain that mirrors one Hymba decode block (the
    norm, an (8 x 1,600) x (1,600 x 1,600) bf16 matmul, the norm again,
    RMS_CHAIN times; beside it the same matmuls alone) by CUDA events; the
    wrapper's kernels, aten operators and host time a call; beside the
    bound and F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    (x, w, r), kw = call
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    eps = kw.get("eps", 1e-5)
    x2, r2 = x.reshape(T, D), r.reshape(T, D)
    gen = torch.Generator(device=x.device).manual_seed(19)
    W = (torch.randn((D, D), generator=gen, device=x.device)
         / D ** 0.5).to(x.dtype)
    out = {"rows": T, "width": D,
           "bound_ms": x.element_size() * (4 * T * D + D)
           / H100_BYTES_PER_S * 1e3,
           "chain_ms": cuda_ms(lambda: norm_chain(rmsnorm, x2, r2, w, W,
                                                  eps)),
           "chain_matmuls_only_ms": cuda_ms(lambda: norm_chain(
               None, x2, r2, w, W, eps))}
    out.update(call_figures(lambda: rmsnorm(x, w, r, **kw)))
    s = (x.float() + r.float()).to(x.dtype)
    out.update(rms_norm_ms=cuda_ms(lambda: F.rms_norm(s, (D,), w, eps)),
               add_rms_norm_ms=cuda_ms(lambda: F.rms_norm(x + r, (D,), w,
                                                          eps)))
    return out


def lm_kernel_checks(calls):
    """Parity (against the plain version on the same card inputs), timing
    and bound of the three LM kernels on their recorded arguments."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         visible)
    from repro_torch.kernels.mamba2_ssd.ops import ssd
    from repro_torch.kernels.mamba2_ssd.ref import ssd_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    def report(name, kernel, plain, args, kw, tol, nbytes, nflops, rate,
               library=None):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err, ok = allclose_err(got, want, tol)
        check(ok, f"{name}: kernel differs from its plain version by {err} "
              f"(tolerance {tol})")
        del got, want
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=5)
        lib_ms = None if library is None else cuda_ms(library)
        b_bytes = nbytes / H100_BYTES_PER_S * 1e3
        b_ops = nflops / rate * 1e3
        return {"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "tolerance": tol, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "library_ms": lib_ms, "bytes": int(nbytes),
                "flops": int(nflops)}

    rows = {}
    # -- rmsnorm, residual form at the prefill shape (norm2: T=16,384,
    # D=1,600).  bf16: the outputs may differ by one rounding step of
    # bf16 (2^-8 relative) where the two sums of squares, taken in another
    # order, straddle a rounding boundary: tolerance 1e-2.
    (x, w, r), kw = calls["rmsnorm/prefill"]
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    es = x.element_size()
    rows["rmsnorm"] = report(
        "rmsnorm", rmsnorm, rmsnorm_ref, (x, w, r), kw, TOL_BF16_NORM,
        nbytes=es * (4 * T * D + D), nflops=5 * T * D, rate=H100_F32_FLOPS)
    # no single PyTorch call adds the residual and normalises: F.rms_norm
    # is timed on the pre-added sum (half the bytes) and after its add
    eps = kw.get("eps", 1e-5)
    s = (x.float() + r.float()).to(x.dtype)
    rows["rmsnorm"].update(
        library_note="none: no single call adds the residual and normalises",
        rms_norm_ms=cuda_ms(lambda: F.rms_norm(s, (D,), w, eps)),
        add_rms_norm_ms=cuda_ms(lambda: F.rms_norm(x + r, (D,), w, eps)))
    del s
    # the other two forms on the path: no residual (gate_norm, D=3,200)
    # and the decode shape (T=8), where most of its launches are
    for key in ("rmsnorm/gate", "rmsnorm/decode"):
        args, kw = calls[key]
        err, ok = allclose_err(rmsnorm(*args, **kw), rmsnorm_ref(*args, **kw),
                               TOL_BF16_NORM)
        check(ok, f"{key}: kernel differs from its plain version by {err}")
    rows["rmsnorm"]["sweep_max_abs_err"] = rmsnorm_sweep(x.device)
    rows["rmsnorm"]["decode"] = rmsnorm_decode(calls["rmsnorm/decode"])
    # -- flash attention.  bf16 in, f32 scores and sums; the kernel rounds
    # the unnormalised probabilities to bf16 and the plain version the
    # normalised ones: tolerance 2e-2, tests/test_kernels.py's bf16 bound.
    # K and V are the unexpanded (B, Sk, 7, 64) tensors, read through the
    # head map; bytes count them once, operations the visible pairs.
    sweep = flash_sweep(fa_ops, attention_ref,
                        calls["flash/prefill"][0][0].device)

    def flash_row(key, name):
        (q, k, v, qp, kp), kw = calls[key]
        B, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        mask = visible(qp, kp, causal=kw["causal"], window=kw["window"])
        pairs = int(mask.sum())
        idx = torch.tensor(kw["kv_head"], device=q.device)
        qt = q.transpose(1, 2)

        def expand():
            return (k.index_select(2, idx).transpose(1, 2),
                    v.index_select(2, idx).transpose(1, 2))
        kt, vt = expand()
        row = report(
            name, fa_ops.attention, attention_ref, (q, k, v, qp, kp), kw,
            TOL_BF16_FLASH,
            nbytes=q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * Hkv
                                       * D) + 4 * (Sq + Sk + H),
            nflops=4 * B * H * pairs * D, rate=H100_BF16_FLOPS,
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        row["expand_ms"] = cuda_ms(expand)
        return row
    rows["flash_attention"] = flash_row("flash/prefill", "flash_attention")
    rows["flash_attention"]["sweep_max_abs_err"] = sweep
    dec = flash_row("flash/decode", "flash_attention")
    rows["flash_attention"]["decode"] = {
        k: dec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms",
                            "expand_ms", "bytes", "flops")}

    # -- ssd.  f32 throughout; the kernel's chunked sums (3xTF32 products)
    # against the sequential recurrence over 2,048 steps: tolerance 1e-3;
    # first a sweep of small shapes at tests/test_kernels.py's 1e-4.
    sweep = ssd_sweep(ssd, ssd_ref, calls["ssd"][0][0].device)
    (xdt, logd, Bv, Cv), kw = calls["ssd"]
    BH, S, P = xdt.shape
    N, heads = Bv.shape[-1], kw["heads"]

    def ssd_flops(Q):
        """flops of the chunked scan at chunk Q: the pairs on or below
        each chunk's diagonal (C B^T and the product with X) and the
        state's two products"""
        pairs = Q * (Q + 1) // 2
        return BH * (S // Q) * (2 * pairs * (N + P) + 4 * Q * P * N)
    nbytes = 4 * (2 * BH * S * P + BH * S + 2 * (BH // heads) * S * N
                  + BH * P * N)
    # the kernel runs chunks of at most 64 tokens, each product as three
    # TF32 products
    flops = ssd_flops(min(kw["chunk"], 64))
    rows["mamba2_ssd"] = report(
        "mamba2_ssd", ssd, lambda *a, chunk, heads: ssd_ref(*a, heads=heads),
        (xdt, logd, Bv, Cv), kw, TOL_SSD, nbytes=nbytes, nflops=3 * flops,
        rate=H100_TF32_FLOPS)
    # the earlier float32-SIMT design's yardstick: the requested chunk's
    # products in f32 FMAs
    rows["mamba2_ssd"].update(
        bound_f32_simt_ms=max(nbytes / H100_BYTES_PER_S,
                              ssd_flops(kw["chunk"]) / H100_F32_FLOPS) * 1e3,
        sweep_max_abs_err=sweep)
    return rows


def serve_parity(dev):
    """Hymba at full width, depth cut to 2 layers, float32: one 2,048-token
    prompt and 8 decode steps on the card (kernels) and on the CPU (plain
    versions), the same token fed to both at each step.  Returns the
    largest logit difference."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=PARITY_LAYERS,
                              dtype="float32")
    cpu = tf.LM(cfg, seed=0, device="cpu")
    card = tf.LM(cfg, seed=0, device=dev)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    alloc = SERVE_PROMPT + PARITY_DECODE
    worst = 0.0
    with torch.inference_mode():
        lc, cc = tf.prefill(cpu, {"tokens": prompt}, cfg, alloc_len=alloc)
        lg, cg = tf.prefill(card, {"tokens": prompt.to(dev)}, cfg,
                            alloc_len=alloc)
        for step in range(PARITY_DECODE + 1):
            err, ok = allclose_err(lg.cpu(), lc, TOL_SERVE)
            worst = max(worst, err)
            check(ok, f"serve parity: card and CPU logits differ by {err} "
                  f"at step {step} (tolerance {TOL_SERVE})")
            if step == PARITY_DECODE:
                break
            tok = lc[:, -1].argmax(-1)[:, None].to(torch.int32)
            lc, cc = tf.decode_step(cpu, cc, tok, cfg)
            lg, cg = tf.decode_step(card, cg, tok.to(dev), cfg)
    return worst


def profile_device(fn):
    """Run ``fn()`` under torch.profiler: (wall s, {kernel: (device ms,
    calls)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            per[e.key[:80]] = (us / 1e3, e.count)
    return wall, per


def serve_path(dev):
    """Phases 5-7.  Returns (kernel rows, serve_path figures)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine, ServeStats
    expand = fa_ref.expand_kv

    # ---- 5. LM kernels on the serve path's own arguments ---------------
    t0 = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    eng = ServeEngine(cfg, LM(cfg, seed=0, device=dev), device=dev,
                      max_len=SERVE_PROMPT + SERVE_GEN)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    calls = record_generate(eng, prompts, 2)
    print(f"serve warm-up: {cfg.name}, {SERVE_BATCH} x {SERVE_PROMPT} "
          f"tokens + 2, in {time.perf_counter() - t0:.1f} s (set-up "
          f"included)")
    rows = lm_kernel_checks(calls)
    del calls
    torch.cuda.empty_cache()
    print("LM kernel parity, max abs err (tolerance atol = rtol): " +
          ", ".join(f"{k} {r['max_abs_err']:.3g} ({r['tolerance']})"
                    for k, r in rows.items()))

    # ---- 6. serve parity, card against CPU ------------------------------
    t0 = time.perf_counter()
    worst = serve_parity(dev)
    print(f"serve parity: {PARITY_LAYERS}-layer full-width {cfg.name}, f32,"
          f" prefill {SERVE_PROMPT} + {PARITY_DECODE} decode steps: max "
          f"logit difference {worst:.3g} (tol {TOL_SERVE}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 7. the serve path, measured ------------------------------------
    # an untimed generate first: the phases above emptied the allocator's
    # cache, and the first prefill after that pays for its allocations
    eng.generate(prompts, 2)
    runs = []
    expansions = []          # calls of the plain version's K/V expansion
    fa_ref.expand_kv = lambda *a, **k: expansions.append(1) or expand(*a,
                                                                      **k)
    for i in range(SERVE_RUNS):
        eng.stats = ServeStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        if i == 0:
            # the counts where this generate's prefill ends, at its first
            # synchronise
            sync, at_prefill = eng._sync, []

            def marked_sync():
                sync()
                if not at_prefill:
                    at_prefill.append(_build.launch_counts())
            eng._sync = marked_sync
        out = eng.generate(prompts, SERVE_GEN)
        vars(eng).pop("_sync", None)
        fa_ref.expand_kv = expand
        runs.append(dataclasses.replace(eng.stats))
        if i == 0:       # the counts and the checks of one generate
            counts = _build.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check(tuple(out.shape) == (SERVE_BATCH, SERVE_GEN)
                  and out.dtype == torch.int32,
                  "serve: output shape or type")
            check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                  "serve: a token outside the vocabulary")
    st = sorted(runs, key=lambda r: r.prefill_s + r.decode_s)[len(runs) // 2]
    L = cfg.n_layers
    need = {"flash_attention.prefill": L,
            "flash_attention.decode": L * SERVE_GEN,
            "mamba2_ssd": L,
            "rmsnorm": (5 * L + 1) * (SERVE_GEN + 1)}
    for k, n in need.items():
        check(counts.get(k, 0) >= n, f"serve: {k} launched "
              f"{counts.get(k, 0)} times, expected >= {n}")
    for k in ("flash_attention.prefill", "flash_attention.decode"):
        check(counts.get(k, 0) == need[k], f"serve: {k} launched "
              f"{counts.get(k, 0)} times, expected one a layer a step")
    check(not expansions, "serve: K/V were expanded on the serve path")
    rows["rmsnorm"]["launches"] = counts.get("rmsnorm", 0)
    n_pre = at_prefill[0].get("rmsnorm", 0)
    rows["rmsnorm"]["launches_prefill"] = n_pre
    rows["rmsnorm"]["launches_decode"] = rows["rmsnorm"]["launches"] - n_pre
    rows["mamba2_ssd"]["launches"] = counts.get("mamba2_ssd", 0)
    fl = rows["flash_attention"]
    fl["decode"]["launches"] = counts.get("flash_attention.decode", 0)
    fl["prefill_launches"] = counts.get("flash_attention.prefill", 0)
    fl["launches"] = fl["prefill_launches"] + fl["decode"]["launches"]
    for r in runs:
        print(f"serve: {SERVE_BATCH} x {SERVE_PROMPT} prefill in "
              f"{r.prefill_s:.3f} s, {SERVE_GEN} decode steps in "
              f"{r.decode_s:.3f} s")

    # where the time goes: a prefill alone, then a prefill and 8 decode
    # steps, under the profiler; decode = the difference
    pw, pre = profile_device(lambda: eng.generate(prompts, 0))
    dw, both = profile_device(lambda: eng.generate(prompts, PROFILE_STEPS))
    dec = {k: ((ms - pre.get(k, (0, 0))[0]) / PROFILE_STEPS,
               (n - pre.get(k, (0, 0))[1]) / PROFILE_STEPS)
           for k, (ms, n) in both.items()}

    def top(per, wall_ms):
        busy = sum(ms for ms, _ in per.values())
        return {"wall_ms": wall_ms, "device_busy_ms": busy,
                "busy_share": busy / wall_ms if wall_ms else None,
                "top_kernels": [[k, ms, n] for k, (ms, n) in sorted(
                    per.items(), key=lambda kv: -kv[1][0])[:8]]}
    figures = {
        "arch": cfg.name, "dtype": cfg.dtype, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
        "prefill_s": st.prefill_s,
        "prefill_tokens_per_s": st.prefill_tokens / st.prefill_s,
        "decode_ms_per_step": st.decode_s / st.decode_steps * 1e3,
        "decode_tokens_per_s": st.decoded_tokens / st.decode_s,
        "runs": [[r.prefill_s, r.decode_s / r.decode_steps * 1e3]
                 for r in runs],
        "peak_mem_gb": peak / 1e9, "launches": {
            k: counts.get(k, 0) for k in need},
        "parity_max_logit_err": worst,
        "profiled_prefill": top(pre, pw * 1e3),
        "profiled_decode_step": top(dec, (dw - pw) / PROFILE_STEPS * 1e3)}
    del eng
    torch.cuda.empty_cache()
    return rows, figures


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if argv[:1] == ["--ab-side"] and len(argv) == 2:
        root = Path(argv[1]).resolve()
    elif argv[:1] in (["--ab"], ["--lanes"]) and len(argv) == 2:
        pass
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--ab"]:
        return ab(root, Path(argv[1]).resolve())
    sys.path.insert(0, str(root / "src"))
    if argv[:1] == ["--lanes"]:
        return lanes_ab(torch.device("cuda", 0), int(argv[1]))
    if argv:
        ab_side(root, torch.device("cuda", 0))
        return 0
    return run(torch.device("cuda", 0))


def launch_floor(dev):
    """The card's time for the least kernel, a one-element ``fill_``: (ms
    a launch by torch.profiler, ms by CUDA events as :func:`cuda_ms`
    times every kernel here)."""
    import torch
    x = torch.zeros(1, device=dev)

    def fill():
        x.fill_(1.0)
    return prof_ms(fill, reps=200)[0], cuda_ms(fill)


def run(dev):
    import torch
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    # float32 stays float32 on the card (the plain versions' products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1. build + device ----------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} CUDA sources in "
          f"{time.perf_counter() - t0:.1f} s")
    smi = nvidia_smi()
    print(smi)

    floor, floor_ev = launch_floor(dev)
    print(f"launch floor: a one-element fill_ kernel takes {floor:.6f} ms "
          f"(torch.profiler), {floor_ev:.6f} ms (CUDA events)")
    kernels, main_path = star_phases(dev)
    main_path.update(device=name, nvidia_smi=smi, launch_floor_prof_ms=floor,
                     launch_floor_events_ms=floor_ev)
    torch.cuda.empty_cache()
    service, svc_launches = service_path(dev)
    service.update(device=name, nvidia_smi=smi)
    for k, row in kernels.items():
        row["service_launches"] = {r: n[k] for r, n in svc_launches.items()}
    torch.cuda.empty_cache()
    reads = read_path(dev, kernels)
    reads.update(device=name, nvidia_smi=smi)
    lm_rows, serve = serve_path(dev)
    lm_rows["rmsnorm"]["decode"].update(launch_floor_prof_ms=floor,
                                        launch_floor_events_ms=floor_ev)
    kernels.update(lm_rows)
    serve.update(device=name, nvidia_smi=smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"main_path": main_path}))
    print(json.dumps({"service_path": service}))
    print(json.dumps({"read_path": reads}))
    print(json.dumps({"serve_path": serve}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def star_phases(dev):
    """Phases 2-4 (the STAR epoch).  Returns (kernel rows, main-path
    figures)."""
    from repro_torch.db import tpcc

    # ---- 2. kernels at main-path shapes ---------------------------------
    t0 = time.perf_counter()
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    print(f"main path: P={cfg.n_partitions} rows/partition="
          f"{cfg.rows_per_partition} index cap={cfg.index_capacity}")
    batches = [tpcc.make_batch(cfg, state, MAIN_TXNS, seed=1000)]
    m, calls = record_warm_epoch(eng, batches[0])
    tpcc.apply_consume_feedback(state, batches[0], m)
    check(eng.replica_consistent(), "warm epoch: replica diverged")
    print(f"warm epoch: committed {m['committed_single']}+"
          f"{m['committed_cross']} in {time.perf_counter() - t0:.1f} s "
          f"(set-up included)")
    kernels = kernel_checks(calls, dev)
    del calls
    print("kernel parity: all bit-equal")

    # ---- 3. engine parity, card vs CPU ----------------------------------
    sides = [mk_engine(FIG11, 0, d) for d in (dev, "cpu")]
    for ep in range(FIG11_EPOCHS):
        ms = []
        for c, st, e in sides:
            b = tpcc.make_batch(c, st, FIG11_TXNS, seed=ep)
            ms.append(e.run_epoch(b))
            tpcc.apply_consume_feedback(st, b, ms[-1])
        (_, _, g), (_, _, h) = sides
        check(same_store(g.store, h.store)
              and same_store(g.replica_store, h.replica_store),
              f"engine parity: card and CPU differ after epoch {ep}")
        check(g.replica_consistent() and h.replica_consistent(),
              f"engine parity: replica diverged at epoch {ep}")
        check(ms[0]["committed_cross"] == ms[1]["committed_cross"],
              "engine parity: commit counts differ")
    print(f"engine parity: {FIG11_EPOCHS} epochs of the fig11 full mix "
          f"bit-equal on the card and the CPU")
    del sides

    # ---- 4. the main path, measured ---------------------------------------
    for ep in range(MAIN_EPOCHS):
        batches.append(tpcc.make_batch(cfg, state, MAIN_TXNS, seed=ep))
    counts, figures = measure_epochs(eng, cfg, state, batches[1:])
    check(figures["lock_arrays_checked"] > 0, "main path: no lock array "
          "reached occ_round")
    for k, row in kernels.items():
        # a kernel's launch configurations count as "<name>.<config>"
        row["launches"] = sum(n for c, n in counts.items()
                              if c == k or c.startswith(k + "."))
        check(row["launches"] > 0, f"main path never launched {k}")
    sw = kernels["scan_window"]
    sw["launches_by_config"] = {c: counts.get(c, 0) for c in (
        "scan_window.partitioned", "scan_window.single_master",
        "scan_window")}
    for c in ("scan_window.partitioned", "scan_window.single_master"):
        check(counts.get(c, 0) > 0, f"main path never launched {c}")
    return kernels, figures


def measure_epochs(eng, cfg, state, batches):
    """Phase 4's measurement: ``batches`` run as epochs, with
    ``replica_consistent()`` at every fence and every lock array the
    executor hands to ``occ_round`` all B after them, then one more epoch
    under torch.profiler.  Returns (the kernels' launch counts over the
    measured epochs, main-path figures)."""
    import torch
    from repro_torch.core import single_master
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    base = {f: getattr(eng.stats, f) for f in
            ("committed_cross", "index_overflow", "consume_skips", "retries",
             "fence_time_s")}

    def measured(f):
        """A stats counter over the measured epochs only."""
        return getattr(eng.stats, f) - base[f]
    # keep the lock arrays the executor hands to occ_round (a tree whose
    # round takes none hands none): each must be all B after the epochs
    held = {}
    orig = single_master.occ_round

    def keep(*a, **k):
        for t in (k.get("lock"), k.get("rlock")):
            if t is not None:
                held[t.data_ptr()] = (t, a[2].shape[0])
        return orig(*a, **k)
    single_master.occ_round = keep
    _build.reset_launch_counts()
    rows = []
    try:
        for b in batches:
            t0 = time.perf_counter()
            m = eng.run_epoch(b)
            wall = time.perf_counter() - t0
            ok = eng.replica_consistent()
            tpcc.apply_consume_feedback(state, b, m)
            rows.append((m, wall, ok))
            print(f"epoch {eng.epoch - 1}: committed "
                  f"{m['committed_single']}+{m['committed_cross']} "
                  f"t_part={m['t_part_s']:.4f}s t_sm={m['t_sm_s']:.4f}s "
                  f"wall={wall:.4f}s index_overflow={m['index_overflow']} "
                  f"consume_skips={measured('consume_skips')} replica={ok}")
            check(ok, "main path: replica diverged at a fence")
    finally:
        single_master.occ_round = orig
    counts = _build.launch_counts()
    n_locks = len(held)
    for t, B in held.values():
        check(bool((t == B).all()), "main path: a lock array is not all B "
              "after the measured epochs")
    del held
    check(measured("committed_cross") > 0, "main path: no cross commit")
    totals = {f: measured(f) for f in base}
    prof = profile_epoch(eng, cfg, state)
    committed = sum(m["committed_single"] + m["committed_cross"]
                    for m, _, _ in rows)
    wall = sum(w for _, w, _ in rows)
    return counts, {
        "epochs": len(batches), "txns_per_epoch": MAIN_TXNS,
        "committed": committed, "committed_txn_per_s": committed / wall,
        "t_part_s": sum(m["t_part_s"] for m, _, _ in rows),
        "t_sm_s": sum(m["t_sm_s"] for m, _, _ in rows),
        "t_fence_s": totals["fence_time_s"], "wall_s": wall,
        "epoch_walls": [w for _, w, _ in rows],
        "index_overflow": totals["index_overflow"],
        "consume_skips": totals["consume_skips"],
        "retries": totals["retries"], "profiled_epoch": prof,
        "lock_arrays_checked": n_locks}


# ---------------------------------------------------------------------------
# --lanes: phase 8's TPC-C service without and with phase 9's lanes
# ---------------------------------------------------------------------------
def tpcc_service(dev, lanes):
    """Phase 8's TPC-C service run on a fresh engine, without or (``lanes``)
    with the read tier and the analytics lane of phase 9, and with no
    check inside the run.  Returns its figures."""
    import torch
    from repro_torch.changelog import AnalyticsLane
    from repro_torch.db import tpcc
    from repro_torch.reads import ReadTier
    from repro_torch.service import (AdmissionConfig, OpenLoopClient,
                                     TPCCSource, TxnService)
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    kw = {}
    if lanes:
        kw = dict(read_tier=ReadTier(max_staleness_epochs=READ_K,
                                     sec_refresh_every=READ_REFRESH),
                  analytics=AnalyticsLane(cfg))
    client = OpenLoopClient(TPCCSource(cfg, state=state, seed=2),
                            rate_txn_s=SERVICE_TPCC_RATE)
    svc = TxnService(eng, [client], AdmissionConfig(256, 512, "shed"),
                     slots_per_partition=SERVICE_SLOTS,
                     master_lanes=SERVICE_LANES,
                     feedback=lambda b, m: tpcc.apply_consume_feedback(
                         state, b, m), **kw)
    split = ("part_time_s", "sm_time_s", "fence_time_s", "epochs")
    stats0 = {f: getattr(eng.stats, f) for f in split}
    torch.cuda.synchronize()
    out = svc.run(duration_s=SERVICE_TPCC_S)
    client.shutdown()
    check(eng.replica_consistent(), "--lanes: replica diverged")
    fig = {k: out.get(k) for k in (
        "throughput_txn_s", "p50_ms", "p99_ms", "committed", "epochs",
        "epoch_time_s", "ingest_overlap_s", "read_served",
        "read_serve_time_s", "read_p50_ms", "read_p99_ms")}
    fig.update(lanes=lanes, engine_split={
        f: getattr(eng.stats, f) - stats0[f] for f in split})
    del svc, eng
    torch.cuda.empty_cache()
    return fig


def lanes_ab(dev, n):
    """``--lanes N``: ``tpcc_service`` in N pairs in one process, without
    and with the lanes, the order alternating (off, on, on, off, ...), so
    that drift of the card or the host shows in the spread.  Prints the
    card's name and power limit, then one ``LANES {...}`` line a run."""
    from repro_torch.kernels import _build
    _build.build_all()
    print(nvidia_smi(), flush=True)
    tpcc_service(dev, True)                  # untimed: first launches
    for i in range(n):
        for lanes in ((False, True) if i % 2 == 0 else (True, False)):
            print("LANES " + json.dumps(tpcc_service(dev, lanes)),
                  flush=True)
    return 0


# ---------------------------------------------------------------------------
# --ab: two checkouts compared on one card in one call
# ---------------------------------------------------------------------------
def ab(root, parent):
    """Runs ``--ab-side`` on the parent's tree and this one, parent,
    change, change, parent, one process each, so that drift of the card
    or the host during the call shows in the spread."""
    print(nvidia_smi(), flush=True)
    for tree in (parent, root, root, parent):
        r = subprocess.run([sys.executable, __file__, "--ab-side",
                            str(tree)])
        if r.returncode:
            return r.returncode
    return 0


def occ_calls(calls, dev):
    """The probe (both phases) and the OCC round through the executors'
    wrappers on their recorded arguments, whatever kernels each tree's
    wrapper launches: device time, kernels, aten operators, host time."""
    from repro_torch.core import partitioned, single_master
    out = {}
    for key, fn in (("step_index_ops", partitioned.step_index_ops),
                    ("locate_index_ops", single_master.locate_index_ops),
                    ("occ_round", single_master.occ_round)):
        args, kw = calls[key]
        a, k = to(args, dev), to(kw, dev)
        out[key] = call_figures(lambda: fn(*a, **k))
    return out


def ab_side(tree, dev):
    """One side of ``--ab``, with this script's phases and the kernels of
    ``tree``'s ``src/repro_torch``: the STAR main path's measured epochs
    and profiled epoch (phase 4, after one untimed epoch whose probe and
    round calls are recorded), the probe and the round on those calls
    (:func:`occ_calls`) and ``thomas_apply_batch`` on the warm epoch's
    single-master log, the serve path's prefill (``SERVE_RUNS`` timed
    after two untimed), the SSD kernel alone on the arguments that prefill
    gave it, and rmsnorm on its recorded prefill and decode calls, in
    the decode chain of :func:`norm_chain` and at RMS_AB_ROWS rows.
    Prints one ``AB {...}`` JSON line."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core import replication
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd.ops import ssd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine, ServeStats
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg, state, eng = mk_engine(MAIN, 0, dev)
    b = tpcc.make_batch(cfg, state, MAIN_TXNS, seed=1000)
    rec = Recorder()
    wrap_occ(rec)
    rec.wrap(replication, "thomas_apply_batch",
             lambda *a, **k: "thomas_apply_batch")
    try:
        m = eng.run_epoch(b)
    finally:
        rec.restore()
    tpcc.apply_consume_feedback(state, b, m)
    batches = [tpcc.make_batch(cfg, state, MAIN_TXNS, seed=ep)
               for ep in range(MAIN_EPOCHS)]
    _, out = measure_epochs(eng, cfg, state, batches)
    del eng, state
    out.update(occ_calls(rec.calls, dev))
    args, _ = rec.calls["thomas_apply_batch"]
    val, tidw, log = to(args, dev)
    tid0 = tidw.clone()
    out["thomas_apply_batch"] = call_figures(
        lambda: replication.thomas_apply_batch(val, tidw, log),
        setup=lambda: tidw.copy_(tid0))
    del rec, val, tidw, log
    torch.cuda.empty_cache()
    c = get_arch(SERVE_ARCH)
    se = ServeEngine(c, LM(c, seed=0, device=dev), device=dev,
                     max_len=SERVE_PROMPT + SERVE_GEN)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, c.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    calls = record_generate(se, prompts, 2)
    args, kw = calls["ssd"]
    (x, w, r), nkw = calls["rmsnorm/decode"]
    T, D = x.numel() // x.shape[-1], x.shape[-1]
    W = (torch.randn((D, D), generator=gen, device=dev) / D ** 0.5).to(
        x.dtype)
    out["rmsnorm_decode"] = call_figures(lambda: rmsnorm(x, w, r, **nkw))
    out["rmsnorm_decode"]["chain_ms"] = cuda_ms(lambda: norm_chain(
        rmsnorm, x.reshape(T, D), r.reshape(T, D), w, W, nkw.get("eps",
                                                                  1e-5)))
    (x, w, r), nkw = calls["rmsnorm/prefill"]
    out["rmsnorm_prefill_ms"] = cuda_ms(lambda: rmsnorm(x, w, r, **nkw))
    # by row count at D = 1,600, where the kernel's forms meet
    by_rows = {}
    for n in RMS_AB_ROWS:
        xs, rs = (torch.randn((n, D), generator=gen, device=dev).to(x.dtype)
                  for _ in range(2))
        by_rows[n] = cuda_ms(lambda: rmsnorm(xs, w, rs, **nkw))
    out["rmsnorm_by_rows_ms"] = by_rows
    del calls, x, w, r, xs, rs
    se.generate(prompts, 0)
    pre = []
    for _ in range(SERVE_RUNS):
        se.stats = ServeStats()
        se.generate(prompts, 0)
        pre.append(se.stats.prefill_s)
    out.update(tree=str(tree), prefill_s=pre,
               ssd_ms=cuda_ms(lambda: ssd(*args, **kw)))
    print("AB " + json.dumps(out), flush=True)

if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
