"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. build: compile the four CUDA sources of ``src/repro_torch/csrc`` (one
   nvcc each, in parallel) and print the card's name and power limit;
2. kernel parity: run one warm STAR epoch at full TPC-C widths (the main
   path's configuration below) while recording the arguments of the first
   main-path call of every kernel wrapper; then run each kernel on those
   arguments and hold the result bit-equal against its plain PyTorch
   version run on the CPU (tolerance 0: every value is an integer), time
   both on the card with CUDA events, and compute the kernel's bound.
   The Calvin round (a second, read-lock build) is checked the same way;
3. engine parity: the full-mix configuration of
   benchmarks/fig11_throughput.py (P=4, 4,000 items, 100 customers a
   district, order ring 128, 512 transactions an epoch) for 3 epochs on
   the card with the kernels and on the CPU with the plain versions:
   master, replica and indexes bit-equal after every epoch;
4. main path: P=16 warehouses at the spec's widths (100,000 items, 3,000
   customers a district, 10 districts; order ring 256, the most the
   orders_by_cust key layout holds), the full mix, 2,048 transactions an
   epoch, 16 OCC rounds: 4 measured epochs after the warm one, with
   ``replica_consistent()`` at every fence and every kernel launched;
   then one more epoch under ``torch.profiler`` for the card's busy time.

Kernel times are device times: CUDA events around a call enqueued while
a spin kernel keeps the card busy, so the wrapper's host time is not
counted; the median of 20 calls.  Bounds are bytes over 3.35 TB/s (each
input read once, each output written once, counting what the recorded
inputs need) or integer operations over 16.7 T/s, whichever is larger.

It prints the build time, the ``nvidia-smi`` name and power limit, one
JSON line of kernels, one JSON line of main-path figures and, last, the
``{"ok": true, "device": ...}`` line.  It needs one CUDA card and the
repository around it; without either it exits non-zero and prints no
result.
"""
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
FIG11 = dict(n_partitions=4, n_items=4000, cust_per_district=100,
             order_ring=128, mix="full", delivery_gen_lag=512)
FIG11_TXNS, FIG11_EPOCHS = 512, 3
REPLACES = {
    "scan_window": "src/repro/kernels/occ/kernel.py:103",
    "occ_round.lock_build": "src/repro/kernels/occ/kernel.py:164",
    "occ_round.validate": "src/repro/kernels/occ/kernel.py:321",
    "occ_round.install": "src/repro/kernels/occ/kernel.py:289",
    "index_merge": "src/repro/kernels/index_merge/kernel.py:139",
    "thomas_merge": "src/repro/kernels/thomas_merge/kernel.py:68",
}
SOURCE = {
    "scan_window": "src/repro_torch/csrc/scan_window.cu",
    "occ_round.lock_build": "src/repro_torch/csrc/occ_round.cu",
    "occ_round.validate": "src/repro_torch/csrc/occ_round.cu",
    "occ_round.install": "src/repro_torch/csrc/occ_round.cu",
    "index_merge": "src/repro_torch/csrc/index_merge.cu",
    "thomas_merge": "src/repro_torch/csrc/thomas_merge.cu",
}


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
                self.calls[key] = to((args, kw), args[0].device)
            return orig(*args, **kw)

        setattr(module, name, wrapper)
        self._undo.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


def mk_engine(cfg_kw, seed, device):
    import numpy as np
    from repro_torch.core.engine import StarEngine
    from repro_torch.db import tpcc
    cfg = tpcc.TPCCConfig(**cfg_kw)
    state = tpcc.TPCCState(cfg)
    init = tpcc.init_values(cfg, np.random.default_rng(seed), state=state)
    eng = StarEngine(cfg.n_partitions, cfg.rows_per_partition, init_val=init,
                     indexes=tpcc.index_specs(cfg), max_rounds=MAX_ROUNDS,
                     device=device)
    return cfg, state, eng


def same_store(a, b):
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
def record_warm_epoch(eng, batch):
    """Run ``batch`` through ``eng`` with the kernel wrappers recorded."""
    from repro_torch.core import replication, single_master
    from repro_torch.core.ops import IDX_OPS
    from repro_torch.kernels.index_merge import ops as im_ops
    from repro_torch.kernels.occ import ops as occ_ops
    rec = Recorder()
    rec.wrap(occ_ops, "scan_window",
             lambda *a, n_slots, **k: f"scan_window/{n_slots}")
    rec.wrap(single_master, "occ_round", lambda *a, **k: "occ_round")
    rec.wrap(occ_ops, "lock_build", lambda *a, **k: "lock_build")
    rec.wrap(occ_ops, "occ_validate", lambda *a, **k: "validate")
    rec.wrap(occ_ops, "occ_install", lambda *a, **k: "install")
    P = eng.P
    # the first merge of each shape: (P, P*K) in the partitioned phase,
    # (P, B*K) in the single-master one
    rec.wrap(im_ops, "index_merge_cuda",
             lambda key, prow, tid, dk, ik, ip, it:
             "index_merge/part" if ik.shape[1] <= P * IDX_OPS
             else "index_merge/sm")
    rec.wrap(replication, "thomas_merge", lambda *a, **k: "thomas_merge")
    try:
        m = eng.run_epoch(batch)
    finally:
        rec.restore()
    return m, rec.calls


def kernel_checks(calls, dev):
    """Parity, timing and bound of every kernel on its recorded arguments.
    Returns {name: report} (launches filled in later)."""
    import torch
    from repro_torch.kernels.index_merge.ops import index_merge_cuda
    from repro_torch.kernels.index_merge.ref import index_merge_plain
    from repro_torch.kernels.occ import ops as occ_ops
    from repro_torch.kernels.occ import ref as occ_ref
    from repro_torch.kernels.thomas_merge.ops import thomas_merge
    from repro_torch.kernels.thomas_merge.ref import thomas_merge_plain
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
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = nops / H100_INT32_OPS_PER_S * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": lib_ms, "bytes": int(nbytes), "ops": int(nops)}

    # -- scan_window at both callers' shapes (SM phase timed and reported)
    for key in ("scan_window/1", "scan_window/9"):
        (fk, ft, q, base, cap), kw = calls[key]
        Q, ns, ni = q.shape[0], kw["n_slots"], kw["n_iters"]
        if key == "scan_window/1":
            got = occ_ops.scan_window(fk, ft, q, base, cap, **kw)
            want = occ_ref.scan_window_plain(*to((fk, ft, q, base, cap),
                                                 cpu), **kw)
            check(equal(got, want), "scan_window (n_slots=1) differs")
            continue
        report("scan_window", occ_ops.scan_window, occ_ref.scan_window_plain,
               (fk, ft, q, base, cap), kw,
               nbytes=Q * (12 + 4 * ni + 12 * ns) + Q * (4 + 12 * ns),
               nops=Q * (4 * ni + 2 * ns))

    # -- occ_round, launch by launch (Silo, as on the main path)
    (addr, lane), kw = calls["lock_build"]
    NT1 = kw["NT"] + 1
    Kc = addr.shape[0]
    # the plain version is full + scatter_reduce_(amin), the library call
    report("occ_round.lock_build", occ_ops.lock_build,
           occ_ref.lock_build_plain, (addr, lane), kw,
           nbytes=Kc * 8 + NT1 * 4, nops=Kc, plain_is_library=True)
    args, kw = calls["validate"]
    val, tidw, lock, rlock, rows, kind, delta = args[:7]
    ix = kw.get("ix")
    B, M = rows.shape
    C = val.shape[1]
    K, L = ix["scan_addr"].shape[1], ix["scan_addr"].shape[2]
    # claim and scan slots: a flag each, address, lock word and TID only
    # where the flag is set
    n_claim = int(kw["has_claim"].sum())
    n_scan = int(ix["scan_valid"].sum())
    report("occ_round.validate", occ_ops.occ_validate,
           occ_ref.validate_plain, args, kw,
           nbytes=(B * M * (4 + 4 + 4 * C + 2) + B * (1 + 8)
                   + B * M * (4 * C + 8 + 4) + B * K + n_claim * (4 + 8 + 4)
                   + B * K * L + n_scan * (4 + 8 + 4)
                   + B * (1 + 8) + B * M * (4 * C + 1)),
           nops=B * M * (2 * C + 8) + (n_claim + n_scan) * 4)
    args, kw = calls["install"]
    n_w = int(args[4].sum())

    def tables(fn):
        """An in-place install, returning the tables it updated."""
        return lambda *a, **k: (fn(*a, **k), a[0], a[1])[1:]
    # repeated installs write the same values: no reset needed
    report("occ_round.install", tables(occ_ops.occ_install),
           tables(occ_ref.install_plain), args, kw,
           nbytes=B * M * 5 + B * 8 + n_w * (4 * C + 4 * C + 8),
           nops=B * M * 2)

    # -- a whole round in Calvin mode (second, read-lock build)
    args, kw = calls["occ_round"]
    kw = dict(kw, deterministic=True)
    got = occ_ops.occ_round(*to(args, dev), **to(kw, dev))
    torch.cuda.synchronize()
    want = occ_ops.occ_round(*to(args, cpu), **to(kw, cpu))
    check(equal(got, want), "occ_round (Calvin) differs")

    # -- index_merge at both phases' shapes (SM phase timed and reported)
    for key in ("index_merge/part", "index_merge/sm"):
        args, kw = calls[key]
        if key == "index_merge/part":
            check(equal(index_merge_cuda(*to(args, dev)),
                        index_merge_plain(*to(args, cpu))),
                  "index_merge (partitioned shape) differs")
            continue
        P, cap = args[0].shape
        Kd, Ki = args[3].shape[1], args[4].shape[1]
        # the global-scratch branch (taken when a segment's flags do not
        # fit in shared memory) on the same arguments
        check(equal(index_merge_cuda(*to(args, dev), smem_limit=0),
                    index_merge_plain(*to(args, cpu))),
              "index_merge (global scratch) differs")
        lg = max(cap, Ki).bit_length()
        report("index_merge", index_merge_cuda, index_merge_plain, args, kw,
               nbytes=P * cap * 16 * 2 + P * (Kd * 4 + Ki * 16 + 4),
               nops=P * (Kd + Ki + 2 * cap) * lg * 3)

    # -- thomas_merge on the epoch's single-master value stream
    args, kw = calls["thomas_merge"]
    val, tidw, wrows, wvals, wtids = args
    Kw = wrows.shape[0]
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
    report("thomas_merge", thomas_merge, thomas_merge_plain, args, kw,
           nbytes=Kw * 4 + n_live * (8 + 8) + n_win * (4 * C + 4 * C + 8),
           nops=Kw + n_live * 3, reset=reset)
    return out


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
# main
# ---------------------------------------------------------------------------
def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    return run(torch.device("cuda", 0))


def run(dev):
    import torch
    from repro_torch.db import tpcc
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    # ---- 1. build + device ----------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.SOURCES)} CUDA sources in "
          f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)

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
    torch.cuda.synchronize()
    base = {f: getattr(eng.stats, f) for f in
            ("committed_cross", "index_overflow", "consume_skips", "retries")}

    def measured(f):
        """A stats counter over the measured epochs only."""
        return getattr(eng.stats, f) - base[f]
    _build.reset_launch_counts()
    rows = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        m = eng.run_epoch(b)
        wall = time.perf_counter() - t0
        ok = eng.replica_consistent()
        tpcc.apply_consume_feedback(state, b, m)
        rows.append((m, wall, ok))
        print(f"epoch {eng.epoch - 1}: committed {m['committed_single']}+"
              f"{m['committed_cross']} t_part={m['t_part_s']:.4f}s "
              f"t_sm={m['t_sm_s']:.4f}s wall={wall:.4f}s "
              f"index_overflow={m['index_overflow']} "
              f"consume_skips={measured('consume_skips')} replica={ok}")
        check(ok, "main path: replica diverged at a fence")
    counts = _build.launch_counts()
    check(measured("committed_cross") > 0, "main path: no cross commit")
    totals = {f: measured(f) for f in base}
    prof = profile_epoch(eng, cfg, state)
    for k in kernels:
        kernels[k]["launches"] = counts.get(k, 0)
        check(kernels[k]["launches"] > 0, f"main path never launched {k}")
    committed = sum(m["committed_single"] + m["committed_cross"]
                    for m, _, _ in rows)
    wall = sum(w for _, w, _ in rows)
    t_part = sum(m["t_part_s"] for m, _, _ in rows)
    t_sm = sum(m["t_sm_s"] for m, _, _ in rows)
    t_f = sum(m["t_fence1_s"] + m["t_fence2_s"] for m, _, _ in rows)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"main_path": {
        "epochs": MAIN_EPOCHS, "txns_per_epoch": MAIN_TXNS,
        "committed": committed, "committed_txn_per_s": committed / wall,
        "t_part_s": t_part, "t_sm_s": t_sm, "t_fence_s": t_f,
        "wall_s": wall, "index_overflow": totals["index_overflow"],
        "consume_skips": totals["consume_skips"],
        "retries": totals["retries"], "device": name, "nvidia_smi": smi,
        "profiled_epoch": prof}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
