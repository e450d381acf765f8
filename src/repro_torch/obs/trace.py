"""Low-overhead span tracer exporting Chrome/Perfetto trace_event JSON.

The whole epoch lifecycle — partitioned slabs, fence (tail-ship / psum /
WAL-sink), single-master rounds, replica replay, recovery — is wired
with ``with span("engine.partitioned", cat="phase", epoch=e):`` blocks.
When tracing is disabled (the default) each such block costs one method
call returning a shared null context manager; the budget is asserted in
``tests/test_obs.py`` (≤2% of measured epoch time).

Spans record ``time.perf_counter()`` begin/end (monotonic), nest per
thread, and land in a bounded thread-safe ring buffer (drop-oldest with
a counter).  ``export_chrome(path)`` writes the standard trace_event
JSON object (``ph:"X"`` complete events, microsecond timestamps) that
https://ui.perfetto.dev and ``chrome://tracing`` load directly.

Kernel-launch hooks: the kernel dispatch wrappers in ``kernels/occ``,
``kernels/index_merge`` and ``kernels/thomas_merge`` call
:func:`kernel_launch` once per dispatch (PyTorch runs eagerly, so every
call is a dispatch); the marks carry the kernel name and backend as args
and also feed a process-wide dispatch counter.  The count of CUDA launches
proper is kept by ``repro_torch.kernels._build``.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr, name, cat, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tr._emit(self.name, self.cat, self._t0, time.perf_counter(),
                       self.args)
        return False

    def set(self, **kw):
        """Attach/overwrite key-value args while the span is open."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self


class Tracer:
    """Bounded thread-safe span recorder (drop-oldest ring buffer)."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self._buf = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._origin = time.perf_counter()
        self._emitted = 0
        self._tids = {}
        self._tid_next = itertools.count()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager timing a nested span; no-op when disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "", **args):
        """Zero-duration mark (``ph:"i"``); no-op when disabled."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._emit(name, cat, t, None, args or None)

    def complete(self, name: str, cat: str = "", t0: float = 0.0,
                 t1: float = 0.0, **args):
        """Record an already-timed region (``perf_counter`` begin/end) —
        the hot paths that measure ``t0``/``t1`` anyway report through
        this instead of paying a context manager; no-op when disabled."""
        if not self.enabled:
            return
        self._emit(name, cat, t0, max(t1, t0), args or None)

    def _tid(self):
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = next(self._tid_next)
        return tid

    def _emit(self, name, cat, t0, t1, args):
        with self._lock:
            self._buf.append((name, cat, t0 - self._origin,
                              None if t1 is None else t1 - t0,
                              self._tid(), args))
            self._emitted += 1

    # -- inspection --------------------------------------------------------
    @property
    def dropped(self) -> int:
        return self._emitted - len(self._buf)

    def events(self):
        """Recorded events as dicts (ts/dur in seconds since enable)."""
        with self._lock:
            raw = list(self._buf)
        return [{"name": n, "cat": c, "ts_s": ts, "dur_s": dur,
                 "tid": tid, "args": args or {}}
                for n, c, ts, dur, tid, args in raw]

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._emitted = 0
            self._origin = time.perf_counter()

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        evs = []
        for e in self.events():
            rec = {"name": e["name"], "cat": e["cat"] or "default",
                   "pid": 0, "tid": e["tid"],
                   "ts": round(e["ts_s"] * 1e6, 3)}
            if e["dur_s"] is None:
                rec.update(ph="i", s="t")
            else:
                rec.update(ph="X", dur=round(e["dur_s"] * 1e6, 3))
            if e["args"]:
                rec["args"] = {k: _jsonable(v) for k, v in e["args"].items()}
            evs.append(rec)
        evs.sort(key=lambda r: r["ts"])
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> int:
        """Write trace_event JSON; returns the number of events."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(doc["traceEvents"])


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        return str(v)


# --------------------------------------------------------------------------
# module-level tracer: the one instrumentation points talk to
# --------------------------------------------------------------------------
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the module tracer (tests, CLI ``--trace``); returns the old."""
    global _TRACER
    old, _TRACER = _TRACER, tracer
    return old


def span(name: str, cat: str = "", **args):
    """``with span("engine.partitioned", cat="phase", epoch=e): ...``"""
    return _TRACER.span(name, cat, **args)


def complete(name: str, cat: str = "", t0: float = 0.0, t1: float = 0.0,
             **args):
    return _TRACER.complete(name, cat, t0, t1, **args)


def instant(name: str, cat: str = "", **args):
    return _TRACER.instant(name, cat, **args)


# --------------------------------------------------------------------------
# kernel-dispatch hook (fires once per wrapper call)
# --------------------------------------------------------------------------
_KERNEL_LAUNCHES: dict = {}
_KERNEL_LOCK = threading.Lock()


def kernel_launch(kernel: str, **shape):
    """Per-dispatch hook for the kernel wrappers."""
    with _KERNEL_LOCK:
        _KERNEL_LAUNCHES[kernel] = _KERNEL_LAUNCHES.get(kernel, 0) + 1
    if _TRACER.enabled:
        _TRACER.instant(f"kernel.{kernel}", cat="kernel", **shape)


def kernel_launch_counts() -> dict:
    """Traced-launch counts per kernel (``kernels.<name>`` namespace)."""
    with _KERNEL_LOCK:
        return dict(_KERNEL_LAUNCHES)
