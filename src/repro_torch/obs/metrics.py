"""One metrics registry: counters/gauges/histograms under a dotted
namespace, port of ``repro.obs.metrics``.

The existing stats dataclasses (``EngineStats``, ``ServiceStats``,
``ReadTierStats``, the per-node arrays in the cluster service) REGISTER
into a :class:`MetricsRegistry` instead of being hand-merged by every
benchmark:

* ``register_object("engine", eng.stats)`` — every numeric dataclass
  field becomes a gauge ``engine.<field>`` read live at snapshot time;
* ``register_provider("cluster", fn)`` — ``fn()`` returns a flat
  ``{name: value}`` dict merged under the prefix (how per-node arrays
  become ``cluster.node3.fence_wait_s``).

``snapshot(epoch)`` materializes one point of the per-epoch time series
(registered objects + providers + explicit counters/gauges/histograms);
``export_jsonl`` writes one JSON object per snapshot line and
``export_prometheus`` renders the LATEST values in Prometheus text
exposition format (dots → underscores).
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading

#: default histogram bucket upper bounds (seconds-ish scale); +Inf implied
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)


class _Histogram:
    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float):
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "buckets": dict(zip([*map(str, self.bounds), "+Inf"],
                                    _cumulative(self.counts)))}


def _cumulative(counts):
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


def _numeric(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)) and not (isinstance(v, float)
                                            and math.isnan(v)):
        return v
    return None


class MetricsRegistry:
    """Namespaced counters/gauges/histograms + per-epoch snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._objects: list = []      # (prefix, obj)
        self._providers: list = []    # (prefix, fn)
        self.snapshots: list = []

    # -- primitive instruments --------------------------------------------
    def counter_add(self, name: str, value=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge_set(self, name: str, value):
        with self._lock:
            self._gauges[name] = value

    def hist_observe(self, name: str, value: float, buckets=None):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram(buckets or DEFAULT_BUCKETS)
            h.observe(float(value))

    # -- registration: the stats dataclasses plug in here ------------------
    def register_object(self, prefix: str, obj) -> None:
        """Expose every numeric dataclass/attribute field as
        ``<prefix>.<field>`` gauges, read live at snapshot time."""
        self._objects.append((prefix, obj))

    def register_provider(self, prefix: str, fn) -> None:
        """``fn() -> {name: value}`` merged under ``<prefix>.`` at
        snapshot time (per-node arrays, lane summaries, launch counts)."""
        self._providers.append((prefix, fn))

    # -- reading -----------------------------------------------------------
    def _object_values(self, prefix, obj):
        if dataclasses.is_dataclass(obj):
            items = ((f.name, getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
        else:
            items = ((k, v) for k, v in vars(obj).items()
                     if not k.startswith("_"))
        out = {}
        for k, v in items:
            n = _numeric(v)
            if n is not None:
                out[f"{prefix}.{k}"] = n
        return out

    def values(self) -> dict:
        """Flat ``{metric: value}`` of everything, read live."""
        out = {}
        for prefix, obj in self._objects:
            out.update(self._object_values(prefix, obj))
        for prefix, fn in self._providers:
            for k, v in (fn() or {}).items():
                n = _numeric(v)
                if n is not None:
                    out[f"{prefix}.{k}" if prefix else k] = n
        with self._lock:
            out.update(self._counters)
            out.update({k: v for k, v in self._gauges.items()
                        if _numeric(v) is not None})
            for k, h in self._hists.items():
                out[f"{k}.count"] = h.count
                out[f"{k}.sum"] = h.total
        return out

    def snapshot(self, epoch=None) -> dict:
        """Record one time-series point; returns it."""
        snap = {"epoch": epoch}
        snap.update(sorted(self.values().items()))
        self.snapshots.append(snap)
        return snap

    def latest(self) -> dict:
        return self.snapshots[-1] if self.snapshots else self.snapshot()

    # -- exporters ---------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """One JSON object per snapshot line; returns the line count."""
        snaps = self.snapshots or [self.snapshot()]
        with open(path, "w") as f:
            for s in snaps:
                f.write(json.dumps(s) + "\n")
        return len(snaps)

    def export_prometheus(self) -> str:
        """Latest values in Prometheus text exposition format."""
        lines = []
        with self._lock:
            hist_keys = {f"{k}.count" for k in self._hists} \
                | {f"{k}.sum" for k in self._hists}
        vals = {k: v for k, v in self.values().items()
                if k not in hist_keys}
        for name in sorted(vals):
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_value(vals[name])}")
        with self._lock:
            hists = dict(self._hists)
        for name in sorted(hists):
            h, pname = hists[name], _prom_name(name)
            lines.append(f"# TYPE {pname} histogram")
            for le, c in h.summary()["buckets"].items():
                lines.append(f'{pname}_bucket{{le="{le}"}} {c}')
            lines.append(f"{pname}_sum {_prom_value(h.total)}")
            lines.append(f"{pname}_count {h.count}")
        return "\n".join(lines) + "\n"

    def export_prometheus_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.export_prometheus())


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_value(v) -> str:
    return repr(int(v)) if isinstance(v, int) else repr(float(v))
