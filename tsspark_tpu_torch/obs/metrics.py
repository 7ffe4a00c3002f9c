"""Process-local metrics registry: counters, gauges, pow-2 histograms.

A copy of the JAX package's ``obs/metrics.py``: ``tsspark_<subsystem>_
<what>_<unit>`` names, labels baked
into the handle at registration (``counter("...", result="shed")``), so
the hot path is one locked increment with no formatting.  Histograms
bucket on the pow-2 ladder as ``{exponent: count}`` with exact
sum/count/min/max alongside, so a snapshot stays a few dozen ints.

``MetricsRegistry.export`` writes an atomic JSON snapshot
(``metrics_*.json`` next to a run's other artifacts; a trace id keys it
into the run ledger): the orchestrator's fit workers export theirs at a
clean exit.  ``to_prometheus`` / ``prometheus_text`` render the standard
text exposition format for scrape-style consumers (the serve daemon's
and the pool replicas' ``metrics`` command).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from tsspark_tpu_torch.utils.atomic import atomic_write

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` takes a lock: ``value += n`` is
    load/add/store bytecode the GIL can interleave."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def _reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Last-value gauge."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def _reset(self) -> None:
        self.value = 0.0


#: Exponent clamp: 2**-30 s ≈ 1 ns and 2**30 ≈ 34 years/1G — everything
#: this package measures fits far inside.
_EXP_MIN, _EXP_MAX = -30, 30


class Histogram:
    """Pow-2-bucketed histogram: bucket ``e`` counts observations with
    ``2**(e-1) < v <= 2**e`` (zero/negative land in the bottom)."""

    __slots__ = ("buckets", "count", "total", "vmin", "vmax", "_lock")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        if v > 0.0:
            e = min(max(math.ceil(math.log2(v)), _EXP_MIN), _EXP_MAX)
        else:
            e = _EXP_MIN
        with self._lock:
            self.buckets[e] = self.buckets.get(e, 0) + 1
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)

    def _reset(self) -> None:
        with self._lock:
            self.buckets.clear()
            self.count = 0
            self.total = 0.0
            self.vmin = self.vmax = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "buckets": {str(e): n for e, n in sorted(self.buckets.items())},
            "count": self.count,
            "sum": round(self.total, 6),
            "min": self.vmin, "max": self.vmax,
        }


class MetricsRegistry:
    """Named metric handles, one registry per process (``DEFAULT``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _labelkey(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _labelkey(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
        return h

    def reset(self) -> None:
        """Zero every metric IN PLACE (handles cached by subsystems stay
        live), so a second run in one process does not export the first
        run's counts under its own trace id."""
        with self._lock:
            handles = (list(self._counters.values())
                       + list(self._gauges.values())
                       + list(self._hists.values()))
        for h in handles:
            h._reset()

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = [
                {"name": n, "labels": dict(lk), "value": c.value}
                for (n, lk), c in sorted(self._counters.items())
            ]
            gauges = [
                {"name": n, "labels": dict(lk), "value": g.value}
                for (n, lk), g in sorted(self._gauges.items())
            ]
            hists = [
                {"name": n, **h.to_dict()}
                for n, h in sorted(self._hists.items())
            ]
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def export(self, path: str,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Atomic snapshot file (readers never see a torn JSON); the
        trace id keys it into the run ledger."""
        snap = {
            "kind": "metrics-snapshot",
            "unix": round(time.time(), 3),
            "trace_id": trace_id,
            "pid": os.getpid(),
            "metrics": self.snapshot(),
        }
        atomic_write(path, lambda fh: json.dump(snap, fh, indent=1),
                     mode="w")
        return snap

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the current state."""
        return prometheus_text(self.snapshot())


def prometheus_text(metrics: Dict[str, Any]) -> str:
    """Render a ``snapshot()``-shaped dict as Prometheus text (also
    accepts the ``metrics`` block of an exported snapshot file)."""
    lines = []
    for c in metrics.get("counters", ()):
        lines.append(f"# TYPE {c['name']} counter")
        lab = ",".join(f'{k}="{v}"' for k, v in
                       sorted(c.get("labels", {}).items()))
        lines.append(
            f"{c['name']}{{{lab}}} {c['value']}" if lab
            else f"{c['name']} {c['value']}"
        )
    for g in metrics.get("gauges", ()):
        lines.append(f"# TYPE {g['name']} gauge")
        lab = ",".join(f'{k}="{v}"' for k, v in
                       sorted((g.get("labels") or {}).items()))
        lines.append(
            f"{g['name']}{{{lab}}} {g['value']}" if lab
            else f"{g['name']} {g['value']}"
        )
    for h in metrics.get("histograms", ()):
        name = h["name"]
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for e in sorted(int(k) for k in h.get("buckets", {})):
            cum += h["buckets"][str(e)]
            lines.append(f'{name}_bucket{{le="{2.0 ** e:g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{name}_sum {h['sum']}")
        lines.append(f"{name}_count {h['count']}")
    return "\n".join(lines) + "\n"


#: The process's registry.  Subsystems grab handles at init and bump
#: them unconditionally — a handle costs one int add, and the snapshot
#: is only exported when a caller asks for it.
DEFAULT = MetricsRegistry()
