"""Process-local metrics registry: counters and pow-2 histograms.

The part of the JAX package's ``obs/metrics.py`` that the port's
streaming driver records through, with the same names and buckets:
``tsspark_<subsystem>_<what>_<unit>`` names, one locked increment on the
hot path.  Histograms bucket on the pow-2 ladder as ``{exponent: count}``
with exact sum/count/min/max alongside.  Gauges hold the storage layer's
headroom and ladder state (``io/budget.py``, ``io/ladder.py``).  Labels
and the snapshot export come with their first caller.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional


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


class Gauge:
    """Last-value gauge."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


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


class MetricsRegistry:
    """Named metric handles, one registry per process (``DEFAULT``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())


#: The process's registry.
DEFAULT = MetricsRegistry()
