"""Version-keyed forecast LRU (the port's copy of the JAX package's).

Keys carry the registry version, so a stale entry can never satisfy a
request against a newer activation even without explicit invalidation;
the explicit ``invalidate`` (wired to ``ParamRegistry.subscribe``)
exists to free the memory and to make the flip observable in the
hit/miss counters.

Entries are PER SERIES, not per request: a request for (a, b, c) that
follows one for (b, c, d) re-dispatches only ``a`` — series-level reuse
is where a heavy-traffic mix actually overlaps.

The cache is BOUNDED (strict LRU eviction at ``capacity``): at
million-series scale an unbounded version-keyed cache is a slow OOM —
every distinct (series, horizon-bucket) pair a long-lived engine ever
serves would stay pinned until the next version flip.  Evictions are
counted (``stats()["evicted"]``) so an undersized cache shows up as a
number instead of as silent hit-rate decay.  The default capacity
comes from ``$TSSPARK_SERVE_CACHE_CAPACITY`` so operators size it per
deployment without touching call sites.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, Hashable, Optional

#: Fallback capacity when neither the constructor nor the environment
#: picks one (entries are (H,)-row dicts — 8192 is a few tens of MB at
#: serving horizons).
FALLBACK_CAPACITY = 8192


def default_capacity() -> int:
    """Configured default: ``$TSSPARK_SERVE_CACHE_CAPACITY`` or the
    module fallback (pool replicas inherit the env, so one knob sizes
    every engine in a deployment)."""
    try:
        return int(os.environ.get("TSSPARK_SERVE_CACHE_CAPACITY", ""))
    except ValueError:
        return FALLBACK_CAPACITY


class ForecastCache:
    """Thread-safe LRU of per-series forecast rows.

    Key: ``(version, series_id, horizon_bucket, num_samples, seed)``.
    Value: dict of ``(H,)`` arrays (plus the ds row) — whatever the
    engine scatters per series.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = (default_capacity() if capacity is None
                         else int(capacity))
        self._data: "collections.OrderedDict[Hashable, Dict]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        # Version gate (set by invalidate): once an activation has
        # declared a current version, put() drops entries keyed to any
        # other version UNDER THIS LOCK — an engine dispatch racing the
        # activation (snapshot read before the flip, insert after the
        # invalidation sweep) can therefore never pin a retired-version
        # entry.  None = no activation seen yet, accept everything.
        self._accept_version: Optional[Hashable] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Hashable) -> Optional[Dict]:
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: Hashable, value: Dict) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            if (self._accept_version is not None
                    and isinstance(key, tuple) and key
                    and key[0] != self._accept_version):
                return  # keyed to a retired version: never pin it
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evicted += 1

    def invalidate(self, version: Optional[int] = None) -> int:
        """Drop entries for versions OTHER than ``version`` (``None``
        drops everything and clears the version gate).  Returns the
        count dropped.  Called on registry activation: entries for the
        newly active version are the only ones a future request can
        still hit — and the gate makes in-flight dispatches' late
        inserts for the retired version no-ops (see ``put``)."""
        with self._lock:
            self._accept_version = version
            if version is None:
                dropped = len(self._data)
                self._data.clear()
            else:
                stale = [k for k in self._data if k[0] != version]
                for k in stale:
                    del self._data[k]
                dropped = len(stale)
            self.invalidations += dropped
            return dropped

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {
            "size": len(self._data),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "invalidations": self.invalidations,
            "evicted": self.evicted,
        }
