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
counted (``stats()["evicted"]`` and the ``tsspark_serve_cache_evicted``
metric) so an undersized cache shows up in the SERVE report and the
SLO watch instead of as silent hit-rate decay.  The default capacity
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
        # One additional version inserts are accepted for even while a
        # different version is active: the pre-activation warm window
        # (``allow_version``) — the pool's ahead-of-time materializer
        # fills the NEXT version's entries before the flip, and the
        # version gate must not drop them as stale.
        self._warm_version: Optional[Hashable] = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evicted = 0
        self.carried = 0
        # Misses the engine answered from the materialized forecast
        # plane instead of a dispatch: those rows are deliberately NOT
        # inserted here (the plane's shared pages are the cache), so
        # without this counter a plane-dominated workload would read as
        # a 0% hit rate when it is actually 100% dispatch-free.
        self.plane_hits = 0

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

    def peek(self, key: Hashable) -> Optional[Dict]:
        """Presence probe without touching the hit/miss counters or the
        LRU order (the materializer's idempotency check must not skew
        the serving hit rate)."""
        with self._lock:
            return self._data.get(key)

    def allow_version(self, version: Hashable) -> None:
        """Open the warm window for ``version``: inserts keyed to it
        are accepted alongside the active version's until the next
        ``invalidate`` (i.e. until an activation settles the question)."""
        with self._lock:
            self._warm_version = version

    def put(self, key: Hashable, value: Dict) -> None:
        if self.capacity <= 0:
            return
        evictions = 0
        with self._lock:
            if (self._accept_version is not None
                    and isinstance(key, tuple) and key
                    and key[0] != self._accept_version
                    and key[0] != self._warm_version):
                return  # keyed to a retired version: never pin it
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evictions += 1
            self.evicted += evictions
        if evictions:
            # Metric resolved outside the cache lock (and per event, so
            # a METRICS.reset() between loadgen runs never strands a
            # stale handle).
            from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

            METRICS.counter("tsspark_serve_cache_evicted").inc(
                evictions
            )

    def carry_forward(self, old_version, new_version,
                      changed_ids) -> int:
        """Delta-flip cache migration: re-key ``old_version``'s entries
        for series NOT in ``changed_ids`` to ``new_version``.  A delta
        publish copy-forwards unchanged series' parameters bitwise, so
        their cached forecasts are exactly what the new version would
        compute — dropping them (the full-flip behavior) would turn a
        1%-churn flip into a 100% cold cache.  Changed series are left
        to miss and recompute.  Must run BEFORE ``invalidate`` settles
        the flip (the engine's refresh hook orders the two); counted in
        ``stats()["carried"]``.  The capacity bound holds through the
        warm window: migrated entries evict LRU exactly like ``put``
        (at worst the base version's coldest entries go first — they
        are about to be invalidated anyway).  Returns the entries
        migrated."""
        if self.capacity <= 0:
            return 0
        moved = evictions = 0
        with self._lock:
            for key in list(self._data):
                if not (isinstance(key, tuple) and key
                        and key[0] == old_version):
                    continue
                if key[1] in changed_ids:
                    continue
                new_key = (new_version,) + key[1:]
                if new_key not in self._data:
                    self._data[new_key] = self._data[key]
                    moved += 1
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evictions += 1
            self.carried += moved
            self.evicted += evictions
        # Metrics resolved outside the cache lock, per event (same
        # discipline as put's eviction counter): carried is how a
        # metrics scraper sees carry-forward health during a delta flip
        # without polling engine internals.
        from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

        if moved:
            METRICS.counter("tsspark_serve_cache_carried").inc(moved)
        if evictions:
            METRICS.counter("tsspark_serve_cache_evicted").inc(
                evictions
            )
        return moved

    def invalidate(self, version: Optional[int] = None) -> int:
        """Drop entries for versions OTHER than ``version`` (``None``
        drops everything and clears the version gate).  Returns the
        count dropped.  Called on registry activation: entries for the
        newly active version are the only ones a future request can
        still hit — and the gate makes in-flight dispatches' late
        inserts for the retired version no-ops (see ``put``)."""
        with self._lock:
            self._accept_version = version
            self._warm_version = None  # the flip settles the window
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

    def key_versions(self) -> list:
        """Sorted distinct registry versions present in the cache keys —
        the chaos harness's staleness probe: after an activation settles,
        every key should carry the active version (a foreign version
        here is an entry pinned by the activation/insert race)."""
        with self._lock:
            return sorted({k[0] for k in self._data})

    def note_plane_hits(self, n: int) -> None:
        """Record ``n`` misses that the forecast plane absorbed (the
        engine's zero-dispatch read path)."""
        with self._lock:
            self.plane_hits += int(n)

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {
            "size": len(self._data),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "plane_hits": self.plane_hits,
            # Requests served WITHOUT a backend dispatch: LRU hits plus
            # plane-absorbed misses over all lookups.
            "hot_rate": (round((self.hits + self.plane_hits) / total, 4)
                         if total else 0.0),
            "invalidations": self.invalidations,
            "evicted": self.evicted,
            "carried": self.carried,
        }
