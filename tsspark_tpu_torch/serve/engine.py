"""Micro-batched low-latency prediction engine.

The port's serving read path: requests enter a BOUNDED queue (admission
control — a full queue rejects at submit instead of building invisible
backlog), are coalesced into shape-bucketed batches, gathered out of the
active registry snapshot, and dispatched through ``backend.predict`` as
ONE padded call per bucket.

Batch widths walk a pow-2 ladder (``parallel.sharding.compacted_width``)
and horizons are padded up a pow-2 ladder too (each series' future grid
extends at its own cadence; rows/steps are sliced back per request).
Padding rows repeat a real row, and every op of the forward pass is row-
and timestep-local, so an engine-batched deterministic forecast equals a
direct ``backend.predict`` for the same series bit for bit.  Sampled
intervals draw from a batch-shaped key, so a series' draws depend on the
width and row order of whichever miss-set batch first computed them;
repeated identical requests return the same cached values.

Deadline-expired requests are SHED with a structured error before the
batch dispatches.  A request for a negative interval sample count is
refused when it is made; any other count is served.  Transient backend
failures retry under a ``resilience.RetryPolicy`` when one is attached;
a dispatch ``CircuitBreaker`` that a dead backend has failed open sheds
requests fast with the structured ``BackendUnavailable``, and a
``registry_breaker`` keeps the held snapshot serving while registry
loads keep failing (stale beats down).

``EngineStats.stages`` times the host stages of each dispatch: "gather"
(snapshot rows, padding, parameter take, future grid), "predict" (the
``backend.predict`` call, arrays back on the host), "scatter" (per-series
rows for the cache) and "assemble" (each request's arrays).

Deterministic groups whose horizon bucket the version's forecast plane
(``serve/fplane.py``) covers are answered by a memmap gather from the
plane instead of a dispatch (``EngineStats.plane_hits`` /
``plane_misses`` count the rows each way); a torn or absent plane is
memoized at the flip and the compute path serves.  A full version flip
drops the whole cache; a DELTA flip (``ParamRegistry.publish_delta``)
first carries the cached rows of the series the delta did not refit
forward to the new version (``ForecastCache.carry_forward``: their
parameters are the base version's bits, so are their forecasts).

Version discipline for the replica pool (``serve/pool.py``):
``prefetch`` loads a version ahead of its activation so the flip swaps
it in without a disk load, ``materialize`` fills the cache for a
version (prefetched or active) ahead of its traffic, and
``ensure_version`` forces the engine onto the registry's active version.

``quantiles`` serves interval forecasts synchronously: from the version's
quantile plane (``uncertainty/qplane.py``) as a memmap gather when the
plane covers the request, else through the row-local compute fallback
(``qplane.compute_rows``), which gives plane-covered cells the same bits.
``EngineStats.qplane_hits`` / ``qplane_misses`` count the rows each way.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.backends.registry import ForecastBackend, get_backend
from tsspark_tpu_torch.config import SolverConfig
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
from tsspark_tpu_torch.parallel.sharding import compacted_width, next_pow2
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.policy import CircuitBreaker
from tsspark_tpu_torch.serve import fplane
from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.registry import (
    ParamRegistry,
    RegistryError,
    Snapshot,
)
from tsspark_tpu_torch.utils.spans import StageClock


# ---------------------------------------------------------------------------
# requests + structured errors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForecastRequest:
    """One prediction request (possibly many series, one horizon)."""

    series_ids: Tuple[str, ...]
    horizon: int
    num_samples: int = 0
    seed: int = 0
    deadline_s: Optional[float] = None   # absolute time.monotonic()

    @classmethod
    def make(cls, series_ids: Sequence, horizon: int,
             num_samples: int = 0, seed: int = 0,
             deadline_in_s: Optional[float] = None) -> "ForecastRequest":
        if int(horizon) < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if not series_ids:
            raise ValueError("series_ids must be non-empty")
        if int(num_samples) < 0:
            raise SamplesUnsupported(int(num_samples))
        return cls(
            series_ids=tuple(str(s) for s in series_ids),
            horizon=int(horizon),
            num_samples=int(num_samples),
            # The seed only matters when sampling; folding it to 0
            # otherwise lets deterministic requests that differ only in
            # seed share one cache entry and one dispatch row.
            seed=int(seed) if num_samples else 0,
            deadline_s=(None if deadline_in_s is None
                        else time.monotonic() + float(deadline_in_s)),
        )


class ServeError(RuntimeError):
    """Base of the engine's structured errors (all JSON-able)."""

    reason = "serve-error"

    def to_dict(self) -> Dict:
        return {"type": type(self).__name__, "reason": self.reason,
                "detail": str(self)}


class RequestShed(ServeError):
    """Deadline expired before dispatch; the request was dropped from
    its batch instead of blocking it."""

    reason = "deadline-exceeded"

    def __init__(self, deadline_s: float, now_s: float):
        self.deadline_s = deadline_s
        self.now_s = now_s
        super().__init__(
            f"deadline expired {now_s - deadline_s:.3f}s before dispatch"
        )

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["late_s"] = round(self.now_s - self.deadline_s, 4)
        return d


class UnknownSeries(ServeError):
    """The active snapshot has no parameters for some requested ids."""

    reason = "unknown-series"

    def __init__(self, missing: Sequence[str], version: int):
        self.missing = tuple(missing)
        self.version = version
        super().__init__(
            f"version {version} has no params for {list(missing)[:5]}"
        )


class EngineOverloaded(ServeError):
    """The bounded request queue is full (admission control)."""

    reason = "overloaded"


class BackendUnavailable(ServeError):
    """The dispatch circuit breaker is open: the backend has failed
    enough consecutive dispatches that requests are shed fast instead of
    each burning its deadline on doomed retries."""

    reason = "circuit-open"

    def __init__(self, name: str, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(
            f"{name} circuit open; retry in {retry_after_s:.2f}s"
        )

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["retry_after_s"] = round(self.retry_after_s, 3)
        return d


class SamplesUnsupported(ServeError, ValueError):
    """The request asks for a negative interval sample count."""

    reason = "samples-unsupported"

    def __init__(self, num_samples: int):
        self.num_samples = num_samples
        super().__init__(
            f"num_samples must be >= 0, got {num_samples}"
        )


class PendingForecast:
    """Handle returned by ``submit``; resolves to a ForecastResult."""

    def __init__(self, request: ForecastRequest):
        self.request = request
        self.submitted_s = time.monotonic()
        # Wall-clock twin of submitted_s: span records join across
        # processes on wall time; latency math stays on the monotonic.
        self.submitted_unix = time.time()
        self._event = threading.Event()
        self._result: Optional["ForecastResult"] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, result: "ForecastResult") -> None:
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> "ForecastResult":
        if not self._event.wait(timeout):
            raise TimeoutError("forecast still pending")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass(frozen=True)
class ForecastResult:
    """Per-request output: (B, H) arrays in request series order."""

    series_ids: Tuple[str, ...]
    ds: np.ndarray                    # (B, H) float64 future grid
    values: Dict[str, np.ndarray]     # each (B, H)
    version: int
    latency_s: float
    from_cache: int                   # series rows served without a
                                      # fresh dispatch: LRU hits plus
                                      # plane-gathered rows


#: Rolling-window sizes for the per-request/per-dispatch samples: a
#: serving daemon runs indefinitely, so unbounded lists would leak.
_LATENCY_WINDOW = 100_000
_OCCUPANCY_WINDOW = 10_000


@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    completed: int = 0
    shed: int = 0
    failed: int = 0
    rejected: int = 0
    pumps: int = 0
    dispatches: int = 0
    # Breaker-open fast failures (BackendUnavailable) and the last
    # retry-after hint handed to a caller.
    fast_failed: int = 0
    last_retry_after_s: Optional[float] = None
    # Series-rows served straight from the forecast plane vs computed.
    plane_hits: int = 0
    plane_misses: int = 0
    # Interval rows answered by the quantile plane's gather vs through
    # the row-local compute fallback.
    qplane_hits: int = 0
    qplane_misses: int = 0
    latencies_s: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_LATENCY_WINDOW)
    )
    # One (live, width, n_requests) triple per dispatched bucket.
    occupancy: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(
            maxlen=_OCCUPANCY_WINDOW
        )
    )
    # Host seconds per dispatch stage, summed (see the module docstring).
    stages: StageClock = dataclasses.field(default_factory=StageClock)

    def snapshot(self) -> Dict:
        lat = np.asarray(self.latencies_s, np.float64)
        pct = (lambda q: round(float(np.percentile(lat, q)) * 1e3, 3)) \
            if lat.size else (lambda q: None)
        fill = [n / w for n, w, _ in self.occupancy if w]
        reqs = [r for _, _, r in self.occupancy]
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "failed": self.failed,
            "rejected": self.rejected,
            "pumps": self.pumps,
            "dispatches": self.dispatches,
            "fast_failed": self.fast_failed,
            "retry_after_s": self.last_retry_after_s,
            "plane_hits": self.plane_hits,
            "plane_misses": self.plane_misses,
            "plane_hit_rate": (
                round(self.plane_hits
                      / (self.plane_hits + self.plane_misses), 4)
                if (self.plane_hits + self.plane_misses) else None
            ),
            "qplane_hits": self.qplane_hits,
            "qplane_misses": self.qplane_misses,
            "qplane_hit_rate": (
                round(self.qplane_hits
                      / (self.qplane_hits + self.qplane_misses), 4)
                if (self.qplane_hits + self.qplane_misses) else None
            ),
            "latency_ms": {
                "p50": pct(50), "p95": pct(95), "p99": pct(99),
                "mean": (round(float(lat.mean()) * 1e3, 3)
                         if lat.size else None),
                "max": (round(float(lat.max()) * 1e3, 3)
                        if lat.size else None),
            },
            "batch_occupancy": {
                "mean_fill": (round(float(np.mean(fill)), 4)
                              if fill else None),
                "mean_requests_per_dispatch": (
                    round(float(np.mean(reqs)), 2) if reqs else None
                ),
                "mean_requests_per_pump": (
                    round(self.completed / self.pumps, 2)
                    if self.pumps else None
                ),
            },
        }


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PredictionEngine:
    """Coalescing, cached, deadline-aware forecast server over a
    registry.

    ``pump`` drains and serves queued requests synchronously;
    ``start``/``stop`` run the same pump on a background thread.
    ``backend=None`` is the ``cuda`` backend on ``device`` (``None``:
    the card, which raises without one).

    ``recorder`` (``perf.PerfRecorder``) times each dispatch;
    ``retry_policy`` retries a failed dispatch on ``retry_on``;
    ``breaker`` is a circuit breaker over backend dispatch (open: the
    structured ``BackendUnavailable`` at once, no retries burned);
    ``registry_breaker`` the same gate over registry snapshot loads
    (open: the engine keeps serving the snapshot it holds).
    """

    def __init__(
        self,
        registry: ParamRegistry,
        backend: Optional[ForecastBackend] = None,
        max_queue: int = 1024,
        max_batch: int = 256,
        width_floor: int = 8,
        horizon_floor: int = 8,
        cache: Optional[ForecastCache] = None,
        device=None,
        recorder=None,
        retry_policy=None,
        retry_on: Tuple = (Exception,),
        breaker: Optional[CircuitBreaker] = None,
        registry_breaker: Optional[CircuitBreaker] = None,
    ):
        self.registry = registry
        self.backend = backend if backend is not None else get_backend(
            "cuda", registry.config, SolverConfig(), device=device
        )
        self.max_batch = int(max_batch)
        self.width_floor = int(width_floor)
        self.horizon_floor = int(horizon_floor)
        self.cache = cache if cache is not None else ForecastCache()
        self.recorder = recorder
        self.retry_policy = retry_policy
        self.retry_on = retry_on
        self.breaker = breaker
        self.registry_breaker = registry_breaker
        self.stats = EngineStats()
        self._queue: "queue.Queue[PendingForecast]" = queue.Queue(
            maxsize=int(max_queue)
        )
        self._snapshot: Optional[Snapshot] = None
        self._manifest_key: Optional[Tuple[int, ...]] = None
        self._active_seen: Optional[int] = None
        # A snapshot loaded ahead of its activation (``prefetch``): the
        # next refresh that finds it matching the active pointer swaps
        # it in without a disk load.
        self._prefetched: Optional[Snapshot] = None
        # Attached forecast and quantile planes, version-keyed; None
        # memoizes an absent or refused plane, so a plane-less version
        # costs one probe.
        self._planes: Dict[int, Optional[fplane.FPlaneView]] = {}
        self._qplanes: Dict[int, Optional[object]] = {}
        self._pump_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Metric handles resolved once: the hot path pays one locked add
        # per outcome, no dict lookups.
        self._m_req = {
            r: METRICS.counter("tsspark_serve_requests_total", result=r)
            for r in ("completed", "shed", "failed", "rejected")
        }
        self._m_latency = METRICS.histogram(
            "tsspark_serve_request_seconds"
        )
        self._m_dispatches = METRICS.counter(
            "tsspark_serve_dispatches_total"
        )
        self._m_plane = {
            r: METRICS.counter("tsspark_serve_plane_reads_total",
                               result=r)
            for r in ("hit", "miss")
        }
        self._m_queue = METRICS.gauge("tsspark_serve_queue_depth")
        # Live breaker state: 0 closed, 1 open/half-open, updated at
        # every dispatch outcome; and the seconds until the open breaker
        # admits a trial (the retry-after hint).
        self._m_breaker = METRICS.gauge("tsspark_serve_breaker_open")
        self._m_retry_after = METRICS.gauge(
            "tsspark_serve_retry_after_seconds"
        )
        # In-process activations invalidate immediately; refresh() also
        # polls the manifest so cross-process flips are picked up.
        registry.subscribe(self._on_activate)

    def _obs_request(self, pend: PendingForecast, status: str,
                     **attrs) -> None:
        """One ``serve.request`` span per resolved request, admission to
        completion (the same clock as the latency percentiles)."""
        if not obs.active():
            return
        dur = time.monotonic() - pend.submitted_s
        req = pend.request
        obs.record("serve.request", pend.submitted_unix, dur,
                   status=status, n_series=len(req.series_ids),
                   horizon=req.horizon, **attrs)

    def _fail_pend(self, pend: PendingForecast, error: BaseException,
                   reason: str, **attrs) -> None:
        pend._fail(error)
        self.stats.failed += 1
        self._m_req["failed"].inc()
        self._obs_request(pend, "err", reason=reason, **attrs)

    # -- snapshot lifecycle ----------------------------------------------------

    def _on_activate(self, version: Optional[int]) -> None:
        if version is not None:
            self._carry_cache_forward(version)
        self.cache.invalidate(version)
        # A single store to None; refresh() reads the slot through a
        # local, so a pump in flight keeps a coherent snapshot.
        self._snapshot = None

    def _carry_cache_forward(self, new_version: int) -> None:
        """Partial cache invalidation on a DELTA flip: unchanged series'
        parameters are the base version's bits, so their cached
        forecasts migrate to the new version instead of being dropped
        (``ForecastCache.carry_forward``).  Runs before the
        ``invalidate`` that settles the flip; a full publish (no delta
        metadata) keeps the drop-everything behavior."""
        try:
            info = self.registry.delta_info(int(new_version))
        except Exception:
            return  # torn or racing manifest: the full drop
        if not info or info.get("base_version") is None:
            return
        self.cache.carry_forward(
            info["base_version"], int(new_version),
            set(info.get("changed_ids") or ()),
        )

    def refresh(self) -> Snapshot:
        """The current active snapshot, reloading on version flips.

        The steady state stays off the manifest JSON: an unchanged stat
        key proves the active pointer cannot have moved.  Reloads compare
        the ACTIVE pointer, not the loaded snapshot's version: after a
        fallback to the last good version the two legitimately differ."""
        key = self.registry.manifest_key()
        snap = self._snapshot
        if snap is not None and key == self._manifest_key:
            return snap
        active = self.registry.active_version()
        if snap is None or active != self._active_seen:
            pre = self._prefetched
            if pre is not None and active == pre.version:
                # The flip was prefetched (pool warm / materialize):
                # swap it in without touching the disk.
                loaded: Optional[Snapshot] = pre
                self._prefetched = None
            else:
                loaded = self._load_active()
            if loaded is None:
                # Registry breaker open: serve the held snapshot and do
                # NOT advance the seen markers, so the next pump retries
                # the load once the breaker's window elapses.
                return snap
            self._carry_cache_forward(loaded.version)
            self.cache.invalidate(loaded.version)
            self._snapshot = loaded
            self._active_seen = active
            snap = loaded
            # Probe the new version's planes at the flip (the attach CRC
            # sweep doubles as page warming); a torn or absent plane
            # memoizes None and compute serves.
            self._plane_for(snap.version)
            self._qplane_for(snap.version)
        self._manifest_key = key
        return snap

    def _load_active(self) -> Optional[Snapshot]:
        """Registry load guarded by ``registry_breaker``.  Returns None
        while the breaker refuses the load AND a snapshot is held (one
        version behind beats nothing; the caller leaves its staleness
        markers alone so the load is retried after the window); with
        nothing held the refusal is a structured RegistryError."""
        br = self.registry_breaker
        if br is not None and not br.allow():
            if self._snapshot is not None:
                return None
            raise RegistryError(
                "circuit-open",
                f"registry load suppressed by open breaker; retry in "
                f"{br.retry_after_s():.2f}s",
            )
        try:
            snap = self.registry.load()
        except BaseException:
            # BaseException: a half-open trial slot must be resolved even
            # on KeyboardInterrupt, or the breaker wedges.
            if br is not None:
                br.record_failure()
            raise
        if br is not None:
            br.record_success()
        return snap

    # -- version discipline (pool support) -------------------------------------

    def served_version(self) -> Optional[int]:
        """The version the engine is serving (None before the first
        refresh)."""
        snap = self._snapshot
        return None if snap is None else snap.version

    def prefetch(self, version: int) -> Snapshot:
        """Load ``version`` ahead of its activation and stash it: the
        refresh that later finds the active pointer at this version swaps
        it in with no disk load.  Explicit version, no fallback."""
        snap = self.registry.load(int(version), fallback=False)
        # A single reference store: a refresh racing it at worst drops
        # the stash and pays one disk load on the flip.
        self._prefetched = snap
        return snap

    def ensure_version(self, version: int) -> bool:
        """Force the engine onto ``version`` if the registry's active
        pointer agrees: drops the staleness markers and reloads when the
        served version differs.  True when the engine now serves exactly
        ``version`` (False when the active pointer is elsewhere; the
        caller decides whether that is a mismatch).  Serialized against
        the pump."""
        version = int(version)
        with self._pump_lock:
            try:
                snap = self.refresh()
            except Exception:
                snap = None
            if snap is not None and snap.version == version:
                return True
            self._snapshot = None
            self._manifest_key = None
            self._active_seen = None
            try:
                snap = self.refresh()
            except Exception:
                return False
            return snap is not None and snap.version == version

    def materialize(self, series_ids: Sequence, horizons: Sequence[int],
                    version: Optional[int] = None, num_samples: int = 0,
                    seed: int = 0, max_width: int = 256) -> int:
        """Ahead-of-time forecasts for ``series_ids`` x ``horizons`` into
        the version-keyed cache, against ``version`` (prefetching its
        snapshot) or the active one: the pool's activate path lands a
        flip on a warm cache this way.  Idempotent (cached rows are
        skipped); plane-covered buckets are left to the plane.  Returns
        the series-rows computed."""
        if version is None:
            with self._pump_lock:
                snap = self.refresh()
        else:
            pre = self._prefetched
            snap = (pre if pre is not None
                    and pre.version == int(version)
                    else self.prefetch(version))
        self.cache.allow_version(snap.version)
        # A delta flip: carry the unchanged series' rows into the warm
        # window first, so the loop below computes only the refitted
        # ones.  Only for a version this engine does not serve yet.
        if snap.version != self.served_version():
            self._carry_cache_forward(snap.version)
        ids = list(dict.fromkeys(str(s) for s in series_ids))
        _, missing = snap.rows(ids)
        absent = set(missing)
        ids = [s for s in ids if s not in absent]
        # A fresh plane probe: warming runs at flip or retry time, when a
        # just-published (or re-published) plane should be adopted.
        self.attach_plane(snap.version)
        view = self._plane_for(snap.version)
        warmed = 0
        for h in horizons:
            hb = max(self.horizon_floor, next_pow2(int(h)))
            if view is not None and view.covers(hb, num_samples):
                continue  # every replica reads it from the shared pages
            todo = [
                s for s in ids
                if self.cache.peek((snap.version, s, hb, num_samples,
                                    seed)) is None
            ]
            for i in range(0, len(todo), int(max_width)):
                part = todo[i:i + int(max_width)]
                fresh = self._dispatch(snap, part, hb, num_samples,
                                       seed, n_requests=0)
                for sid, row in fresh.items():
                    self.cache.put(
                        (snap.version, sid, hb, num_samples, seed), row
                    )
                    warmed += 1
        return warmed

    # -- request intake --------------------------------------------------------

    def submit(self, request: ForecastRequest) -> PendingForecast:
        pend = PendingForecast(request)
        try:
            self._queue.put_nowait(pend)
        except queue.Full:
            self.stats.rejected += 1
            self._m_req["rejected"].inc()
            self._obs_request(pend, "err", reason="overloaded")
            raise EngineOverloaded(
                f"request queue full ({self._queue.maxsize})"
            )
        self.stats.submitted += 1
        return pend

    def forecast(self, series_ids: Sequence, horizon: int,
                 num_samples: int = 0, seed: int = 0,
                 deadline_in_s: Optional[float] = None,
                 timeout_s: Optional[float] = 60.0) -> ForecastResult:
        """Synchronous convenience: submit + serve (pumping inline when
        no background worker is running)."""
        pend = self.submit(ForecastRequest.make(
            series_ids, horizon, num_samples=num_samples, seed=seed,
            deadline_in_s=deadline_in_s,
        ))
        if self._thread is None:
            while not pend.done():
                self.pump(block_s=0.0)
        return pend.result(timeout=timeout_s)

    # -- the batch loop --------------------------------------------------------

    def pump(self, max_batch: Optional[int] = None,
             block_s: float = 0.0) -> int:
        """Drain up to one batch of queued requests and serve it.
        Returns the number of requests resolved (served, shed, or
        failed).  ``block_s``: how long to wait for the FIRST request
        (coalescing window); once one arrives, everything already
        queued joins its batch."""
        with self._pump_lock:
            batch: List[PendingForecast] = []
            cap = self.max_batch if max_batch is None else int(max_batch)
            try:
                batch.append(self._queue.get(
                    block=block_s > 0, timeout=block_s or None
                ))
            except queue.Empty:
                return 0
            while len(batch) < cap:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            self.stats.pumps += 1
            self._m_queue.set(self._queue.qsize())
            try:
                snap = self.refresh()
            except Exception as e:
                for pend in batch:
                    self._fail_pend(pend, e, "refresh")
                return len(batch)
            now = time.monotonic()
            groups: Dict[Tuple[int, int, int], List[PendingForecast]] = {}
            resolved = 0
            for pend in batch:
                req = pend.request
                if req.deadline_s is not None and now > req.deadline_s:
                    pend._fail(RequestShed(req.deadline_s, now))
                    self.stats.shed += 1
                    self._m_req["shed"].inc()
                    self._obs_request(pend, "err", reason="shed")
                    resolved += 1
                    continue
                hb = max(self.horizon_floor, next_pow2(req.horizon))
                groups.setdefault(
                    (hb, req.num_samples, req.seed), []
                ).append(pend)
            for (hb, n_s, seed), pends in groups.items():
                try:
                    resolved += self._dispatch_group(snap, hb, n_s,
                                                     seed, pends)
                except Exception as e:
                    # A group whose dispatch escapes must fail ITS OWN
                    # pends, never leave submitters blocked.
                    for pend in pends:
                        if not pend.done():
                            self._fail_pend(pend, e, "pump-escape")
                            resolved += 1
            return resolved

    def _dispatch_group(self, snap: Snapshot, hb: int, num_samples: int,
                        seed: int, pends: List[PendingForecast]) -> int:
        """Serve one (horizon-bucket, num_samples, seed) group: resolve
        the cache, dispatch ONE padded predict for the misses, scatter,
        assemble per request."""
        version = snap.version
        rows: Dict[str, Dict] = {}      # sid -> per-series row dict
        hits: Dict[str, bool] = {}
        needed: List[str] = []          # unique cache misses, in order
        needed_set = set()
        row_idx: Dict[str, int] = {}    # miss sid -> snapshot row
        live: List[PendingForecast] = []
        for pend in pends:
            if not pend.request.series_ids:
                # Direct ForecastRequest construction bypasses make()'s
                # validation; an empty request must fail alone.
                self._fail_pend(pend,
                                ValueError("series_ids must be non-empty"),
                                "empty-request")
                continue
            idx, missing = snap.rows(pend.request.series_ids)
            if missing:
                self._fail_pend(pend, UnknownSeries(missing, version),
                                "unknown-series", version=version)
                continue
            live.append(pend)
            # With nothing missing, rows() returns one index per id in
            # input order, so the plane gather below reuses them.
            for sid, r in zip(pend.request.series_ids, idx):
                if sid in rows or sid in needed_set:
                    continue
                val = self.cache.get((version, sid, hb, num_samples, seed))
                if val is None:
                    needed.append(sid)
                    needed_set.add(sid)
                    row_idx[sid] = r
                else:
                    rows[sid] = val
                    hits[sid] = True
        batch = None                    # (grid, gathered, pos) fast path
        if needed:
            # Forecast-plane fast path: a deterministic group whose
            # bucket the plane covers is a memmap gather, no dispatch.
            # Not inserted into the cache: the plane is the shared
            # cache.  Other buckets and sampled requests are computed.
            view = self._plane_for(version)
            if view is not None and view.covers(hb, num_samples):
                pidx = np.fromiter((row_idx[s] for s in needed),
                                   np.int64, len(needed))
                if not rows:
                    # Every series of the group is answered by this one
                    # gather: the batch arrays serve it whole.
                    grid, gathered = fplane.plane_batch(view, snap, pidx,
                                                        hb)
                    batch = (grid, gathered,
                             {s: i for i, s in enumerate(needed)})
                else:
                    served = fplane.plane_rows(view, snap, pidx, hb)
                    for sid, row in zip(needed, served):
                        rows[sid] = row
                        hits[sid] = True
                self.stats.plane_hits += len(needed)
                self._m_plane["hit"].inc(len(needed))
                self.cache.note_plane_hits(len(needed))
                needed = []
            else:
                self.stats.plane_misses += len(needed)
                self._m_plane["miss"].inc(len(needed))
        if needed:
            try:
                fresh = self._dispatch(snap, needed, hb, num_samples,
                                       seed, n_requests=len(live))
            except Exception as e:
                reason = (e.reason if isinstance(e, ServeError)
                          else type(e).__name__)
                for pend in live:
                    self._fail_pend(pend, e, reason, version=version)
                return len(pends)
            # An activation landing during the dispatch invalidates the
            # cache, and the cache's version gate drops these late
            # inserts for the retired version.
            for sid, row in fresh.items():
                rows[sid] = row
                self.cache.put((version, sid, hb, num_samples, seed), row)
        with self.stats.stages.span("assemble"):
            results = []
            for pend in live:
                req = pend.request
                h = req.horizon
                sids = req.series_ids
                if batch is not None:
                    grid, gathered, pos = batch
                    sel = [pos[s] for s in sids]
                    ds = grid[sel][:, :h]
                    values = {k: v[sel][:, :h] for k, v in gathered.items()}
                else:
                    values = {
                        k: np.stack([rows[s][k] for s in sids])[:, :h]
                        for k in rows[sids[0]] if k != "ds"
                    }
                    ds = np.stack([rows[s]["ds"] for s in sids])[:, :h]
                results.append((pend, values, ds))
        done_s = time.monotonic()
        for pend, values, ds in results:
            sids = pend.request.series_ids
            pend._complete(ForecastResult(
                series_ids=sids,
                ds=ds,
                values=values,
                version=version,
                latency_s=done_s - pend.submitted_s,
                from_cache=(len(sids) if batch is not None
                            else sum(1 for s in sids if hits.get(s))),
            ))
            self.stats.completed += 1
            self.stats.latencies_s.append(done_s - pend.submitted_s)
            self._m_req["completed"].inc()
            self._m_latency.observe(done_s - pend.submitted_s)
            if obs.active():
                obs.record(
                    "serve.request", pend.submitted_unix,
                    done_s - pend.submitted_s, version=version,
                    n_series=len(sids), horizon=pend.request.horizon,
                )
        return len(pends)

    def _dispatch(self, snap: Snapshot, sids: List[str], hb: int,
                  num_samples: int, seed: int,
                  n_requests: int) -> Dict[str, Dict]:
        """One padded ``backend.predict`` over the missing series."""
        stages = self.stats.stages
        with stages.span("gather"):
            idx, _ = snap.rows(sids)
            n = len(sids)
            width = compacted_width(n, floor=self.width_floor)
            if width > n:
                idx = np.concatenate([idx, np.repeat(idx[:1], width - n)])
            state, step = snap.take(idx)
            # Each series continues its own calendar at its recorded
            # cadence: one float64 broadcast, no history scans.
            last = np.asarray(state.meta.ds_start + state.meta.ds_span,
                              np.float64)
            grid = last[:, None] + step[:, None] * np.arange(1, hb + 1)

        def run():
            faults.inject("serve_predict")
            # backend.predict returns host arrays: the timed scope
            # covers the device work.
            return self.backend.predict(
                state, grid, num_samples=num_samples, seed=seed
            )

        # Dispatch circuit breaker: a backend that keeps failing sheds
        # this dispatch fast (structured error, no retries burned); each
        # dispatch is ONE breaker outcome, whatever the retries inside.
        if self.breaker is not None and not self.breaker.allow():
            retry_after = self.breaker.retry_after_s()
            self.stats.fast_failed += 1
            self.stats.last_retry_after_s = round(retry_after, 3)
            self._m_breaker.set(1.0)
            self._m_retry_after.set(retry_after)
            raise BackendUnavailable(self.breaker.name, retry_after)
        ctx = (self.recorder.dispatch(width, live=n, kind="predict")
               if self.recorder is not None else contextlib.nullcontext())
        # ok-flag + finally: even a BaseException escape must resolve the
        # breaker's half-open trial slot, or the breaker wedges.
        ok = False
        t_disp0 = time.time()
        m_disp0 = time.monotonic()
        try:
            with stages.span("predict"), ctx:
                if self.retry_policy is not None:
                    out = self.retry_policy.call(run,
                                                 retry_on=self.retry_on)
                else:
                    out = run()
            ok = True
        finally:
            if self.breaker is not None:
                (self.breaker.record_success if ok
                 else self.breaker.record_failure)()
                closed = self.breaker.state == CircuitBreaker.CLOSED
                self._m_breaker.set(0.0 if closed else 1.0)
                self._m_retry_after.set(
                    0.0 if closed else self.breaker.retry_after_s()
                )
            if obs.active():
                obs.record("serve.dispatch", t_disp0,
                           time.monotonic() - m_disp0,
                           status="ok" if ok else "err",
                           width=width, live=n, horizon=hb,
                           version=snap.version)
        self.stats.dispatches += 1
        self._m_dispatches.inc()
        self.stats.occupancy.append((n, width, n_requests))
        with stages.span("scatter"):
            result: Dict[str, Dict] = {}
            for i, sid in enumerate(sids):
                row = {k: v[i] for k, v in out.items()}
                row["ds"] = grid[i]
                result[sid] = row
        return result

    # -- forecast plane (point reads) ------------------------------------------

    def _plane_for(self, version: int) -> Optional[fplane.FPlaneView]:
        """The attached forecast plane of ``version``, or None (absent,
        torn or corrupt: memoized, and the compute path serves)."""
        version = int(version)
        if version in self._planes:
            return self._planes[version]
        view = None
        try:
            vdir = self.registry.version_dir(version)
            if fplane.has_plane(vdir):
                view = fplane.attach(vdir)
        except fplane.ForecastPlaneError as e:
            obs.event("fplane.rejected", version=version,
                      reason=e.reason, detail=str(e))
        except OSError as e:
            obs.event("fplane.attach_failed", version=version,
                      error=repr(e))
        self._planes[version] = view
        while len(self._planes) > 4:
            self._planes.pop(next(iter(self._planes)))
        return view

    def attach_plane(self, version: int) -> bool:
        """Re-probe ``version``'s forecast plane, dropping any memoized
        refusal first (a publish retried after a tear is picked up)."""
        self._planes.pop(int(version), None)
        return self._plane_for(version) is not None

    # -- quantile plane (interval reads) ----------------------------------------

    def _qplane_for(self, version: int):
        """The attached quantile plane of ``version``, or None (absent,
        torn or corrupt: memoized, and intervals are computed)."""
        from tsspark_tpu_torch.uncertainty import qplane

        version = int(version)
        if version in self._qplanes:
            return self._qplanes[version]
        view = None
        try:
            vdir = self.registry.version_dir(version)
            if qplane.has_qplane(vdir):
                view = qplane.attach(vdir)
        except qplane.QuantilePlaneError as e:
            obs.event("qplane.rejected", version=version,
                      reason=e.reason, detail=str(e))
        except OSError as e:
            obs.event("qplane.attach_failed", version=version,
                      error=repr(e))
        self._qplanes[version] = view
        while len(self._qplanes) > 4:
            self._qplanes.pop(next(iter(self._qplanes)))
        return view

    def attach_qplane(self, version: int) -> bool:
        """Re-probe ``version``'s quantile plane, dropping any memoized
        refusal first (the pickup after a torn publish is retried)."""
        self._qplanes.pop(int(version), None)
        return self._qplane_for(version) is not None

    def quantiles(self, series_ids: Sequence, horizon: int,
                  quantiles: Optional[Sequence[float]] = None
                  ) -> ForecastResult:
        """Interval forecast: per-series quantile rows, from the version's
        quantile plane when it covers every requested (bucket, quantile)
        pair (a memmap gather, no device work), else through
        ``qplane.compute_rows`` (ADVI mode when the plane's spec says so
        and the posterior loads; MAP mode through ``backend.predict``,
        K1 on the card), which gives plane-covered cells the same bits.
        ``quantiles`` defaults to the plane's set (``DEFAULT_QUANTILES``
        without a plane).  Values are keyed ``"q<permille>"``;
        ``from_cache`` counts plane-served rows."""
        from tsspark_tpu_torch.uncertainty import advi as advi_mod
        from tsspark_tpu_torch.uncertainty import qplane

        t0 = time.monotonic()
        sids = [str(s) for s in series_ids]
        if not sids:
            raise ValueError("series_ids must be non-empty")
        with self._pump_lock:
            snap = self.refresh()
        version = snap.version
        idx, missing = snap.rows(sids)
        if missing:
            raise UnknownSeries(missing, version)
        h = int(horizon)
        hb = max(self.horizon_floor, next_pow2(h))
        view = self._qplane_for(version)
        qs = (tuple(float(q) for q in quantiles) if quantiles is not None
              else (view.quantiles if view is not None
                    else qplane.DEFAULT_QUANTILES))
        if view is not None and view.covers(hb, qs):
            grid, cols = qplane.quantile_batch(view, snap, idx, hb)
            self.stats.qplane_hits += len(sids)
            cached = len(sids)
        else:
            self.stats.qplane_misses += len(sids)
            posterior = None
            if view is not None and view.mode == "advi":
                loaded = advi_mod.load_posterior(
                    self.registry.version_dir(version))
                if loaded is not None:
                    posterior = loaded[0]
            cols = qplane.compute_rows(
                snap, self.registry.config, self.backend, idx, hb,
                quantiles=qs,
                draws=qplane.DEFAULT_DRAWS if view is None else view.draws,
                seed=qplane.DEFAULT_SEED if view is None else view.seed,
                posterior=posterior,
            )
            meta = snap.state.meta
            last = (np.asarray(meta.ds_start, np.float64)[idx]
                    + np.asarray(meta.ds_span, np.float64)[idx])
            step = np.asarray(snap.step, np.float64)[idx]
            grid = last[:, None] + step[:, None] * np.arange(1, hb + 1)
            cached = 0
        values = {f"q{qplane.permille(q):03d}":
                  cols[qplane.permille(q)][:, :h] for q in qs}
        return ForecastResult(
            series_ids=tuple(sids), ds=grid[:, :h], values=values,
            version=version, latency_s=time.monotonic() - t0,
            from_cache=cached,
        )

    # -- background worker -----------------------------------------------------

    def start(self, poll_s: float = 0.02) -> None:
        """Run ``pump`` on a daemon thread until ``stop``."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.pump(block_s=poll_s)
                except Exception:
                    # pump() resolves per-request failures itself; an
                    # escape here is a bug, but it must not kill the
                    # worker and leave every later submit hanging.
                    traceback.print_exc()
                    time.sleep(poll_s)

        self._thread = threading.Thread(
            target=loop, name="serve-pump", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout_s)
        self._thread = None
