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
refused when it is made; any other count is served.

``EngineStats.stages`` times the host stages of each dispatch: "gather"
(snapshot rows, padding, parameter take, future grid), "predict" (the
``backend.predict`` call, arrays back on the host), "scatter" (per-series
rows for the cache) and "assemble" (each request's arrays).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.backends.registry import ForecastBackend, get_backend
from tsspark_tpu_torch.config import SolverConfig
from tsspark_tpu_torch.parallel.sharding import compacted_width, next_pow2
from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.registry import ParamRegistry, Snapshot
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
    from_cache: int                   # series rows served by the LRU


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
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "failed": self.failed,
            "rejected": self.rejected,
            "pumps": self.pumps,
            "dispatches": self.dispatches,
            "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99)},
            "mean_fill": (round(float(np.mean(fill)), 4) if fill else None),
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
    ):
        self.registry = registry
        self.backend = backend if backend is not None else get_backend(
            "cuda", registry.config, SolverConfig(), device=device
        )
        self.max_batch = int(max_batch)
        self.width_floor = int(width_floor)
        self.horizon_floor = int(horizon_floor)
        self.cache = cache if cache is not None else ForecastCache()
        self.stats = EngineStats()
        self._queue: "queue.Queue[PendingForecast]" = queue.Queue(
            maxsize=int(max_queue)
        )
        self._snapshot: Optional[Snapshot] = None
        self._manifest_key: Optional[Tuple[int, ...]] = None
        self._active_seen: Optional[int] = None
        self._pump_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # In-process activations invalidate immediately; refresh() also
        # polls the manifest so cross-process flips are picked up.
        registry.subscribe(self._on_activate)

    # -- snapshot lifecycle ----------------------------------------------------

    def _on_activate(self, version: Optional[int]) -> None:
        self.cache.invalidate(version)
        # A single store to None; refresh() reads the slot through a
        # local, so a pump in flight keeps a coherent snapshot.
        self._snapshot = None

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
            snap = self.registry.load()
            self.cache.invalidate(snap.version)
            self._snapshot = snap
            self._active_seen = active
        self._manifest_key = key
        return snap

    # -- request intake --------------------------------------------------------

    def submit(self, request: ForecastRequest) -> PendingForecast:
        pend = PendingForecast(request)
        try:
            self._queue.put_nowait(pend)
        except queue.Full:
            self.stats.rejected += 1
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
            try:
                snap = self.refresh()
            except Exception as e:
                for pend in batch:
                    pend._fail(e)
                self.stats.failed += len(batch)
                return len(batch)
            now = time.monotonic()
            groups: Dict[Tuple[int, int, int], List[PendingForecast]] = {}
            resolved = 0
            for pend in batch:
                req = pend.request
                if req.deadline_s is not None and now > req.deadline_s:
                    pend._fail(RequestShed(req.deadline_s, now))
                    self.stats.shed += 1
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
                            pend._fail(e)
                            self.stats.failed += 1
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
        live: List[PendingForecast] = []
        for pend in pends:
            if not pend.request.series_ids:
                # Direct ForecastRequest construction bypasses make()'s
                # validation; an empty request must fail alone.
                pend._fail(ValueError("series_ids must be non-empty"))
                self.stats.failed += 1
                continue
            _, missing = snap.rows(pend.request.series_ids)
            if missing:
                pend._fail(UnknownSeries(missing, version))
                self.stats.failed += 1
                continue
            live.append(pend)
            for sid in pend.request.series_ids:
                if sid in rows or sid in needed_set:
                    continue
                val = self.cache.get((version, sid, hb, num_samples, seed))
                if val is None:
                    needed.append(sid)
                    needed_set.add(sid)
                else:
                    rows[sid] = val
                    hits[sid] = True
        if needed:
            try:
                fresh = self._dispatch(snap, needed, hb, num_samples,
                                       seed, n_requests=len(live))
            except Exception as e:
                for pend in live:
                    pend._fail(e)
                self.stats.failed += len(live)
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
                sids = req.series_ids
                values = {
                    k: np.stack([rows[s][k] for s in sids])[:, :req.horizon]
                    for k in rows[sids[0]] if k != "ds"
                }
                ds = np.stack([rows[s]["ds"] for s in sids])[:, :req.horizon]
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
                from_cache=sum(1 for s in sids if hits.get(s)),
            ))
            self.stats.completed += 1
            self.stats.latencies_s.append(done_s - pend.submitted_s)
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
        with stages.span("predict"):
            out = self.backend.predict(
                state, grid, num_samples=num_samples, seed=seed
            )
        self.stats.dispatches += 1
        self.stats.occupancy.append((n, width, n_requests))
        with stages.span("scatter"):
            result: Dict[str, Dict] = {}
            for i, sid in enumerate(sids):
                row = {k: v[i] for k, v in out.items()}
                row["ds"] = grid[i]
                result[sid] = row
        return result

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
