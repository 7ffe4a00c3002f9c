"""Streaming micro-batch refit driver (eval config 5) on the card.

Consume micro-batches from a source, keep per-series history windows,
and refit the touched series in one batched solve per micro-batch,
warm-started from the parameter store through the warm-start space
transfer (warmstart.py): the port of the JAX package's
``streaming/driver.py``, with the same flow and the same stats.

Per-series history lives in the native ingest engine
(``tsspark_tpu_torch.native.HistoryStore``, C++ via ctypes): bounded
sorted dedup-append on ingest and threaded padded materialization on
refit — the host-side hot path of the loop.

Flow per micro-batch:
  1. absorb new rows into the native history store (sorted, dedup, bounded)
  2. materialize touched series onto their union grid (collect)
  3. ridge init of the batch on the device; look up stored params ->
     transfer into the new scaling space (on the device) -> blend by the
     found-mask (cold data-driven init for unseen series)
  4. batched fit with a small iteration budget (``CudaBackend.fit``: K3
     and K4 on the card)
  5. write refreshed params back to the store (scatter)

The fit takes the union grid rounded through float32, as the JAX
package's driver hands it over (the same values on integer-day grids;
at sub-daily cadence epoch days move by up to ~1.4 minutes, and the
stored ``ds_start`` is the rounded first timestamp, as the reference's);
``design.py`` then maps it in float64 on the host.  The cadence
(``median_steps``) and the forecast's grid stay float64.

``stages`` times the driver's own steps (absorb, union_grid,
materialize, prep, initial_theta, lookup, transfer_theta, update), each
waiting for the device; ``stats.batch_stages`` keeps one dict per
micro-batch of those and the backend's stages (``backend.prep``, ...).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from tsspark_tpu_torch import native
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import ProphetConfig, SolverConfig
from tsspark_tpu_torch.frame import _days_to_ts, _ds_to_days
from tsspark_tpu_torch.models.prophet.design import (
    fitdata_to_device,
    prepare_fit_data,
)
from tsspark_tpu_torch.models.prophet.init import initial_theta
from tsspark_tpu_torch.models.prophet.model import FitState
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
from tsspark_tpu_torch.resilience.policy import RetryPolicy
from tsspark_tpu_torch.streaming.source import (
    MicroBatchSource,
    ResilientSource,
)
from tsspark_tpu_torch.streaming.state import ParamStore
from tsspark_tpu_torch.streaming.warmstart import transfer_theta
from tsspark_tpu_torch.utils.spans import StageClock


def median_steps(grid: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-series median observed cadence (days) over one union grid.

    ``y`` is the (B, T) materialized batch with NaN holes; a series'
    cadence is the median gap between ITS observed grid points.  One
    vectorized pass — sorting NaN-masked grid copies pushes the holes to
    the tail so the finite diffs are exactly the per-series gaps.  Rows
    with fewer than two observations get the daily default (1.0).
    """
    y = np.asarray(y)
    obs_ = np.isfinite(y)
    step = np.ones(y.shape[0])
    rows = np.flatnonzero(obs_.sum(axis=1) > 1)
    if rows.size:
        g = np.where(obs_[rows], np.asarray(grid, np.float64)[None, :],
                     np.nan)
        # Grid is ascending, so sorting only moves the NaNs to the tail.
        d = np.diff(np.sort(g, axis=1), axis=1)
        step[rows] = np.nanmedian(d, axis=1)
    return step


@dataclass
class RefitStats:
    micro_batches: int = 0
    rows_ingested: int = 0
    series_refit: int = 0
    warm_starts: int = 0
    cold_starts: int = 0
    fit_seconds: float = 0.0
    last_batch_seconds: float = 0.0
    # Per-micro-batch refit wall seconds, in arrival order: the latency
    # distribution is the streaming SLO (eval config 5 records mean/p50/
    # max from it).
    batch_seconds: List[float] = field(default_factory=list)
    # Per micro-batch, host seconds by stage: the driver's own and the
    # backend's (prefixed "backend.").
    batch_stages: List[Dict[str, float]] = field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamingForecaster:
    """Incremental refitter over a micro-batch source."""

    def __init__(
        self,
        config: ProphetConfig = ProphetConfig(),
        solver_config: SolverConfig = SolverConfig(max_iters=40),
        backend: str = "cuda",
        max_history: int = 4096,
        id_col: str = "series_id",
        ds_col: str = "ds",
        y_col: str = "y",
        store: Optional[ParamStore] = None,
        warm_start: bool = True,
        autotune_state: Optional[str] = None,
        engine=None,
        **backend_kwargs,
    ):
        """``backend="cuda"`` runs on the card (``device="cpu"`` in
        ``backend_kwargs`` is the only way onto the CPU).

        ``warm_start=False`` disables the parameter-store transfer:
        every refit starts from the ridge init as if the series were new
        (the warm-vs-cold comparison eval config 5 records).

        ``autotune_state``: path to a persisted chunk-autotuner state
        (``autotune.json``); the backend starts at its LEARNED chunk
        width.  An explicit ``chunk_size`` in ``backend_kwargs`` wins; a
        missing or corrupt file is ignored (it is pure cache).

        ``engine``: a serve-side ``PredictionEngine``.  When attached,
        :meth:`forecast` routes through it; it reads the last PUBLISHED
        registry version, so keep it fresh with :meth:`publish`."""
        if autotune_state is not None and "chunk_size" not in backend_kwargs:
            from tsspark_tpu_torch.perf.autotune import load_learned_chunk

            learned = load_learned_chunk(autotune_state)
            if learned:
                backend_kwargs["chunk_size"] = learned
        self.config = config
        self.backend = get_backend(backend, config, solver_config,
                                   **backend_kwargs)
        self.device = getattr(self.backend, "device", torch.device("cpu"))
        self.store = store if store is not None else ParamStore(config)
        self.warm_start = warm_start
        self.max_history = max_history
        self.id_col, self.ds_col, self.y_col = id_col, ds_col, y_col
        self._hist = native.HistoryStore(max_history)
        self._code_of: Dict[str, int] = {}
        self._ds_was_datetime = False
        self.engine = engine
        self.stats = RefitStats()
        self.stages = StageClock()

    def attach_engine(self, engine) -> None:
        """Route subsequent :meth:`forecast` calls through ``engine``
        (``None`` detaches and restores the direct store read)."""
        self.engine = engine

    # -- ingestion -------------------------------------------------------------

    def _codes(self, sids) -> np.ndarray:
        out = np.empty(len(sids), np.int64)
        for i, sid in enumerate(sids):
            out[i] = self._code_of.setdefault(str(sid), len(self._code_of))
        return out

    def _absorb(self, batch: pd.DataFrame) -> List[str]:
        if not np.issubdtype(batch[self.ds_col].dtype, np.number):
            self._ds_was_datetime = True
        days = _ds_to_days(batch[self.ds_col])
        sids = batch[self.id_col].astype(str).to_numpy()
        self._hist.append(
            self._codes(sids), days, batch[self.y_col].to_numpy(np.float64)
        )
        self.stats.rows_ingested += len(batch)
        return list(dict.fromkeys(sids))  # unique, input order

    # -- refit -----------------------------------------------------------------

    def process(self, batch: pd.DataFrame) -> None:
        """Ingest one micro-batch and refit every touched series."""
        t0 = time.time()
        clock, dev = self.stages, self.device
        own0 = dict(clock.seconds)
        bk_stages = getattr(self.backend, "stages", None)
        bk0 = dict(bk_stages.seconds) if bk_stages is not None else {}
        with clock.span("absorb"):
            touched = self._absorb(batch)
            codes = self._codes(touched)
        with clock.span("union_grid"):
            grid = self._hist.union_grid(codes)
        with clock.span("materialize"):
            y = self._hist.materialize(codes, grid)  # (B, T), NaN holes
            # The fit's grid and observations in float32, as the JAX
            # package's driver hands them over (jnp.asarray with x64
            # off); median_steps keeps the float64 grid, as there.
            grid32 = grid.astype(np.float32)
            y32 = y.astype(np.float32)

        with clock.span("prep"):
            data, meta = prepare_fit_data(grid32, y32, self.config)
            data = fitdata_to_device(data, dev)
        # Cold-start series get the same ridge warm start the batch path
        # uses; warm series are overwritten by the transferred params.
        with clock.span("initial_theta"):
            theta0 = initial_theta(data, self.config,
                                   self.backend.solver_config)
            _sync(dev)
        del data
        if self.warm_start:
            with clock.span("lookup"):
                old_theta, old_meta, found = self.store.lookup(touched)
            if old_theta is not None:
                with clock.span("transfer_theta"):
                    warm = transfer_theta(old_theta, old_meta, meta,
                                          self.config, device=dev)
                    theta0 = torch.where(
                        torch.from_numpy(found).to(dev)[:, None], warm,
                        theta0)
                    _sync(dev)
        else:
            found = np.zeros(len(touched), bool)
        state = self.backend.fit(grid32, y32, init=theta0)
        # Cadence is recorded WITH the refreshed params so the forecast
        # path never re-derives it from history (see median_steps).
        with clock.span("update"):
            self.store.update(touched, state, step=median_steps(grid, y))

        dt = time.time() - t0
        stages = {k: v - own0.get(k, 0.0) for k, v in clock.seconds.items()
                  if v - own0.get(k, 0.0) > 0.0}
        if bk_stages is not None:
            stages.update({f"backend.{k}": v - bk0.get(k, 0.0)
                           for k, v in bk_stages.seconds.items()
                           if v - bk0.get(k, 0.0) > 0.0})
        self.stats.micro_batches += 1
        self.stats.series_refit += len(touched)
        self.stats.warm_starts += int(found.sum())
        self.stats.cold_starts += int((~found).sum())
        self.stats.fit_seconds += dt
        self.stats.last_batch_seconds = dt
        self.stats.batch_seconds.append(dt)
        self.stats.batch_stages.append(stages)
        if obs.active():
            obs.record("stream.batch", t0, dt, rows=int(len(batch)),
                       touched=len(touched), warm=int(found.sum()),
                       cold=int((~found).sum()))
            METRICS.counter("tsspark_stream_batches_total").inc()
            METRICS.counter("tsspark_stream_rows_total").inc(len(batch))
            METRICS.histogram("tsspark_stream_batch_seconds").observe(dt)

    def run(self, source: MicroBatchSource,
            max_batches: Optional[int] = None,
            poll_policy: Optional[RetryPolicy] = None,
            poll_breaker=None) -> RefitStats:
        """Drain the source (or up to ``max_batches``).

        ``poll_policy``: wrap the source so transient poll failures are
        retried with backoff (``resilience.policy.RetryPolicy``) instead
        of killing the driver mid-stream; commits still happen only after
        a refit lands, so retries preserve at-least-once delivery.
        ``poll_breaker`` (``resilience.policy.CircuitBreaker``) rides
        along: a broker that keeps failing across polls is shed fast
        with ``CircuitOpen``."""
        if poll_policy is not None:
            source = ResilientSource(source, poll_policy,
                                     breaker=poll_breaker)
        n = 0
        for batch in source:
            self.process(batch)
            # At-least-once: acknowledge offsets only once the refit has
            # landed in the store (see MicroBatchSource.commit).
            source.commit()
            n += 1
            if max_batches is not None and n >= max_batches:
                break
        return self.stats

    def perf_report(self):
        """The backend's cumulative per-dispatch telemetry
        (``perf.PerfReport``), or None when the backend carries no
        recorder: pass ``perf=PerfRecorder()`` through the backend
        keywords to turn it on."""
        rec = getattr(self.backend, "perf", None)
        return rec.report() if rec is not None else None

    # -- forecasting out of the store ------------------------------------------

    def publish(self, registry, activate: bool = True) -> int:
        """Publish the current parameter store into a serve registry
        (one new version; see ParamStore.publish)."""
        return self.store.publish(registry, activate=activate)

    def forecast(self, series_ids: Sequence, horizon: int,
                 num_samples: Optional[int] = None) -> pd.DataFrame:
        """Forecast from the latest stored parameters (no refit).

        With an attached serve engine the request rides the shared
        micro-batched read path; otherwise it reads the store directly
        (``backend.predict``: K1, and K2 when samples are asked for).
        Either way, unknown series raise ``KeyError`` — the engine serves
        the PUBLISHED registry snapshot, the direct path this driver's
        live store.
        """
        ids = [str(s) for s in series_ids]
        if self.engine is not None:
            from tsspark_tpu_torch.serve.engine import UnknownSeries

            try:
                res = self.engine.forecast(
                    ids, horizon,
                    num_samples=(self.config.uncertainty_samples
                                 if num_samples is None else num_samples),
                )
            except UnknownSeries as e:
                raise KeyError(
                    f"no fitted params for series: "
                    f"{list(e.missing)[:5]} (registry version "
                    f"{e.version}; publish() to refresh)"
                ) from e
            return self._frame(ids, horizon, res.ds, res.values)
        missing = [s for s in ids if s not in self.store]
        if missing:
            raise KeyError(f"no fitted params for series: {missing[:5]}")
        theta, meta, _ = self.store.lookup(ids)
        n = len(ids)
        state = FitState(
            theta=theta, meta=meta,
            loss=np.zeros(n, np.float32), grad_norm=np.zeros(n, np.float32),
            converged=np.ones(n, bool), n_iters=np.zeros(n, np.int32),
        )
        # Continue each series' own calendar at its recorded cadence: one
        # broadcast, host float64 into prepare_predict_data's time map.
        last = np.asarray(meta.ds_start + meta.ds_span)
        step = self.store.lookup_step(ids)
        grid = last[:, None] + step[:, None] * np.arange(1, horizon + 1)
        fc = self.backend.predict(state, grid, num_samples=num_samples)
        return self._frame(ids, horizon, grid, fc)

    def _frame(self, ids, horizon: int, grid, fc) -> pd.DataFrame:
        """Long-frame view of a (B, H) forecast dict (shared by the
        direct and engine-routed read paths)."""
        ds_out = np.asarray(grid).reshape(-1)
        if self._ds_was_datetime:
            ds_out = _days_to_ts(ds_out)
        rows = {
            self.id_col: np.repeat(ids, horizon),
            self.ds_col: ds_out,
        }
        for k, v in fc.items():
            rows[k] = np.asarray(v).reshape(-1)
        return pd.DataFrame(rows)
