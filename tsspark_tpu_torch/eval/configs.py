"""The port's evaluation configs: eval config 1 (one long daily series),
eval config 2 (414 ragged hourly series), eval config 3 (M5 retail, the
headline), eval config 4 (logistic growth with a known capacity) and eval
config 5 (streaming micro-batch refit with warm starts).

``config1_peyton`` builds ``peyton_manning_like`` (2,905 days; ``scale``
shrinks the days, 200 at least) under yearly order 10 + weekly order 3
and 25 changepoints; ``config2_m4_hourly`` builds ``m4_hourly_like``
(414 hourly series of 700-960 hours, right-aligned on one grid;
``scale`` shrinks the series count) under daily order 4 + weekly order
3 and 10 changepoints.  ``config3_m5`` builds ``m5_like`` (30,490 daily series over 1,941 days
with holiday, price and promo regressors; ``scale`` shrinks the series
count); ``config4_wiki_logistic`` builds ``wiki_logistic_like`` (8
saturating series over 1,200 days at scale 1; ``scale`` multiplies the
count: 1,024 gives 8,192).  Each fits the first 90% of every series
through the chosen backend (``"cuda"`` on the card by default),
forecasts the whole calendar and scores sMAPE on the training span and
on the held-out tail.  ``config5_streaming`` streams 50 daily series
(730 days: a 510-day base batch — int(730 * 0.7) in floating point —
then three micro-batches of 73 days)
through ``streaming.StreamingForecaster``, warm and cold, then replays
the last micro-batch; it scores the 14-day forecast against the
noise-free generator.

Usage:  python -m tsspark_tpu_torch.eval.configs [{1,2,3,4,5}]
            [--scale S] [--backend B] [--device D]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    RegressorConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data.datasets import (
    m4_hourly_like,
    m5_like,
    peyton_manning_like,
    wiki_logistic_like,
)
from tsspark_tpu_torch.eval import metrics

CONFIG1 = ProphetConfig(
    seasonalities=(
        SeasonalityConfig("yearly", 365.25, 10),
        SeasonalityConfig("weekly", 7.0, 3),
    ),
    n_changepoints=25,
)
SOLVER1 = SolverConfig(max_iters=200)

CONFIG2 = ProphetConfig(
    seasonalities=(
        SeasonalityConfig("daily", 1.0, 4),
        SeasonalityConfig("weekly", 7.0, 3),
    ),
    n_changepoints=10,
)
SOLVER2 = SolverConfig(max_iters=150)

CONFIG3 = ProphetConfig(
    seasonalities=(
        SeasonalityConfig("yearly", 365.25, 8),
        SeasonalityConfig("weekly", 7.0, 3),
    ),
    regressors=(
        RegressorConfig("holiday", standardize=False),
        RegressorConfig("price"),
        RegressorConfig("promo", standardize=False),
    ),
    n_changepoints=25,
)
SOLVER3 = SolverConfig(max_iters=120)

CONFIG4 = ProphetConfig(
    growth="logistic",
    seasonalities=(
        SeasonalityConfig("weekly", 7.0, 3, mode="multiplicative"),
    ),
    n_changepoints=15,
)
SOLVER4 = SolverConfig(max_iters=200)


def split_point(t_len: int, holdout_frac: float = 0.1) -> int:
    return int(t_len * (1 - holdout_frac))


def fit_and_forecast(cfg, batch, backend, solver, holdout_frac=0.1,
                     **backend_kw):
    """Fit the head of each series and forecast the whole calendar.

    Returns (backend, state, forecast dict, fit wall seconds)."""
    t_len = batch.y.shape[1]
    split = split_point(t_len, holdout_frac)
    sl = lambda a: None if a is None else a[:, :split]  # noqa: E731
    bk = get_backend(backend, cfg, solver, **backend_kw)
    t0 = time.perf_counter()
    state = bk.fit(
        batch.ds[:split],
        np.nan_to_num(batch.y[:, :split]),
        mask=batch.mask[:, :split],
        cap=sl(batch.cap),
        regressors=sl(batch.regressors),
    )
    fit_s = time.perf_counter() - t0
    fc = bk.predict(state, batch.ds, cap=batch.cap,
                    regressors=batch.regressors, num_samples=0)
    return bk, state, fc, fit_s


def score(batch, fc, holdout_frac=0.1) -> Dict[str, np.ndarray]:
    """Per-series sMAPE on the training span and on the holdout."""
    split = split_point(batch.y.shape[1], holdout_frac)
    y = np.nan_to_num(batch.y)
    m_train = batch.mask.copy()
    m_train[:, split:] = 0.0
    m_hold = batch.mask.copy()
    m_hold[:, :split] = 0.0
    return {
        "smape_train": metrics.smape(y, fc["yhat"], m_train),
        "smape_holdout": metrics.smape(y, fc["yhat"], m_hold),
    }


def _fit_and_score(cfg, batch, backend, solver, holdout_frac=0.1,
                   **backend_kw):
    """Fit on the head of each series, sMAPE on (a) train and (b) holdout."""
    _, state, fc, fit_s = fit_and_forecast(cfg, batch, backend, solver,
                                           holdout_frac, **backend_kw)
    sc = score(batch, fc, holdout_frac)
    return {
        "fit_seconds": round(fit_s, 3),
        "n_series": int(batch.y.shape[0]),
        "n_timesteps": split_point(batch.y.shape[1], holdout_frac),
        "smape_train": round(float(sc["smape_train"].mean()), 3),
        "smape_holdout": round(float(sc["smape_holdout"].mean()), 3),
        "converged_frac": round(float(np.asarray(state.converged).mean()),
                                3),
    }


def _device_kw(backend, device) -> Dict:
    return {} if device is None or backend != "cuda" else {"device": device}


def config1_peyton(backend="cuda", scale=1.0, device: Optional[str] = None
                   ) -> Dict:
    """Additive fit, single daily series (CPU-backend reference config)."""
    batch = peyton_manning_like(n_days=max(200, int(2905 * scale)))
    return _fit_and_score(CONFIG1, batch, backend, SOLVER1,
                          **_device_kw(backend, device))


def config2_m4_hourly(backend="cuda", scale=1.0,
                      device: Optional[str] = None) -> Dict:
    """Batched additive fit, weekly+daily seasonality, 414 hourly series."""
    batch = m4_hourly_like(n_series=max(4, int(414 * scale)))
    return _fit_and_score(CONFIG2, batch, backend, SOLVER2,
                          **_device_kw(backend, device))


def config3_m5(backend="cuda", scale=1.0, device: Optional[str] = None
               ) -> Dict:
    """M5 retail with holiday + external regressors (the headline config)."""
    batch = m5_like(n_series=max(8, int(30490 * scale)))
    return _fit_and_score(CONFIG3, batch, backend, SOLVER3,
                          **_device_kw(backend, device))


def config4_wiki_logistic(backend="cuda", scale=1.0,
                          device: Optional[str] = None) -> Dict:
    """Logistic growth with capacity, multiplicative seasonality."""
    batch = wiki_logistic_like(n_series=max(2, int(8 * scale)))
    return _fit_and_score(CONFIG4, batch, backend, SOLVER4,
                          **_device_kw(backend, device))


CONFIG5 = ProphetConfig(
    seasonalities=(SeasonalityConfig("weekly", 7.0, 3),), n_changepoints=10
)
SOLVER5 = SolverConfig(max_iters=60)
HORIZON5 = 14


def config5_truth(sid: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Config 5's noise-free generator: series ``sid`` (0-based) at days
    ``t`` (broadcast)."""
    return 20 * (sid + 1) + 0.05 * t + 3 * np.sin(2 * np.pi * t / 7)


def config5_frame(n_series: int, n_days: int, seed: int = 11):
    """Config 5's long frame (series_id, ds, y): the JAX package's
    per-series loop's values, drawn in one call (series i takes the i-th
    run of ``n_days`` normals of the one stream, as the loop does)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    t = np.arange(n_days, dtype=float)
    sid = np.arange(n_series)[:, None]
    y = config5_truth(sid, t[None, :]) + rng.normal(0, 0.5,
                                                    (n_series, n_days))
    return pd.DataFrame({
        "series_id": np.repeat(np.asarray([f"s{i}" for i in range(n_series)],
                                          dtype=object), n_days),
        "ds": np.tile(t, n_series),
        "y": y.reshape(-1),
    })


def config5_batches(df, n_days: int):
    """The base batch (first 70% of the days) and three micro-batches of
    10% each, as the JAX package's config 5 cuts them."""
    warm_len = int(n_days * 0.7)
    micro = int(n_days * 0.1)
    batches = [df[df.ds < warm_len]] + [
        df[(df.ds >= warm_len + k * micro)
           & (df.ds < warm_len + (k + 1) * micro)]
        for k in range(3)
    ]
    return [b for b in batches if len(b)]


def config5_size(scale: float):
    """(n_series, n_days) of config 5 at ``scale``."""
    return max(2, int(50 * scale)), max(150, int(730 * scale))


def config5_forecast(sf, sids):
    """A streaming forecaster's deterministic 14-day forecast of ``sids``
    ("s<i>" ids): (yhat (n, 14), per-series sMAPE against the noise-free
    generator)."""
    n = len(sids)
    fc = sf.forecast(sids, horizon=HORIZON5, num_samples=0)
    t = fc.ds.to_numpy().reshape(n, HORIZON5)
    yhat = fc.yhat.to_numpy().reshape(n, HORIZON5)
    idx = np.asarray([int(s[1:]) for s in sids])[:, None]
    return yhat, metrics.smape(config5_truth(idx, t), yhat)


def forecast_smape(sf, sids) -> np.ndarray:
    """Per-series sMAPE of ``config5_forecast``."""
    return config5_forecast(sf, sids)[1]


def config5_run(backend="cuda", scale=1.0, device: Optional[str] = None,
                frame=None, warmup: bool = True):
    """Eval config 5 as the JAX package runs it: returns (the runner's
    dict, per-series detail: the yhat and sMAPE of the warm, cold and
    replayed forecasts, the three forecasters' stats, the warm forecaster
    after its replay and the micro-batches).  ``frame``: the long frame
    (default ``config5_frame`` at ``scale``); ``warmup``: the throwaway
    first pass of the JAX package's runner (there it fills the jit cache,
    so the warm and cold latencies compare alike)."""
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster
    from tsspark_tpu_torch.streaming.source import InMemorySource

    n_series, n_days = config5_size(scale)
    df = config5_frame(n_series, n_days) if frame is None else frame
    sids = list(dict.fromkeys(df.series_id.astype(str)))
    n_series = len(sids)
    batches = config5_batches(df, n_days)
    kw = _device_kw(backend, device)

    def make(**k):
        return StreamingForecaster(CONFIG5, SOLVER5, backend=backend, **kw,
                                   **k)

    def lat(stats):
        b = np.asarray(stats.batch_seconds)
        return {
            "per_batch_s": [round(float(x), 3) for x in b],
            "mean_s": round(float(b.mean()), 3),
            "p50_s": round(float(np.median(b)), 3),
            "max_s": round(float(b.max()), 3),
        }

    if warmup:
        make().run(InMemorySource(batches))
    sf = make()
    t0 = time.time()
    stats = sf.run(InMemorySource(batches))
    total_s = time.time() - t0
    yhat_warm, smape_warm = config5_forecast(sf, sids)
    # Snapshot BEFORE the crash replay below mutates sf.stats in place.
    n_batches = stats.micro_batches
    n_warm, n_cold = stats.warm_starts, stats.cold_starts
    latency = lat(stats)
    warm_stats = dict(batch_seconds=list(stats.batch_seconds),
                      batch_stages=list(stats.batch_stages))

    # Warm-vs-cold on the IDENTICAL schedule, the transfer disabled.
    sf_cold = make(warm_start=False)
    stats_cold = sf_cold.run(InMemorySource(batches))
    yhat_cold, smape_cold = config5_forecast(sf_cold, sids)
    steady = np.asarray(stats.batch_seconds[1:n_batches])
    steady_cold = np.asarray(stats_cold.batch_seconds[1:])

    # At-least-once under crash: the final micro-batch redelivered
    # un-committed.  The history dedups and the refit re-lands the same
    # parameters, so forecasts must not move.
    sf.process(batches[-1])
    yhat_replay, smape_replay = config5_forecast(sf, sids)
    fc_delta = abs(float(smape_replay.mean()) - float(smape_warm.mean()))

    out = {
        "micro_batches": n_batches,
        "warm_starts": n_warm,
        "cold_starts": n_cold,
        "total_seconds": round(total_s, 3),
        "smape_forecast": round(float(smape_warm.mean()), 3),
        "n_series": n_series,
        "refit_latency": latency,
        "warm_vs_cold": {
            "smape_warm": round(float(smape_warm.mean()), 3),
            "smape_cold": round(float(smape_cold.mean()), 3),
            "steady_latency_warm_mean_s": round(float(steady.mean()), 3)
            if steady.size else None,
            "steady_latency_cold_mean_s": round(float(steady_cold.mean()), 3)
            if steady_cold.size else None,
            "cold_starts_forced": stats_cold.cold_starts,
        },
        "crash_replay": {
            "redelivered_batches": 1,
            "smape_delta_after_replay": round(fc_delta, 6),
            "idempotent": bool(fc_delta < 1e-3),
        },
    }
    detail = {
        "smape_warm": smape_warm, "smape_cold": smape_cold,
        "smape_replay": smape_replay, "yhat_warm": yhat_warm,
        "yhat_cold": yhat_cold, "yhat_replay": yhat_replay,
        "forecaster": sf, "batches": batches, "warm": warm_stats,
        "cold": dict(batch_seconds=list(stats_cold.batch_seconds),
                     batch_stages=list(stats_cold.batch_stages)),
        "replay": dict(batch_seconds=stats.batch_seconds[n_batches:],
                       batch_stages=stats.batch_stages[n_batches:]),
    }
    return out, detail


def config5_streaming(backend="cuda", scale=1.0,
                      device: Optional[str] = None) -> Dict:
    """Kafka-style micro-batch incremental refit with warm starts:
    per-micro-batch refit latency, warm-vs-cold start quality and latency
    on the identical batch schedule, and at-least-once semantics under a
    simulated crash (the last micro-batch redelivered un-committed)."""
    return config5_run(backend, scale, device)[0]


RUNNERS = {"1": config1_peyton, "2": config2_m4_hourly, "3": config3_m5,
           "4": config4_wiki_logistic, "5": config5_streaming}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", choices=sorted(RUNNERS),
                    default="3")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.device is None:
        from tsspark_tpu_torch.utils.platform import honor_env_platforms

        args.device = str(honor_env_platforms())
    key = args.which
    print(json.dumps({f"config{key}": RUNNERS[key](args.backend, args.scale,
                                                   args.device)}))


if __name__ == "__main__":
    main()
