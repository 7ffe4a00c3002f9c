"""The port's evaluation configs: eval config 3 (M5 retail, the headline)
and eval config 4 (logistic growth with a known capacity).

``config3_m5`` builds ``m5_like`` (30,490 daily series over 1,941 days
with holiday, price and promo regressors; ``scale`` shrinks the series
count); ``config4_wiki_logistic`` builds ``wiki_logistic_like`` (8
saturating series over 1,200 days at scale 1; ``scale`` multiplies the
count: 1,024 gives 8,192).  Each fits the first 90% of every series
through the chosen backend (``"cuda"`` on the card by default),
forecasts the whole calendar and scores sMAPE on the training span and
on the held-out tail.

Usage:  python -m tsspark_tpu_torch.eval.configs [--config {3,4}]
            [--scale S] [--device D]
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
from tsspark_tpu_torch.data.datasets import m5_like, wiki_logistic_like
from tsspark_tpu_torch.eval import metrics

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


def config3_m5(backend="cuda", scale=1.0, device: Optional[str] = None
               ) -> Dict:
    """M5 retail with holiday + external regressors (the headline config)."""
    batch = m5_like(n_series=max(8, int(30490 * scale)))
    kw = {} if device is None or backend != "cuda" else {"device": device}
    return _fit_and_score(CONFIG3, batch, backend, SOLVER3, **kw)


def config4_wiki_logistic(backend="cuda", scale=1.0,
                          device: Optional[str] = None) -> Dict:
    """Logistic growth with capacity, multiplicative seasonality."""
    batch = wiki_logistic_like(n_series=max(2, int(8 * scale)))
    kw = {} if device is None or backend != "cuda" else {"device": device}
    return _fit_and_score(CONFIG4, batch, backend, SOLVER4, **kw)


CONFIGS = {3: config3_m5, 4: config4_wiki_logistic}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS),
                    default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run = CONFIGS[args.config]
    print(json.dumps({f"config{args.config}": run(args.backend, args.scale,
                                                  args.device)}))


if __name__ == "__main__":
    main()
