"""Backtesting: simulated historical forecasts (Prophet-style CV), batched.

The port's copy of the JAX package's ``eval/backtest`` module.  Prophet's
cross_validation fits one model per (series, cutoff) pair in a Python
loop; here every (series, cutoff) pair is one row of a single padded
batch — the history mask hides observations after the cutoff — so the
entire backtest is ONE batched MAP solve plus one batched predict,
whatever the number of cutoffs.  The rows' observed windows differ, so
the ``cuda`` backend fits them in its length buckets.

Returns forecasts per cutoff plus per-window metrics, mirroring
prophet.diagnostics.{cross_validation,performance_metrics}.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import ProphetConfig, SolverConfig
from tsspark_tpu_torch.eval import metrics as metrics_mod


def make_cutoffs(
    ds: np.ndarray, horizon: float, period: float, initial: float
) -> np.ndarray:
    """Cutoff times: every ``period`` days, newest first window ending so the
    last horizon fits, oldest cutoff at least ``initial`` days of history."""
    ds = np.asarray(ds, float)
    last = ds.max()
    first = ds.min()
    cutoffs = []
    c = last - horizon
    while c >= first + initial:
        cutoffs.append(c)
        c -= period
    if not cutoffs:
        raise ValueError(
            f"no valid cutoffs: span {last - first} days, initial {initial}, "
            f"horizon {horizon}"
        )
    return np.asarray(sorted(cutoffs))


def cross_validation(
    ds: np.ndarray,
    y: np.ndarray,
    config: ProphetConfig,
    horizon: float,
    period: Optional[float] = None,
    initial: Optional[float] = None,
    solver_config: SolverConfig = SolverConfig(),
    backend: str = "cuda",
    mask: Optional[np.ndarray] = None,
    regressors: Optional[np.ndarray] = None,
    cap: Optional[np.ndarray] = None,
    **backend_kwargs,
) -> Dict[str, np.ndarray]:
    """Simulated historical forecasts for a (B, T) batch.

    Args:
      ds: (T,) shared calendar grid (days).
      y:  (B, T) observations.
      horizon: forecast horizon in days.
      period: spacing between cutoffs (default horizon / 2).
      initial: minimum training history (default 3 * horizon).
      backend_kwargs: to ``get_backend`` (``device="cpu"`` for the plain
        path; by default the ``cuda`` backend runs on the card).

    Returns dict with:
      "cutoffs" (C,), "grid" (T,), "eval_mask" (B, C, T),
      "y_true", "yhat", "yhat_lower", "yhat_upper" (B, C, T), NaN-free,
      with "eval_mask" marking each horizon window's observed cells,
      plus per-(series, cutoff) metric arrays "smape", "mae", "rmse",
      "coverage" of shape (B, C).
    """
    ds = np.asarray(ds, float)
    y = np.asarray(y, float)
    b, t_len = y.shape
    period = horizon / 2.0 if period is None else period
    initial = 3.0 * horizon if initial is None else initial
    cutoffs = make_cutoffs(ds, horizon, period, initial)
    c = len(cutoffs)

    base_mask = np.isfinite(y).astype(np.float32)
    if mask is not None:
        base_mask *= np.asarray(mask, np.float32)

    # Expand to (B*C) rows: row (i, j) = series i with history <= cutoff j.
    hist_mask = (ds[None, :] <= cutoffs[:, None]).astype(np.float32)  # (C, T)
    big_mask = (base_mask[:, None, :] * hist_mask[None, :, :]).reshape(
        b * c, t_len
    )
    big_y = np.repeat(y, c, axis=0)
    # float32 host arrays, as the JAX package hands its backend.
    rep = lambda a: None if a is None else np.repeat(  # noqa: E731
        np.asarray(a, np.float32), c, axis=0)

    bk = get_backend(backend, config, solver_config, **backend_kwargs)
    state = bk.fit(
        ds,
        np.nan_to_num(big_y).astype(np.float32),
        mask=big_mask,
        regressors=rep(regressors),
        cap=rep(cap),
    )

    # Evaluate every row on the full grid once; slice horizon windows after.
    fc = bk.predict(
        state,
        ds,
        regressors=rep(regressors),
        cap=rep(cap),
        seed=0,
    )
    yhat = np.asarray(fc["yhat"]).reshape(b, c, t_len)
    lower = np.asarray(fc.get("yhat_lower", fc["yhat"])).reshape(b, c, t_len)
    upper = np.asarray(fc.get("yhat_upper", fc["yhat"])).reshape(b, c, t_len)

    # Horizon windows: cutoff < ds <= cutoff + horizon, observed only.
    win = (
        (ds[None, :] > cutoffs[:, None])
        & (ds[None, :] <= cutoffs[:, None] + horizon)
    ).astype(np.float32)  # (C, T)
    eval_mask = base_mask[:, None, :] * win[None, :, :]  # (B, C, T)

    y_b = np.nan_to_num(y)[:, None, :]
    out = {
        "cutoffs": cutoffs,
        "grid": ds,
        "eval_mask": eval_mask,
        "y_true": y_b * eval_mask,
        "yhat": yhat,
        "yhat_lower": lower,
        "yhat_upper": upper,
        "smape": np.asarray(metrics_mod.smape(y_b, yhat, mask=eval_mask)),
        "mae": np.asarray(metrics_mod.mae(y_b, yhat, mask=eval_mask)),
        "rmse": np.asarray(metrics_mod.rmse(y_b, yhat, mask=eval_mask)),
        "coverage": np.asarray(
            metrics_mod.coverage(y_b, lower, upper, mask=eval_mask)
        ),
    }
    return out


def performance_metrics(cv: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Aggregate a cross_validation result into scalar headline metrics."""
    return {
        "smape_mean": float(np.mean(cv["smape"])),
        "mae_mean": float(np.mean(cv["mae"])),
        "rmse_mean": float(np.mean(cv["rmse"])),
        "coverage_mean": float(np.mean(cv["coverage"])),
        "n_windows": int(cv["smape"].size),
    }
