"""Prophet-style diagnostics on long DataFrames: CV + metric tables.

The port's copy of the JAX package's ``eval/diagnostics`` module: the
Prophet-family diagnostics surface (``cross_validation`` /
``performance_metrics`` over DataFrames) over the array-level batched
engine in eval/backtest.py, where every (series, cutoff) pair is one row
of a single batched fit on the forecaster's backend (the card, unless
the forecaster was built with ``device="cpu"``).

``cross_validation`` returns the familiar long frame
[series_id, ds, cutoff, y, yhat, yhat_lower, yhat_upper];
``performance_metrics`` aggregates it into a horizon-indexed table with
Prophet's rolling-window smoothing (mse, rmse, mae, mape, mdape, smape,
coverage).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd

from tsspark_tpu_torch.eval import backtest
from tsspark_tpu_torch.frame import Forecaster, _days_to_ts, pivot_long

HorizonLike = Union[float, int, str, pd.Timedelta]


def _to_days(value: HorizonLike, name: str) -> float:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        days = float(value)
    else:
        days = float(pd.Timedelta(value) / pd.Timedelta(days=1))
    if days <= 0:
        raise ValueError(f"{name} must be positive, got {value!r}")
    return days


def cross_validation(
    forecaster: Forecaster,
    df: pd.DataFrame,
    horizon: HorizonLike,
    period: Optional[HorizonLike] = None,
    initial: Optional[HorizonLike] = None,
) -> pd.DataFrame:
    """Simulated historical forecasts for every series in a long frame.

    Args:
      forecaster: an (unfitted is fine) Forecaster carrying the model config,
        backend choice, holiday calendars, and column conventions.
      df: long frame with the forecaster's id/ds/y (+regressor/cap) columns.
      horizon: forecast horizon — days or anything ``pd.Timedelta`` accepts.
      period: spacing between cutoffs (default horizon / 2).
      initial: minimum training history (default 3 * horizon).

    Returns a long frame [series_id, ds, cutoff, y, yhat, yhat_lower,
    yhat_upper] with one row per (series, cutoff, horizon step) that has an
    observed truth value — the same shape prophet.diagnostics.cross_validation
    produces, for all series at once.
    """
    fc = forecaster
    h_days = _to_days(horizon, "horizon")
    p_days = h_days / 2.0 if period is None else _to_days(period, "period")
    i_days = 3.0 * h_days if initial is None else _to_days(initial, "initial")

    was_datetime = not np.issubdtype(df[fc.ds_col].dtype, np.number)
    batch = pivot_long(
        df, fc.id_col, fc.ds_col, fc.y_col, cap_col=fc.cap_col,
        floor_col=fc.floor_col, regressor_cols=fc.regressor_cols,
    )
    b = batch.y.shape[0]
    # auto_seasonality resolves from the full observed calendar, exactly as
    # a fit() on this frame would (the per-cutoff fits below share a config).
    fc._resolve_auto_seasonality(batch.ds)
    reg = fc._combined_regressors(batch.ds, batch.regressors, b)

    cv = backtest.cross_validation(
        batch.ds, batch.y, fc.config,
        horizon=h_days, period=p_days, initial=i_days,
        solver_config=fc.backend.solver_config,
        backend=fc.backend.name,
        regressors=reg, cap=batch.cap,
        # The forecaster's backend keywords (``device`` among them).
        **fc._backend_ctor[2],
    )

    sel = cv["eval_mask"] > 0  # (B, C, T)
    i_idx, j_idx, k_idx = np.nonzero(sel)
    ds_days = cv["grid"][k_idx]
    cut_days = cv["cutoffs"][j_idx]
    out = pd.DataFrame({
        fc.id_col: batch.series_ids[i_idx],
        fc.ds_col: _days_to_ts(ds_days) if was_datetime else ds_days,
        "cutoff": _days_to_ts(cut_days) if was_datetime else cut_days,
        fc.y_col: batch.y[i_idx, k_idx],
        "yhat": cv["yhat"][i_idx, j_idx, k_idx],
        "yhat_lower": cv["yhat_lower"][i_idx, j_idx, k_idx],
        "yhat_upper": cv["yhat_upper"][i_idx, j_idx, k_idx],
    })
    return out.sort_values([fc.id_col, "cutoff", fc.ds_col]).reset_index(
        drop=True
    )


_ALL_METRICS = ("mse", "rmse", "mae", "mape", "mdape", "smape", "coverage")


def point_metrics(
    d: pd.DataFrame, metrics: Sequence[str] = _ALL_METRICS,
    y_col: str = "y",
) -> pd.DataFrame:
    """Per-row metric values for a cross_validation-shaped frame.

    The single source of the per-point metric definitions — both the
    horizon-aggregated table (:func:`performance_metrics`) and the raw
    scatter in ``plot.plot_cross_validation_metric`` are built from it, so
    conventions (sMAPE denominator, eps, coverage inclusivity) cannot drift
    apart.  ``rmse`` aggregates from ``mse``; ``mdape`` from ``mape``.
    """
    y = d[y_col].to_numpy(float)
    yhat = d["yhat"].to_numpy(float)
    err = y - yhat
    eps = 1e-12
    point = pd.DataFrame(index=d.index)
    point["mse"] = err**2
    point["mae"] = np.abs(err)
    point["mape"] = np.abs(err) / np.maximum(np.abs(y), eps)
    point["mdape"] = point["mape"]
    point["smape"] = 2.0 * np.abs(err) / np.maximum(
        np.abs(y) + np.abs(yhat), eps
    )
    if "coverage" in metrics:
        point["coverage"] = (
            (y >= d["yhat_lower"].to_numpy(float))
            & (y <= d["yhat_upper"].to_numpy(float))
        ).astype(float)
    return point


def performance_metrics(
    cv_df: pd.DataFrame,
    rolling_window: float = 0.1,
    metrics: Sequence[str] = _ALL_METRICS,
    y_col: str = "y",
    ds_col: str = "ds",
) -> pd.DataFrame:
    """Horizon-indexed accuracy table from a cross_validation frame.

    Mirrors prophet.diagnostics.performance_metrics: rows are sorted by
    forecast horizon (ds - cutoff) and each metric is smoothed with a
    trailing window covering ``rolling_window`` of all rows (so the table
    answers "how accurate are forecasts h days out", denoised).  With
    ``rolling_window=0`` every horizon step reports its own exact average.
    """
    unknown = set(metrics) - set(_ALL_METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; "
                         f"choose from {_ALL_METRICS}")
    d = cv_df.copy()
    d["horizon"] = d[ds_col] - d["cutoff"]
    d = d.sort_values("horizon", kind="stable").reset_index(drop=True)
    point = point_metrics(d, metrics, y_col=y_col)

    if rolling_window <= 0:
        # Exact per-horizon aggregation, no smoothing.
        point["horizon"] = d["horizon"]
        g = point.groupby("horizon", sort=True)
        out = pd.DataFrame({"horizon": list(g.groups)})
        for m in metrics:
            if m == "rmse":
                out[m] = np.sqrt(g["mse"].mean().to_numpy())
            elif m == "mdape":
                out[m] = g["mdape"].median().to_numpy()
            else:
                out[m] = g[m].mean().to_numpy()
        return out

    n = len(d)
    w = max(1, int(np.ceil(rolling_window * n)))
    out = pd.DataFrame({"horizon": d["horizon"]})
    for m in metrics:
        if m == "rmse":
            out[m] = np.sqrt(point["mse"].rolling(w, min_periods=w).mean())
        elif m == "mdape":
            out[m] = point["mdape"].rolling(w, min_periods=w).median()
        else:
            out[m] = point[m].rolling(w, min_periods=w).mean()
    out = out.iloc[w - 1:]
    # One row per distinct horizon (the trailing window ending at its last row).
    out = out.groupby("horizon", sort=True).tail(1).reset_index(drop=True)
    return out
