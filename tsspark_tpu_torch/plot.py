"""Plotting: forecast and component figures (matplotlib, import-gated).

The port's copy of the JAX package's ``plot`` module, the Prophet-family
plotting surface: ``plot_forecast`` (history + yhat + interval band per
series), ``add_changepoints_to_plot``, ``plot_components`` (trend with
interval, one panel per seasonality / regressor block) and
``plot_cross_validation_metric``.  Works off the long forecast frame a
:class:`~tsspark_tpu_torch.frame.Forecaster` produces, or raw arrays —
no refit needed to plot.  Host-only work.

matplotlib is a soft dependency: importing this module without it
raises only when a plot function is called.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib; it is not installed"
        ) from e


def plot_forecast(
    forecast_df: pd.DataFrame,
    history_df: Optional[pd.DataFrame] = None,
    series_id: Optional[str] = None,
    id_col: str = "series_id",
    ds_col: str = "ds",
    y_col: str = "y",
    ax=None,
    figsize=(10, 4),
):
    """History dots + forecast line + uncertainty band for one series.

    Args:
      forecast_df: long frame with ds/yhat (+yhat_lower/yhat_upper).
      history_df: optional long frame with the training observations.
      series_id: which series to plot (default: the first in forecast_df).
    """
    plt = _mpl()
    sid = series_id if series_id is not None else forecast_df[id_col].iloc[0]
    fc = forecast_df[forecast_df[id_col] == sid]
    if fc.empty:
        raise ValueError(f"series {sid!r} not present in forecast frame")
    if ax is None:
        _, ax = plt.subplots(figsize=figsize)

    if history_df is not None:
        h = history_df[history_df[id_col] == sid]
        ax.plot(h[ds_col], h[y_col], "k.", markersize=3, alpha=0.6,
                label="observed")
    ax.plot(fc[ds_col], fc["yhat"], color="#0072B2", label="forecast")
    if {"yhat_lower", "yhat_upper"} <= set(fc.columns):
        ax.fill_between(
            fc[ds_col], fc["yhat_lower"], fc["yhat_upper"],
            color="#0072B2", alpha=0.2, linewidth=0, label="interval",
        )
    ax.set_title(str(sid))
    ax.set_xlabel(ds_col)
    ax.set_ylabel(y_col)
    ax.legend(loc="best", fontsize=8)
    ax.figure.autofmt_xdate()
    return ax


def add_changepoints_to_plot(
    ax,
    forecaster,
    series_id: Optional[str] = None,
    threshold: float = 0.01,
    color: str = "r",
):
    """Overlay significant changepoints on a forecast axis (Prophet's
    ``add_changepoints_to_plot``).

    Draws a dashed vertical line at every fit-time changepoint whose rate
    adjustment |delta| exceeds ``threshold`` for the given series.

    Args:
      ax: the axis returned by :func:`plot_forecast`.
      forecaster: a fitted :class:`~tsspark_tpu_torch.frame.Forecaster`.
      series_id: which series (default: the first fitted one).
    """
    cps = forecaster.changepoints_df(series_id)
    for _, row in cps[cps["abs_delta"] > threshold].iterrows():
        ax.axvline(row["ds"], ls="--", lw=1, color=color, alpha=0.6)
    return ax


def plot_components(
    components: Dict[str, np.ndarray],
    ds,
    series_index: int = 0,
    names: Optional[Sequence[str]] = None,
    figsize=(10, 2.2),
):
    """One panel per component block for one series.

    Args:
      components: name -> (B, T) arrays, e.g. from ``Forecaster.components``
        or ``ProphetModel.components`` (plus "trend"/interval keys from a
        forecast dict — anything (B, T) works).
      ds: (T,) x-axis values (days or datetimes).
      series_index: row of the batch to plot.
      names: subset/order of component names (default: all, trend first).
    """
    plt = _mpl()
    keys = list(components)
    if names is None:
        names = sorted(
            (k for k in keys if not k.endswith(("_lower", "_upper"))),
            key=lambda k: (k != "trend", k),
        )
    fig, axes = plt.subplots(
        len(names), 1, figsize=(figsize[0], figsize[1] * len(names)),
        sharex=True, squeeze=False,
    )
    for ax, name in zip(axes[:, 0], names):
        arr = np.asarray(components[name])
        ax.plot(ds, arr[series_index], color="#0072B2")
        lo, hi = f"{name}_lower", f"{name}_upper"
        if lo in components and hi in components:
            ax.fill_between(
                ds, np.asarray(components[lo])[series_index],
                np.asarray(components[hi])[series_index],
                color="#0072B2", alpha=0.2, linewidth=0,
            )
        ax.set_ylabel(name, fontsize=9)
    axes[-1, 0].set_xlabel("ds")
    fig.autofmt_xdate()
    fig.tight_layout()
    return fig


def plot_cross_validation_metric(
    cv_df: pd.DataFrame,
    metric: str = "smape",
    rolling_window: float = 0.1,
    ds_col: str = "ds",
    y_col: str = "y",
    ax=None,
    figsize=(10, 4),
):
    """Per-point metric scatter + rolling-mean curve over forecast horizon.

    Mirrors ``prophet.plot.plot_cross_validation_metric``: dots are the raw
    per-(series, cutoff, ds) errors from a :func:`cross_validation` frame,
    the line is the horizon-rolling aggregate from
    :func:`performance_metrics`.  Both are computed from the same
    ``point_metrics`` definitions, so they cannot drift apart; the dots for
    ``rmse``/``mdape`` show their per-point bases (|err| / APE).
    """
    from tsspark_tpu_torch.eval.diagnostics import (
        _ALL_METRICS, performance_metrics, point_metrics,
    )

    if metric not in _ALL_METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; choose from {_ALL_METRICS}"
        )
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    d = cv_df.copy()
    d["horizon"] = d[ds_col] - d["cutoff"]
    point = point_metrics(d, (metric,), y_col=y_col)
    base = {"rmse": "mae", "mdape": "mape"}.get(metric, metric)
    ax.plot(d["horizon"], point[base], ".", alpha=0.3, markersize=3,
            color="gray")
    pm = performance_metrics(
        cv_df, rolling_window=rolling_window, metrics=(metric,),
        ds_col=ds_col, y_col=y_col,
    )
    ax.plot(pm["horizon"], pm[metric], color="#0072B2", linewidth=2)
    ax.set_xlabel("horizon")
    ax.set_ylabel(metric)
    return ax
