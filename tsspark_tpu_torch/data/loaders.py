"""Real-dataset file loaders: M5 (Kaggle format) and M4 competition CSVs.

The port's copy of the JAX package's ``data/loaders.py``.  The synthetic
generators in :mod:`tsspark_tpu_torch.data.datasets` stand in when no data
files are at hand; these loaders read the ACTUAL competition file formats so
a user with the real files gets the real benchmarks:

  * M5: ``sales_train_validation.csv`` (wide: id, item/dept/cat/store/state
    ids, then d_1..d_N unit-sales columns), ``calendar.csv`` (maps d_k to
    dates, events, SNAP flags), ``sell_prices.csv`` (store_id, item_id,
    wm_yr_wk, sell_price).  Produces the same (B, T) + regressor layout the
    eval config-3 path consumes: holiday indicator (any event day),
    per-series price, per-series SNAP/promo flag.
  * M4: ``<Freq>-train.csv`` (id, V1..Vmax, ragged rows padded with NaN) with
    a synthetic hourly/daily calendar grid (M4 publishes no timestamps —
    frequency only), matching eval config 2's batched layout.

Everything returns :class:`~tsspark_tpu_torch.data.datasets.SeriesBatch`;
parsing is pandas/numpy host-side work (the same arrays as the JAX
package's loaders, bit for bit).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import pandas as pd

from tsspark_tpu_torch.data.datasets import SeriesBatch

_EPOCH = pd.Timestamp("1970-01-01")


def load_m5(
    sales_csv: str,
    calendar_csv: str,
    prices_csv: Optional[str] = None,
    n_series: Optional[int] = None,
) -> SeriesBatch:
    """Load the Kaggle M5 file set into the eval-config-3 batch layout.

    Args:
      sales_csv: sales_train_validation.csv / sales_train_evaluation.csv.
      calendar_csv: calendar.csv (d_k -> date, events, SNAP flags).
      prices_csv: optional sell_prices.csv; without it the price regressor
        is constant zero (standardization then neutralizes the column).
      n_series: optional row limit (full file = 30,490 series).

    Returns:
      SeriesBatch with regressors (B, T, 3) = [holiday, price, promo],
      matching eval config 3's regressors.
    """
    sales = pd.read_csv(sales_csv, nrows=n_series)
    cal = pd.read_csv(calendar_csv)
    d_cols = [c for c in sales.columns if c.startswith("d_")]
    # Calendar rows beyond the sales horizon (the 28-day eval tail) drop.
    cal = cal.set_index("d").loc[d_cols].reset_index()
    dates = pd.to_datetime(cal["date"])
    ds = ((dates - _EPOCH) / pd.Timedelta(days=1)).to_numpy(np.float64)

    y = sales[d_cols].to_numpy(np.float64)
    b, t_len = y.shape
    mask = np.ones_like(y)

    # Holiday indicator: any named event that day (either event slot).
    holiday = np.zeros(t_len)
    for col in ("event_name_1", "event_name_2"):
        if col in cal.columns:
            holiday = np.maximum(holiday, cal[col].notna().to_numpy(float))
    holiday_b = np.broadcast_to(holiday, (b, t_len))

    # SNAP/promo flag: the series' own state's SNAP column.
    snap_cols = {c[len("snap_"):]: c for c in cal.columns
                 if c.startswith("snap_")}
    if snap_cols and "state_id" in sales.columns:
        snap_by_state = {
            st: cal[col].to_numpy(float) for st, col in snap_cols.items()
        }
        promo = np.stack([
            snap_by_state.get(st, np.zeros(t_len))
            for st in sales["state_id"].astype(str)
        ])
    else:
        promo = np.zeros((b, t_len))

    # Price: weekly sell_price joined on (store_id, item_id, wm_yr_wk),
    # forward/back-filled over weeks the item was not listed.
    price = np.zeros((b, t_len))
    if prices_csv is not None and os.path.exists(prices_csv):
        prices = pd.read_csv(prices_csv)
        wk = cal["wm_yr_wk"].to_numpy()
        key = prices.set_index(["store_id", "item_id", "wm_yr_wk"])[
            "sell_price"
        ]
        for i, (store, item) in enumerate(
            zip(sales["store_id"].astype(str), sales["item_id"].astype(str))
        ):
            try:
                by_wk = key.loc[(store, item)]
            except KeyError:
                continue
            series = pd.Series(wk).map(by_wk).ffill().bfill()
            price[i] = series.fillna(0.0).to_numpy(np.float64)

    reg = np.stack([holiday_b, price, promo], axis=-1)
    return SeriesBatch(
        ds=ds, y=y, mask=mask,
        series_ids=sales["id"].astype(str).to_numpy(),
        regressors=reg,
        regressor_names=("holiday", "price", "promo"),
    )


def load_m4(
    train_csv: str,
    freq_hours: float = 1.0,
    start_day: float = 17167.0,
    n_series: Optional[int] = None,
) -> SeriesBatch:
    """Load an M4 competition training CSV (id, V1..Vmax; ragged rows).

    M4 publishes frequencies but not timestamps, so rows are placed on a
    shared synthetic grid at ``freq_hours`` spacing, RIGHT-ALIGNED the way
    the M4 evaluation treats series (each series' last observation is the
    common forecast origin); leading entries of shorter series are NaN and
    masked.
    """
    df = pd.read_csv(train_csv, nrows=n_series)
    ids = df.iloc[:, 0].astype(str).to_numpy()
    vals = df.iloc[:, 1:].to_numpy(np.float64)
    lengths = (~np.isnan(vals)).sum(axis=1)
    t_len = int(lengths.max())
    b = len(ids)
    y = np.full((b, t_len), np.nan)
    for i in range(b):
        n = lengths[i]
        y[i, t_len - n:] = vals[i, :n]
    mask = (~np.isnan(y)).astype(np.float64)
    step = freq_hours / 24.0
    ds = start_day + step * np.arange(t_len, dtype=np.float64)
    return SeriesBatch(ds=ds, y=y, mask=mask, series_ids=ids)
