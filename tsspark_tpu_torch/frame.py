"""Timestamps <-> float days since the Unix epoch, for long-format frames.

The two conversions of the JAX package's ``frame.py`` that the streaming
driver uses; the rest of that module (the long-frame ``Forecaster``
front end) is not ported yet.  Any pandas datetime64 resolution or a
plain numeric "days" column works.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_SECONDS_PER_DAY = 86400.0


def _ds_to_days(ds: pd.Series) -> np.ndarray:
    if np.issubdtype(ds.dtype, np.number):
        return ds.to_numpy(np.float64)
    # Resolution-agnostic (pandas >= 2 may store datetime64 in s/ms/us/ns).
    ts = pd.to_datetime(ds)
    delta = ts - pd.Timestamp("1970-01-01")
    return (delta / pd.Timedelta(days=1)).to_numpy(np.float64)


def _days_to_ts(days: np.ndarray) -> pd.Series:
    return pd.Timestamp("1970-01-01") + pd.to_timedelta(
        np.round(days * _SECONDS_PER_DAY * 1e3).astype("int64"), unit="ms"
    )
