"""Optional Spark adapter: drive the port's Forecaster from a Spark DataFrame.

The port's copy of the JAX package's ``spark`` module.  Per-series fits
inside Spark executors buy nothing when one card fits tens of thousands
of series in one batched solve, so the adapter implements the
driver-side collapse (collect -> fit -> scatter):

  1. collect the long DataFrame to the driver (toPandas, Arrow-backed),
  2. run the batched fit/predict through the normal Forecaster (on the
     card unless it was built with ``device="cpu"``),
  3. hand the forecast frame back as a Spark DataFrame (createDataFrame).

PySpark is not a dependency: the adapter duck-types its input, so
anything exposing ``toPandas()`` and a ``sparkSession.createDataFrame(pdf)``
works — real pyspark included (the tests use a stub frame).
"""

from __future__ import annotations

from typing import Any, Optional

import pandas as pd

from tsspark_tpu_torch.frame import Forecaster


def _require_to_pandas(sdf: Any) -> pd.DataFrame:
    to_pandas = getattr(sdf, "toPandas", None)
    if to_pandas is None:
        raise TypeError(
            f"expected a Spark DataFrame (needs .toPandas()), got {type(sdf)!r}"
        )
    return to_pandas()


def _spark_session(sdf: Any):
    session = getattr(sdf, "sparkSession", None) or getattr(sdf, "sql_ctx", None)
    if session is None:
        raise TypeError(
            "cannot locate a SparkSession on the input DataFrame "
            "(.sparkSession / .sql_ctx)"
        )
    return session


class SparkForecaster:
    """Fit/predict over Spark DataFrames with a batched driver-side core.

    Example (on a real cluster)::

        sfc = SparkForecaster(Forecaster(cfg, backend="cuda"))
        sfc.fit(spark_df)                      # long: series_id, ds, y
        out = sfc.predict(horizon=28)          # Spark DataFrame back
    """

    def __init__(self, forecaster: Forecaster):
        self.forecaster = forecaster
        self._session = None

    def fit(self, sdf: Any) -> "SparkForecaster":
        pdf = _require_to_pandas(sdf)
        self._session = _spark_session(sdf)
        self.forecaster.fit(pdf)
        return self

    def predict(
        self,
        horizon: Optional[int] = None,
        future_sdf: Optional[Any] = None,
        include_history: bool = False,
    ) -> Any:
        if self._session is None:
            raise RuntimeError("predict before fit")
        future_pdf = (
            _require_to_pandas(future_sdf) if future_sdf is not None else None
        )
        out = self.forecaster.predict(
            horizon=horizon, future_df=future_pdf,
            include_history=include_history,
        )
        return self._session.createDataFrame(out)


def forecast_spark(
    sdf: Any,
    forecaster: Forecaster,
    horizon: Optional[int] = None,
    include_history: bool = False,
) -> Any:
    """One-shot convenience: fit on ``sdf`` and return the forecast frame."""
    return (
        SparkForecaster(forecaster)
        .fit(sdf)
        .predict(horizon, include_history=include_history)
    )
