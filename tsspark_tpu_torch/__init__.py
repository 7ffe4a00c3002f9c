"""tsspark_tpu_torch — the PyTorch/CUDA port of tsspark_tpu.

A second package beside the JAX one, for one NVIDIA H100.  It has the
JAX package's user surface: the long-frame ``Forecaster`` (holidays,
regressors, auto and conditional seasonality, ``mcmc_samples``),
cross-validation, the forecaster checkpoint and the ``python -m
tsspark_tpu_torch`` CLI; under it the batched MAP fit (chunked, length
bucketed, two-phase, and process-isolated with crash resume), the full
posterior (one HMC chain a series) and ADVI, the serving engine over a
parameter registry with its forecast and quantile planes, continuous
refit, and the columnar data plane.  The hot functions run as
hand-written CUDA kernels (``csrc/``: the forward model, the predictive
intervals, the loss and its gradient, the line-search fan, the
posterior-predictive forecast, the ADVI step), each with a plain
PyTorch version for CPU tensors.  The port imports torch, numpy and
scipy, never JAX and never the JAX package; it keeps its own copies of
what it needs from there (``config``, the checkpoint format, the
registry protocol).

Quick start::

    import pandas as pd
    from tsspark_tpu_torch import Forecaster, ProphetConfig

    fc = Forecaster(ProphetConfig(), backend="cuda")
    fc.fit(df)                       # long frame: series_id, ds, y
    out = fc.predict(horizon=28)     # long frame with yhat + intervals

Entry points (``Forecaster``, ``ProphetModel``, the ``cuda`` backend,
``PredictionEngine``, cross-validation, the CLI) run on the card unless
the caller passes ``device="cpu"`` (``--device cpu``), and raise when no
card is present.

The public names below resolve lazily (PEP 562), so importing the
package loads neither the fit stack nor pandas, and initialises no CUDA
context.
"""

import importlib
import importlib.util

# Public name -> defining module.  Resolution imports the module on
# first attribute access and caches the value in the package globals,
# so repeat lookups are plain dict hits.
_EXPORTS = {
    "DAILY": "tsspark_tpu_torch.config",
    "McmcConfig": "tsspark_tpu_torch.config",
    "ProphetConfig": "tsspark_tpu_torch.config",
    "RegressorConfig": "tsspark_tpu_torch.config",
    "SeasonalityConfig": "tsspark_tpu_torch.config",
    "ShardingConfig": "tsspark_tpu_torch.config",
    "SolverConfig": "tsspark_tpu_torch.config",
    "WEEKLY": "tsspark_tpu_torch.config",
    "YEARLY": "tsspark_tpu_torch.config",
    "ForecastBackend": "tsspark_tpu_torch.backends.registry",
    "get_backend": "tsspark_tpu_torch.backends.registry",
    "list_backends": "tsspark_tpu_torch.backends.registry",
    "register_backend": "tsspark_tpu_torch.backends.registry",
    "Forecaster": "tsspark_tpu_torch.frame",
    "cross_validation": "tsspark_tpu_torch.eval.diagnostics",
    "performance_metrics": "tsspark_tpu_torch.eval.diagnostics",
    "Holiday": "tsspark_tpu_torch.models.holidays",
    "add_holidays": "tsspark_tpu_torch.models.holidays",
    "country_holidays": "tsspark_tpu_torch.models.holidays",
    "holidays_from_df": "tsspark_tpu_torch.models.holidays",
    "FitState": "tsspark_tpu_torch.models.prophet.model",
    "McmcState": "tsspark_tpu_torch.models.prophet.model",
    "ProphetModel": "tsspark_tpu_torch.models.prophet.model",
    "auto_seasonalities": "tsspark_tpu_torch.models.prophet.seasonality",
    "FaultPlan": "tsspark_tpu_torch.resilience",
    "ResilienceReport": "tsspark_tpu_torch.resilience",
    "ResilienceWarning": "tsspark_tpu_torch.resilience",
    "RetryPolicy": "tsspark_tpu_torch.resilience",
    "get_report": "tsspark_tpu_torch.resilience",
    "ParamRegistry": "tsspark_tpu_torch.serve",
    "PredictionEngine": "tsspark_tpu_torch.serve",
}

__version__ = "0.4.0"

__all__ = [
    "DAILY",
    "Forecaster",
    "ForecastBackend",
    "FitState",
    "Holiday",
    "McmcConfig",
    "McmcState",
    "add_holidays",
    "auto_seasonalities",
    "country_holidays",
    "holidays_from_df",
    "ProphetConfig",
    "ProphetModel",
    "RegressorConfig",
    "SeasonalityConfig",
    "ShardingConfig",
    "SolverConfig",
    "WEEKLY",
    "YEARLY",
    "FaultPlan",
    "ParamRegistry",
    "PredictionEngine",
    "ResilienceReport",
    "ResilienceWarning",
    "RetryPolicy",
    "cross_validation",
    "get_backend",
    "get_report",
    "list_backends",
    "performance_metrics",
    "register_backend",
]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is not None:
        value = getattr(importlib.import_module(mod), name)
        globals()[name] = value
        return value
    # `tsspark_tpu_torch.frame`-style attribute access without a prior
    # submodule import: resolve it, but only when the submodule really
    # exists — a typo must stay an AttributeError, and a broken
    # submodule must raise ITS error.
    if importlib.util.find_spec(f"tsspark_tpu_torch.{name}") is not None:
        return importlib.import_module(f"tsspark_tpu_torch.{name}")
    raise AttributeError(
        f"module 'tsspark_tpu_torch' has no attribute {name!r}"
    )


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
