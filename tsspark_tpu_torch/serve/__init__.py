"""Forecast serving on the card: the port's read path.

  registry.py — versioned, atomic parameter registry (npz snapshots):
                publish / activate / rollback, manifest validated at
                load (format, config fingerprint, NUMERICS_REV), last
                good version on a corrupt active snapshot.
  engine.py   — micro-batched prediction engine: bounded-queue
                admission, request coalescing into pow-2 shape buckets,
                deadline shedding with structured errors, one padded
                ``backend.predict`` per bucket.
  cache.py    — version-keyed per-series forecast LRU.
"""

from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.engine import (
    EngineOverloaded,
    EngineStats,
    ForecastRequest,
    ForecastResult,
    PendingForecast,
    PredictionEngine,
    RequestShed,
    SamplesUnsupported,
    ServeError,
    UnknownSeries,
)
from tsspark_tpu_torch.serve.registry import (
    ParamRegistry,
    RegistryError,
    Snapshot,
)

__all__ = [
    "EngineOverloaded", "EngineStats", "ForecastCache", "ForecastRequest",
    "ForecastResult", "ParamRegistry", "PendingForecast",
    "PredictionEngine", "RegistryError", "RequestShed",
    "SamplesUnsupported", "ServeError",
    "Snapshot", "UnknownSeries",
]
