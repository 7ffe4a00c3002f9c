"""Forecast serving on the card: the port's read path.

  registry.py  — versioned, atomic parameter registry (npz snapshots and
                 the memmap snapshot plane): publish / publish_delta /
                 activate / rollback, manifest validated at load (format,
                 config fingerprint, NUMERICS_REV), last good version on a
                 corrupt active snapshot.
  engine.py    — micro-batched prediction engine: bounded-queue
                 admission, request coalescing into pow-2 shape buckets,
                 deadline shedding with structured errors, one padded
                 ``backend.predict`` per bucket, retries and circuit
                 breakers, prefetch / materialize / ensure_version for
                 version flips.
  cache.py     — version-keyed per-series forecast LRU (bounded, carried
                 forward across a delta flip).
  fplane.py    — the materialized forecast plane (zero-dispatch reads).
  __main__.py  — ``python -m tsspark_tpu_torch.serve``: the stdin/stdout
                 JSONL daemon, ``--loadgen`` (a latency report ending in
                 the regression sentinel) and ``--loadgen --pool R``.
  pool.py      — engine replica pool: N replica processes behind one
                 sharding front — lease-fenced slots, heartbeat health,
                 failover to a sibling, respawn, version flips drained
                 behind the ahead-of-time materializer.
  aotbank.py   — the kernel bank: the kernel library built at publish,
                 loaded by a cold replica instead of built.

``replica.py`` (the pool's child CLI) is not imported here, so ``python
-m`` runs it without the runpy double-import warning.
"""

from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.engine import (
    BackendUnavailable,
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
from tsspark_tpu_torch.serve.pool import (
    NoReplicaAvailable,
    PoolError,
    ReplicaFenced,
    ReplicaPool,
    VersionMismatch,
    shard_of,
)
from tsspark_tpu_torch.serve.registry import (
    NUMERICS_REV,
    ParamRegistry,
    RegistryError,
    Snapshot,
    take_fitstate,
)

__all__ = [
    "BackendUnavailable",
    "EngineOverloaded",
    "EngineStats",
    "ForecastCache",
    "ForecastRequest",
    "ForecastResult",
    "NUMERICS_REV",
    "NoReplicaAvailable",
    "ParamRegistry",
    "PendingForecast",
    "PoolError",
    "PredictionEngine",
    "RegistryError",
    "ReplicaFenced",
    "ReplicaPool",
    "RequestShed",
    "SamplesUnsupported",
    "ServeError",
    "Snapshot",
    "UnknownSeries",
    "VersionMismatch",
    "shard_of",
    "take_fitstate",
]
