"""Exactly-once anomaly alert stream off the refit loop (the port's copy of
the JAX package's ``alerts`` package; its land-to-alert bench comes with
the port's benches).

* ``score``  — deterministic vectorized scoring of each landed delta's
  new observations against the active version's *served* forecast:
  quantile-interval breach when the version publishes a quantile plane,
  residual z-score fallback otherwise (degradation recorded per alert).
  A re-score of (series, delta_seq, version) is bitwise the original.
* ``stream`` — the durable alert log under the plane-protocol discipline
  (spec FIRST, atomic per-delta record, CRC sentinel LAST) plus the
  delivery watermark: a scorer killed at ANY point resumes from the
  watermark, and at-least-once delivery + keyed dedup composes to an
  exactly-once effect.
* ``sink``   — pluggable delivery sinks (JSONL first) behind
  ``RetryPolicy`` + ``CircuitBreaker``; an open breaker queues alerts
  durably and drains on recovery without duplicates; disk-ladder aware
  (scoring detail is shed before any alert is dropped).

The log's layout is the JAX package's: either package's ``AlertStream``
reads the other's records.
"""

from tsspark_tpu_torch.alerts.score import (  # noqa: F401
    DEFAULT_Z,
    canonical_bytes,
    record_crc,
    score_delta,
    score_rows,
)
from tsspark_tpu_torch.alerts.sink import (  # noqa: F401
    AlertSink,
    FlakySink,
    JsonlSink,
    SinkError,
    build_sink,
)
from tsspark_tpu_torch.alerts.stream import (  # noqa: F401
    ALERT_DELIVER,
    ALERT_PUBLISH,
    AlertStream,
)
