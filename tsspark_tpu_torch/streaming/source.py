"""Micro-batch sources for streaming incremental refit.

The reference consumes Kafka micro-batches (eval config 5).  The source
is an interface: ``InMemorySource`` drives tests and simulations;
``KafkaSource`` is a dependency-gated adapter with the same contract that
activates when a ``kafka-python``-compatible client is importable;
``ResilientSource`` retries any source's poll under a ``RetryPolicy``.
(The JAX package's ``PlaneReplaySource`` reads its columnar data plane,
which the port has not got yet.)

Contract: ``poll()`` returns a long-format DataFrame of NEW observations
(series_id, ds, y [, regressor columns]) or None when nothing is pending.
"""

from __future__ import annotations

import abc
import sys
from typing import Iterable, List, Optional

import pandas as pd

from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.policy import (
    STREAM_POLL,
    CircuitBreaker,
    RetryPolicy,
)


class MicroBatchSource(abc.ABC):
    """A stream of long-format observation micro-batches."""

    @abc.abstractmethod
    def poll(self) -> Optional[pd.DataFrame]:
        """Next micro-batch, or None if the stream is (currently) dry."""

    def commit(self) -> None:
        """Acknowledge the most recent ``poll``'s batch as durably applied.

        The streaming driver calls this AFTER the refit has landed in the
        parameter store, giving at-least-once delivery: a crash between
        poll and commit replays the batch, and replays are idempotent
        (history appends dedup by (series, ds); the refit recomputes the
        same parameters).  Default no-op for sources with no offsets.
        """

    def __iter__(self):
        while (batch := self.poll()) is not None:
            yield batch


class ResilientSource(MicroBatchSource):
    """Retry wrapper for any source's poll loop.

    A transient poll failure (broker hiccup, network blip, injected
    ``stream_poll`` fault) is retried under a ``RetryPolicy`` with
    backoff instead of killing the streaming driver; a failure that
    outlives the policy's attempt/budget limits re-raises.  ``commit``
    passes through untouched — offsets are only ever acknowledged by the
    driver after a refit lands, so retried polls stay at-least-once.

    ``breaker``: an optional ``CircuitBreaker`` shared across polls —
    once a dead broker has failed it open, the next poll raises
    ``CircuitOpen`` immediately instead of retrying to the policy's
    deadline again (the caller decides whether to back off or abort;
    offsets are untouched either way).
    """

    def __init__(self, source: MicroBatchSource,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self._source = source
        self._policy = policy or STREAM_POLL
        self._breaker = breaker

    def poll(self) -> Optional[pd.DataFrame]:
        def attempt():
            faults.inject("stream_poll")
            return self._source.poll()

        def log_retry(retry: int, e: BaseException) -> None:
            print(
                f"[streaming] poll failed ({type(e).__name__}: {e}); "
                f"retry {retry + 1}", file=sys.stderr,
            )

        return self._policy.call(attempt, on_retry=log_retry,
                                 breaker=self._breaker)

    def commit(self) -> None:
        self._source.commit()


class InMemorySource(MicroBatchSource):
    """Replays a pre-built list of micro-batch frames (tests/simulation)."""

    def __init__(self, batches: Iterable[pd.DataFrame]):
        self._batches: List[pd.DataFrame] = list(batches)
        self._pos = 0

    def poll(self) -> Optional[pd.DataFrame]:
        if self._pos >= len(self._batches):
            return None
        out = self._batches[self._pos]
        self._pos += 1
        return out


class KafkaSource(MicroBatchSource):
    """Kafka consumer adapter.

    Messages are expected to be JSON rows {series_id, ds, y, ...}; each
    ``poll`` drains up to ``max_records`` into one micro-batch frame.

    ``consumer`` injects any object with the KafkaConsumer ``poll``
    contract (``poll(timeout_ms=..., max_records=...) ->
    {partition: [records with .value]}``) — how the tests exercise this
    path without a broker, and how alternative clients plug in.  Without
    it, a ``kafka-python``-compatible package must be importable.
    Transient poll errors are retried by wrapping the source in
    ``ResilientSource`` (``run(poll_policy=...)``).
    """

    def __init__(self, topic: Optional[str] = None, max_records: int = 10000,
                 consumer=None, **consumer_kwargs):
        if consumer is not None:
            self._consumer = consumer
        else:
            try:
                from kafka import KafkaConsumer  # type: ignore
            except ImportError as e:  # pragma: no cover - needs a client
                raise ImportError(
                    "KafkaSource needs the 'kafka-python' package, which is "
                    "not installed on this machine; pass consumer=, use "
                    "InMemorySource, or implement MicroBatchSource over "
                    "your transport"
                ) from e
            import json as _json

            self._consumer = KafkaConsumer(  # pragma: no cover - no broker
                topic,
                value_deserializer=lambda b: _json.loads(b.decode()),
                **consumer_kwargs,
            )
        self._max_records = max_records

    def poll(self) -> Optional[pd.DataFrame]:
        records = self._consumer.poll(timeout_ms=1000,
                                      max_records=self._max_records)
        rows = [msg.value for part in records.values() for msg in part]
        if not rows:
            return None
        return pd.DataFrame(rows)

    def commit(self) -> None:
        """Commit consumer offsets for everything polled so far (the
        driver invokes this only after the refit is durably applied)."""
        commit = getattr(self._consumer, "commit", None)
        if commit is not None:
            commit()
