"""Micro-batch sources for streaming incremental refit.

The reference consumes Kafka micro-batches (eval config 5).  The source
is an interface: ``InMemorySource`` drives tests and simulations;
``KafkaSource`` is a dependency-gated adapter with the same contract that
activates when a ``kafka-python``-compatible client is importable;
``ResilientSource`` retries any source's poll under a ``RetryPolicy``;
``PlaneReplaySource`` replays a columnar data-plane dataset
(``data/plane.py``) window by window.

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


class PlaneReplaySource(MicroBatchSource):
    """Replay a columnar data-plane dataset as a micro-batch stream.

    The streaming driver's load path, wired to the shared data plane
    (``tsspark_tpu_torch.data.plane``): each ``poll`` slices the next
    ``window`` timesteps across (up to ``max_series``) series out of the
    dataset's memmap columns and emits the observed points as a long
    frame -- no private datagen path, no copy until the slice.
    """

    def __init__(self, dataset_dir: Optional[str] = None, *,
                 spec=None, root: Optional[str] = None,
                 window: int = 32, max_series: Optional[int] = None,
                 id_col: str = "series_id", ds_col: str = "ds",
                 y_col: str = "y"):
        import numpy as np

        from tsspark_tpu_torch.data import plane

        if dataset_dir is None:
            if spec is None:
                raise ValueError("pass dataset_dir or spec")
            dataset_dir = plane.ensure(spec, root=root)
        self.dataset_dir = dataset_dir
        self._batch = plane.open_batch(dataset_dir)
        self._np = np
        self._window = int(window)
        self._n = (len(self._batch.series_ids) if max_series is None
                   else min(int(max_series), len(self._batch.series_ids)))
        self._cols = (id_col, ds_col, y_col)
        self._t = 0

    def poll(self) -> Optional[pd.DataFrame]:
        np = self._np
        t_len = self._batch.y.shape[1]
        if self._t >= t_len:
            return None
        lo, hi = self._t, min(self._t + self._window, t_len)
        self._t = hi
        y = np.asarray(self._batch.y[:self._n, lo:hi], np.float64)
        mask = np.asarray(self._batch.mask[:self._n, lo:hi]) > 0
        ds = np.asarray(self._batch.ds[lo:hi], np.float64)
        sid = np.repeat(np.asarray(self._batch.series_ids[:self._n]),
                        hi - lo)
        grid = np.tile(ds, self._n)
        obs_flat = mask.reshape(-1)
        if not obs_flat.any():
            # A fully-masked window (e.g. cold-start onset) still
            # advances the clock; hand back an empty frame contract-
            # compatibly by polling the next window.
            return self.poll()
        id_col, ds_col, y_col = self._cols
        return pd.DataFrame({
            id_col: sid[obs_flat],
            ds_col: grid[obs_flat],
            y_col: y.reshape(-1)[obs_flat],
        })
