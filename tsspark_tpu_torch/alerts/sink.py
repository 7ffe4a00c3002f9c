"""Pluggable alert delivery sinks.

A sink is the boundary where alerts leave the process — the one stage
of the pipeline whose failures the scorer cannot roll back.  The
contract that makes exactly-once composable on top of at-least-once
delivery:

* ``emit(alert)`` either raises (nothing may be assumed delivered) or
  returns (the alert is durably acked by the sink).  The stream only
  advances its watermark after every alert of a record returned.
* ``keys()`` is the sink's own delivered-key set — the dedup side of
  the exactly-once argument.  A redelivery after a kill consults it,
  so a consumer reading the sink sees each (kind, series, delta_seq)
  key exactly once even though the stream only guarantees
  at-least-once emission attempts.
* ``recover()`` repairs any torn state a kill mid-emit left behind
  (for the JSONL sink: a trailing line without its newline, which
  would otherwise corrupt the NEXT append by concatenation).

The stream wraps every emit in ``RetryPolicy`` + ``CircuitBreaker``
(``resilience.policy``); the sink itself stays dumb and replayable.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Set

from tsspark_tpu_torch.io import append_line


class SinkError(RuntimeError):
    """A sink refused or failed an emit: the alert is NOT acked.  The
    retry policy treats it (and OSError) as retryable; anything else a
    sink raises is a bug and propagates."""


class AlertSink:
    """Interface. ``name`` labels breaker/metrics output."""

    name = "null"

    def emit(self, alert: Dict) -> None:
        raise NotImplementedError

    def keys(self) -> Set[str]:
        """Delivered alert keys (the dedup set).  May re-read durable
        state; called on resume paths, not per emit."""
        raise NotImplementedError

    def recover(self) -> None:
        """Repair torn sink state after a crash (idempotent)."""


class JsonlSink(AlertSink):
    """Append-only JSONL file sink — the durable reference sink.

    One alert per line through the durable append path (single
    ``O_APPEND`` write per line, classified errors, ``io_write`` fault
    point).  Readers tolerate a torn last line; :meth:`recover`
    terminates one so later appends never concatenate onto it.  The
    torn fragment itself stays in the file (forensics) — its alert was
    never acked, so redelivery appends it whole."""

    name = "jsonl"

    def __init__(self, path: str):
        self.path = str(path)

    def emit(self, alert: Dict) -> None:
        append_line(self.path, json.dumps(alert, sort_keys=True))

    def _lines(self) -> List[str]:
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return []
        return raw.decode("utf-8", errors="replace").split("\n")

    def keys(self) -> Set[str]:
        out: Set[str] = set()
        for line in self._lines():
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue  # torn/garbage line: never acked
            if isinstance(d, dict) and d.get("key"):
                out.add(str(d["key"]))
        return out

    def alerts(self) -> List[Dict]:
        """Every parseable delivered alert, in delivery order (the
        invariant checker's consumer view)."""
        out = []
        for line in self._lines():
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict) and d.get("key"):
                out.append(d)
        return out

    def recover(self) -> None:
        try:
            with open(self.path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                if size == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                last = fh.read(1)
        except OSError:
            return  # absent: nothing to repair
        if last != b"\n":
            # Terminate the torn line so the next append starts clean.
            append_line(self.path, "")


class FlakySink(AlertSink):
    """Deterministic failure wrapper for tests and brownout drills:
    the first ``fail_n`` emits raise :class:`SinkError` (a timeout/
    brownout look-alike), then the inner sink takes over.  Failures
    never ack — exactly the window the breaker + durable queue must
    cover."""

    name = "flaky"

    def __init__(self, inner: AlertSink, fail_n: int):
        self.inner = inner
        self.fail_n = int(fail_n)
        self.attempts = 0
        self.failures = 0

    def emit(self, alert: Dict) -> None:
        self.attempts += 1
        if self.failures < self.fail_n:
            self.failures += 1
            raise SinkError(
                f"injected sink brownout ({self.failures}/{self.fail_n})"
            )
        self.inner.emit(alert)

    def keys(self) -> Set[str]:
        return self.inner.keys()

    def recover(self) -> None:
        self.inner.recover()


def build_sink(spec: str) -> AlertSink:
    """CLI sink factory: ``jsonl:<path>`` (or a bare path, which means
    the same).  Unknown schemes raise — a misrouted alert sink must
    fail loudly at startup, not drop alerts quietly."""
    if ":" in spec:
        scheme, _, rest = spec.partition(":")
        if scheme != "jsonl":
            raise ValueError(f"unknown sink scheme {scheme!r} "
                             "(known: jsonl)")
        return JsonlSink(rest)
    return JsonlSink(spec)
