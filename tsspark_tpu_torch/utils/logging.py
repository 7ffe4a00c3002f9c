"""Structured logging: one JSON object per line, stdlib-logging compatible
(the port's copy of the JAX package's ``utils/logging.py``).

The Spark reference gets structured executor logs from log4j; here a single
process logs fit/refit/bench events as JSON lines so they are grep- and
pandas-loadable.  Usage:

    log = get_logger("tsspark.fit")
    log.info("fit_done", n_series=30490, fit_seconds=42.1)
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Optional


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


class StructuredLogger:
    """Thin wrapper adding keyword fields to stdlib logging.

    When an observability trace is active (``tsspark_tpu_torch.obs``), every
    event is stamped with the current ``trace_id``/``span_id`` — log
    lines then grep-join against the run's span ledger for free.
    """

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, event: str, **fields: Any) -> None:
        from tsspark_tpu_torch.obs import context as _obs

        ids = _obs.current_ids()
        if ids is not None:
            fields = {**ids, **fields}
        self._logger.log(level, event, extra={"fields": fields})

    def debug(self, event: str, **fields: Any) -> None:
        self._log(logging.DEBUG, event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self._log(logging.INFO, event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._log(logging.WARNING, event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self._log(logging.ERROR, event, **fields)


class _DynamicStderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time (plays well with capture/redirect)."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # StreamHandler.__init__ compat; ignored
        pass


_CONFIGURED = False


def get_logger(name: str = "tsspark", level: Optional[int] = None
               ) -> StructuredLogger:
    global _CONFIGURED
    root = logging.getLogger("tsspark")
    if not _CONFIGURED:
        handler = _DynamicStderrHandler()
        handler.setFormatter(_JsonFormatter())
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    logger = logging.getLogger(name)
    if level is not None:
        logger.setLevel(level)
    return StructuredLogger(logger)


class timed:
    """Context manager: logs wall-clock of a block as a structured event.

    Durations come off ``time.monotonic`` — an NTP step or operator
    clock adjustment mid-block must not produce a negative (or wildly
    inflated) ``seconds`` field."""

    def __init__(self, log: StructuredLogger, event: str, **fields: Any):
        self.log, self.event, self.fields = log, event, fields

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *_):
        self.fields["seconds"] = round(time.monotonic() - self.t0, 4)
        if exc_type is not None:
            self.fields["failed"] = True
        self.log.info(self.event, **self.fields)
        return False
