"""Trace context: one trace id for a run's span log.

The part of the JAX package's ``obs/context.py`` that the port's
streaming driver records through: a *run* binds a (trace_id,
spans_path) pair process-globally (``start_run``), and ``record``
appends one span as a JSON line to ``spans.jsonl``
(``utils.atomic.append_line``: one ``O_APPEND`` write a line, so
concurrent writers never interleave).  The same record layout as the
JAX package's, so one reader (``read_records``) takes both.  Nested
spans, point events and the cross-process propagation come with the
port's orchestrator.

With no run bound, ``record`` is a no-op costing one ``None`` check.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from tsspark_tpu_torch.utils.atomic import append_line

#: File name convention for the per-run span log (one per run dir).
SPANS_FILE = "spans.jsonl"


class Run:
    """A process-global run binding: trace id + span-log path."""

    __slots__ = ("trace_id", "spans_path")

    def __init__(self, trace_id: str, spans_path: Optional[str]):
        self.trace_id = trace_id
        self.spans_path = spans_path

    def write(self, rec: Dict[str, Any]) -> None:
        if self.spans_path is None:
            return
        try:
            append_line(self.spans_path, json.dumps(rec))
        except OSError:
            pass  # observability must never take the workload down


_RUN: Optional[Run] = None


def new_id() -> str:
    """Random 12-hex id (span or trace)."""
    return os.urandom(6).hex()


def active() -> bool:
    return _RUN is not None


def trace_id() -> Optional[str]:
    return _RUN.trace_id if _RUN is not None else None


def start_run(spans_path: Optional[str] = None,
              trace_id: Optional[str] = None) -> Optional[Run]:
    """Bind a run for this process; returns the PREVIOUS binding so a
    caller that nests runs (a test inside a traced run) can restore it
    with ``end_run``."""
    global _RUN
    prev = _RUN
    if spans_path is not None:
        d = os.path.dirname(os.path.abspath(spans_path))
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            spans_path = None
    _RUN = Run(trace_id or new_id(), spans_path)
    return prev


def end_run(prev: Optional[Run] = None) -> None:
    """Restore the previous binding (or unbind)."""
    global _RUN
    _RUN = prev


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _span_rec(name: str, span_id: str, parent_id: Optional[str],
              t0: float, dur_s: Optional[float], status: str,
              attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "kind": "span", "trace_id": trace_id(), "span_id": span_id,
        "parent_id": parent_id, "name": name,
        "t0": round(t0, 6),
        "dur_s": None if dur_s is None else round(dur_s, 6),
        "status": status, "pid": os.getpid(),
        "attrs": attrs,
    }


def record(name: str, t0: float, dur_s: float,
           **attrs: Any) -> Optional[str]:
    """Record a completed span with caller-supplied timings (the
    streaming driver's micro-batch wall).  Returns the span id."""
    if _RUN is None:
        return None
    sid = new_id()
    _RUN.write(_span_rec(name, sid, None, t0, dur_s, "ok", attrs))
    return sid


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def read_records(path: str) -> List[Dict[str, Any]]:
    """All records of one span log (torn last line tolerated — the
    append contract allows a writer killed mid-write to tear it)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out
