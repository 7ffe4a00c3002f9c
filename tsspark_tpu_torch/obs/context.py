"""Trace context: one trace id for a run's span log.

The part of the JAX package's ``obs/context.py`` that the port's
streaming driver and data plane record through: a *run* binds a
(trace_id, spans_path) pair process-globally (``start_run``); the
*current span* rides a contextvar so nested spans parent correctly
(``span``, ``open_span`` / ``close_span``, ``record``, ``event``); and
the binding crosses into a child process through the ``TSSPARK_TRACE``
environment variable (``inject_env`` in the spawner, ``adopt_env`` at
the child's entry: the data plane's ingest driver and its shard pool).
Each record is one JSON line of ``spans.jsonl``
(``utils.atomic.append_line``: one ``O_APPEND`` write a line, so
concurrent writers never interleave), in the JAX package's layout, so
one reader (``read_records``) takes both.  Long-lived spans are written
twice: an ``open`` record at begin and a completion record with the
same span id at end.  ``remote_context`` adopts a remote caller's
trace for one request (the serve daemon's ``trace`` envelope).

With no run bound, every function here is a no-op costing one ``None``
check.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

from tsspark_tpu_torch.utils.atomic import append_line

ENV_VAR = "TSSPARK_TRACE"

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
# Current span id (parent for children): a contextvar, so a background
# thread never clobbers the main thread's position in the tree.
_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "tsspark_obs_span", default=None
)
# Trace override for remote envelopes (serve daemon request lines).
_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "tsspark_obs_trace", default=None
)


def new_id() -> str:
    """Random 12-hex id (span or trace)."""
    return os.urandom(6).hex()


def active() -> bool:
    return _RUN is not None


def trace_id() -> Optional[str]:
    over = _TRACE.get()
    if over is not None:
        return over
    return _RUN.trace_id if _RUN is not None else None


def current_span_id() -> Optional[str]:
    return _SPAN.get()


def current_ids() -> Optional[Dict[str, str]]:
    """{"trace_id", "span_id"} when a span is active (the structured
    logger stamps these onto every event), else None."""
    sid = _SPAN.get()
    if sid is None or not active():
        return None
    return {"trace_id": trace_id(), "span_id": sid}


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
    # Fresh run, fresh tree: a span position left from a previous
    # binding must not become this run's phantom root parent.
    _SPAN.set(None)
    return prev


def end_run(prev: Optional[Run] = None) -> None:
    """Restore the previous binding (or unbind)."""
    global _RUN
    _RUN = prev


def inject_env(env: Dict[str, str],
               parent_id: Optional[str] = None) -> None:
    """Propagate the active run into a child process's environment.
    ``parent_id`` overrides the current span as the child's parent
    (spawners that allocate a per-attempt span pass it explicitly)."""
    if _RUN is None:
        return
    env[ENV_VAR] = json.dumps({
        "trace_id": _RUN.trace_id,
        "parent_span_id": parent_id or _SPAN.get(),
        "spans_path": _RUN.spans_path,
    })


def adopt_env() -> bool:
    """Child-process entry: bind the run the spawner injected (no-op
    when none was).  The injected parent span becomes the current span,
    so everything this process records parents across the boundary."""
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return False
    try:
        d = json.loads(spec)
    except ValueError:
        return False
    start_run(spans_path=d.get("spans_path"),
              trace_id=d.get("trace_id"))
    if d.get("parent_span_id"):
        _SPAN.set(d["parent_span_id"])
    return True


@contextlib.contextmanager
def remote_context(trace: Optional[str],
                   parent_span_id: Optional[str]) -> Iterator[None]:
    """Adopt a REMOTE caller's trace for the duration of one request
    (the serve daemon's JSONL envelope: ``{"trace": {"trace_id": ...,
    "parent_span_id": ...}}``).  Records written inside carry the
    caller's trace id and parent to its span."""
    if not active() or not trace:
        yield
        return
    t_tok = _TRACE.set(trace)
    s_tok = _SPAN.set(parent_span_id)
    try:
        yield
    finally:
        _SPAN.reset(s_tok)
        _TRACE.reset(t_tok)


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


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Optional[str]]:
    """Record a span around a block; yields the span id (None when no
    run is bound).  Exceptions mark the span ``err`` and propagate."""
    if _RUN is None:
        yield None
        return
    sid = new_id()
    parent = _SPAN.get()
    tok = _SPAN.set(sid)
    t0 = time.time()
    m0 = time.monotonic()
    status = "ok"
    try:
        yield sid
    except BaseException:
        status = "err"
        raise
    finally:
        _SPAN.reset(tok)
        _RUN.write(_span_rec(name, sid, parent, t0,
                             time.monotonic() - m0, status, attrs))


def record(name: str, t0: float, dur_s: float, *,
           span_id: Optional[str] = None,
           parent_id: Optional[str] = None,
           status: str = "ok", **attrs: Any) -> Optional[str]:
    """Record a completed span with caller-supplied timings (for sites
    that already own the clock: the fit worker's chunk wall, the
    engine's request latency).  Returns the span id."""
    if _RUN is None:
        return None
    sid = span_id or new_id()
    if parent_id is None:
        parent_id = _SPAN.get()
    _RUN.write(_span_rec(name, sid, parent_id, t0, dur_s, status, attrs))
    return sid


def open_span(name: str, *, span_id: Optional[str] = None,
              parent_id: Optional[str] = None,
              make_current: bool = False, **attrs: Any) -> Optional[str]:
    """Write an ``open`` record NOW (crash-safe parent: a process killed
    mid-span leaves this behind, so children never orphan).  Close with
    ``close_span`` using the returned id."""
    if _RUN is None:
        return None
    sid = span_id or new_id()
    if parent_id is None:
        parent_id = _SPAN.get()
    _RUN.write(_span_rec(name, sid, parent_id, time.time(), None,
                         "open", attrs))
    if make_current:
        _SPAN.set(sid)
    return sid


def close_span(span_id: Optional[str], name: str, t0: float, *,
               status: str = "ok", **attrs: Any) -> None:
    """Completion record for an ``open_span`` (same span id; the ledger
    keeps the completed record)."""
    if _RUN is None or span_id is None:
        return
    _RUN.write(_span_rec(name, span_id, None, t0, time.time() - t0,
                         status, attrs))


def event(name: str, **attrs: Any) -> None:
    """Point annotation on the current span (fault firings, recovery
    marks).  Standalone when no span is active — still joined by trace."""
    if _RUN is None:
        return
    _RUN.write({
        "kind": "event", "trace_id": trace_id(), "span_id": _SPAN.get(),
        "name": name, "t": round(time.time(), 6), "pid": os.getpid(),
        "attrs": attrs,
    })


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
