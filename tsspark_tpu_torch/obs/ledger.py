"""The run ledger: one artifact joining a run's every observation (the
port's copy of the JAX package's ``obs/ledger.py``).

``build_ledger`` walks a run's scratch tree and joins, under one trace
id: the span log(s) (``spans.jsonl`` — orchestrate claims/fits/lands,
registry publish/activate/load, streaming batches, engine requests and
dispatches, fault events), exported metrics snapshots
(``metrics_*.json``), and the orchestrate workers' per-chunk perf rows
(``times.jsonl`` — the PerfRecorder-shaped telemetry
``perf.recorder.summarize_times`` summarizes).  ``BENCH_*``/``SERVE_*``/``CHAOS_*`` reports stamped with
the same trace id are embedded by reference (kind + headline), so the
historical artifact formats join without a schema break.

Derived views:

* **span tree + orphan check** — every span's parent must resolve (the
  crash-safe ``open`` records written at span begin are what keeps a
  SIGKILLed worker's children parented);
* **MTTR from spans alone** — each ``fault`` event to the next healthy
  signal, with the same per-class semantics the chaos harness measures
  off claim-file mtimes (``derive_mttr``), so the two must agree;
* **RED summary** — per span name: rate, errors, duration percentiles.

``write_ledger`` persists it atomically as ``RUNLEDGER_<unix>.json``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tsspark_tpu_torch.obs import context
from tsspark_tpu_torch.utils.atomic import atomic_write

#: Span names that count as the pipeline being "healthy again" after a
#: fault (the signals the chaos harness's mtime-based MTTR scan reads
#: off disk: a chunk landing, the phase-2 sentinel, a registry load
#: serving, a streaming batch absorbed, a request answered).
HEALTHY_SPANS = ("chunk.land", "phase2.done", "registry.load",
                 "stream.batch", "serve.request")

#: Classes whose recovery is defined as the END of their stage (the
#: harness measures stream faults against the streaming stage's end,
#: not the next batch — a mid-stream fault is only "recovered" once the
#: stream drains cleanly).
_STAGE_END_CLASSES = ("stream-fault",)


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------


def _walk_files(root: str, match) -> List[str]:
    out = []
    for dirpath, _dirs, names in os.walk(root):
        for name in sorted(names):
            if match(name):
                out.append(os.path.join(dirpath, name))
    return out


def collect_records(root: str) -> List[Dict[str, Any]]:
    """All span/event records under ``root`` (every ``spans.jsonl``)."""
    recs: List[Dict[str, Any]] = []
    if os.path.isfile(root):
        return context.read_records(root)
    for path in _walk_files(root, lambda n: n == context.SPANS_FILE):
        recs.extend(context.read_records(path))
    return recs


def merge_spans(records: Sequence[Dict[str, Any]]
                ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(spans, events): completion records win over their own ``open``
    record (same span id); a span only ever opened stays ``open`` —
    the honest record of a process killed mid-span."""
    spans: Dict[str, Dict[str, Any]] = {}
    events: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("kind") == "event":
            events.append(rec)
            continue
        if rec.get("kind") != "span" or not rec.get("span_id"):
            continue
        sid = rec["span_id"]
        prev = spans.get(sid)
        if prev is None:
            spans[sid] = dict(rec)
        elif prev.get("status") == "open" and rec.get("status") != "open":
            # Completion record: keep the open record's parent (the
            # close side omits it — only the begin site knows it).
            if rec.get("parent_id") is None:
                rec = dict(rec, parent_id=prev.get("parent_id"))
            spans[sid] = dict(rec)
    out = sorted(spans.values(), key=lambda s: (s.get("t0") or 0.0))
    events.sort(key=lambda e: e.get("t") or 0.0)
    return out, events


def orphan_spans(spans: Sequence[Dict[str, Any]]) -> List[str]:
    """Span ids whose parent id resolves to no span in the ledger
    (parentless roots are fine — ``parent_id: null``)."""
    ids = {s["span_id"] for s in spans}
    return sorted(
        s["span_id"] for s in spans
        if s.get("parent_id") and s["parent_id"] not in ids
    )


def _span_end(s: Dict[str, Any]) -> Optional[float]:
    if s.get("t0") is None or s.get("dur_s") is None:
        return None
    return float(s["t0"]) + float(s["dur_s"])


# ---------------------------------------------------------------------------
# MTTR from spans alone
# ---------------------------------------------------------------------------


def derive_mttr(spans: Sequence[Dict[str, Any]],
                events: Sequence[Dict[str, Any]]
                ) -> Dict[str, Optional[float]]:
    """Per-fault-class MTTR read off the trace: worst, over that class's
    ``fault`` events, of the gap to the next healthy signal.

    Semantics mirror the chaos harness's claim-file-mtime measurement
    (``chaos.invariants``) so the two agree to within write latency:

    * direct-mode faults pair with their explicit ``recovered`` event;
    * stage-end classes recover at their enclosing stage span's end;
    * everything else recovers at the first healthy span
      (``HEALTHY_SPANS``, status ok, not itself fault-tainted) ending
      after the fault inside the same stage window, with the stage end
      as the fallback when nothing healthy followed.
    """
    stages = [s for s in spans if s.get("name", "").startswith("stage.")
              and _span_end(s) is not None]
    healthy = [
        (_span_end(s), s) for s in spans
        if s.get("name") in HEALTHY_SPANS and s.get("status") == "ok"
        and not (s.get("attrs") or {}).get("corrupted")
        and _span_end(s) is not None
    ]
    healthy.sort(key=lambda p: p[0])
    recovered: Dict[str, List[float]] = {}
    faults: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        tag = (ev.get("attrs") or {}).get("tag")
        if not tag or ev.get("t") is None:
            continue
        if ev.get("name") == "fault":
            faults.setdefault(tag, []).append(ev)
        elif ev.get("name") == "recovered":
            recovered.setdefault(tag, []).append(float(ev["t"]))

    def stage_window(t: float) -> Optional[Tuple[float, float]]:
        best = None
        for s in stages:
            t0, t1 = float(s["t0"]), _span_end(s)
            if t0 <= t <= t1 and (best is None
                                  or t1 - t0 < best[1] - best[0]):
                best = (t0, t1)
        return best

    def first_healthy(t: float, end: Optional[float]
                      ) -> Optional[float]:
        """Earliest healthy-span end after ``t`` inside the window —
        with chunk lands deduplicated to the LAST land per range inside
        it: a phase-2 patch (or a corruption refit) rewrites its chunk
        file, so an on-disk mtime scan only ever sees a range's final
        land, and the span measure must count the same signal.  The
        window scoping also keeps the fault-free reference run's lands
        (same ranges, different stage) out of the storm's recovery."""
        last_land: Dict[Any, float] = {}
        others: List[float] = []
        for e, s in healthy:
            if end is not None and e > end + 0.5:
                continue
            if s.get("name") == "chunk.land":
                a = s.get("attrs") or {}
                key = (a.get("lo"), a.get("hi"))
                last_land[key] = max(last_land.get(key, 0.0), e)
            else:
                others.append(e)
        cands = [e for e in list(last_land.values()) + others if e > t]
        return min(cands) if cands else None

    out: Dict[str, Optional[float]] = {}
    for cls, evs in faults.items():
        worst: Optional[float] = 0.0
        for ev in evs:
            t = float(ev["t"])
            mode = (ev.get("attrs") or {}).get("mode")
            nxt: Optional[float] = None
            if mode == "direct" or recovered.get(cls):
                nxt = next((r for r in sorted(recovered.get(cls, ()))
                            if r > t), None)
            else:
                win = stage_window(t)
                end = win[1] if win else None
                if cls not in _STAGE_END_CLASSES:
                    nxt = first_healthy(t, end)
                if nxt is None:
                    nxt = end if end is not None and end > t else None
            if nxt is None:
                worst = None
                break
            worst = max(worst, nxt - t)
        out[cls] = worst
    return out


# ---------------------------------------------------------------------------
# RED summary
# ---------------------------------------------------------------------------


def red_summary(spans: Sequence[Dict[str, Any]]) -> Dict[str, Dict]:
    """Rate / Errors / Duration per span name (the SLO view)."""
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(s)
    out: Dict[str, Dict] = {}
    for name, group in sorted(by_name.items()):
        durs = sorted(float(s["dur_s"]) for s in group
                      if s.get("dur_s") is not None)
        t0s = [float(s["t0"]) for s in group if s.get("t0") is not None]
        window = (max(t0s) - min(t0s)) if len(t0s) > 1 else 0.0

        def pct(q: float) -> Optional[float]:
            if not durs:
                return None
            # Nearest-rank: ceil(q*n)-1, not int(q*n) — the latter is
            # one rank high whenever q*n is integral (p99 of 100
            # samples would read as the max).  round() first: float
            # q*n lands a hair above the integer (0.99*100 -> 99.0…01)
            # and a bare ceil would re-introduce the off-by-one.
            i = min(len(durs) - 1,
                    max(0, math.ceil(round(q * len(durs), 9)) - 1))
            return round(durs[i] * 1e3, 3)

        out[name] = {
            "n": len(group),
            "err": sum(1 for s in group if s.get("status") == "err"),
            "open": sum(1 for s in group if s.get("status") == "open"),
            "rate_per_s": (round(len(group) / window, 2) if window > 0
                           else None),
            "p50_ms": pct(0.50), "p99_ms": pct(0.99),
            "max_ms": (round(durs[-1] * 1e3, 3) if durs else None),
            "total_s": round(sum(durs), 4),
        }
    return out


def milestones(spans: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """First occurrence of each pipeline landmark (chunk claim -> fit ->
    land -> publish -> activate -> first cache-hit forecast)."""
    firsts: Dict[str, float] = {}
    for s in spans:
        name, t0 = s.get("name"), s.get("t0")
        if name is None or t0 is None:
            continue
        key = None
        if name in ("chunk.claim", "chunk.fit", "chunk.land",
                    "registry.publish", "registry.activate"):
            key = name
        elif (name == "serve.request" and s.get("status") == "ok"
                and (s.get("attrs") or {}).get("cached", 0)):
            key = "serve.first_cache_hit"
        elif name == "serve.request" and s.get("status") == "ok":
            key = "serve.first_forecast"
        if key is not None and key not in firsts:
            firsts[key] = float(t0)
    return firsts


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------


def _collect_times(root: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for path in _walk_files(root, lambda n: n == "times.jsonl"):
        try:
            with open(path) as fh:
                for line in fh:
                    if line.strip():
                        try:
                            rows.append(json.loads(line))
                        except ValueError:
                            pass  # torn tail of a killed worker
        except OSError:
            continue
    return rows


def _collect_metrics(root: str) -> List[Dict[str, Any]]:
    snaps: List[Dict[str, Any]] = []
    for path in _walk_files(
        root, lambda n: n.startswith("metrics_") and n.endswith(".json")
    ):
        try:
            with open(path) as fh:
                snap = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(snap, dict) and snap.get("kind") == "metrics-snapshot":
            snaps.append(snap)
    return snaps


def build_ledger(root: str,
                 reports: Sequence[Dict[str, Any]] = (),
                 trace: Optional[str] = None) -> Dict[str, Any]:
    """Assemble the run ledger for the run recorded under ``root`` (a
    scratch tree holding ``spans.jsonl`` files, or one span log).

    ``reports``: already-parsed BENCH/SERVE/CHAOS dicts to join (only
    their headline is embedded).  ``trace``: restrict to one trace id
    (default: the dominant one in the span log).
    """
    from tsspark_tpu_torch.perf.recorder import summarize_times

    records = collect_records(root)
    if trace is None:
        counts: Dict[str, int] = {}
        for r in records:
            t = r.get("trace_id")
            if t:
                counts[t] = counts.get(t, 0) + 1
        trace = max(counts, key=counts.get) if counts else None
    records = [r for r in records if r.get("trace_id") == trace]
    spans, events = merge_spans(records)
    times = _collect_times(root) if os.path.isdir(root) else []
    report_refs = []
    for rep in reports:
        if not isinstance(rep, dict):
            continue
        report_refs.append({
            "kind": rep.get("kind"),
            "unix": rep.get("unix"),
            "trace_id": rep.get("trace_id"),
            "ok": rep.get("ok"),
            "joined": rep.get("trace_id") == trace,
        })
    ends = [e for e in (_span_end(s) for s in spans) if e is not None]
    t0s = [s["t0"] for s in spans if s.get("t0") is not None]
    return {
        "kind": "run-ledger",
        "unix": round(time.time(), 3),
        "trace_id": trace,
        "t0": min(t0s) if t0s else None,
        "wall_s": (round(max(ends) - min(t0s), 3)
                   if ends and t0s else None),
        "processes": sorted({s.get("pid") for s in spans
                             if s.get("pid") is not None}),
        "spans": spans,
        "events": events,
        "orphan_spans": orphan_spans(spans),
        "mttr_s": {k: (None if v is None else round(v, 3))
                   for k, v in sorted(derive_mttr(spans, events).items())},
        "red": red_summary(spans),
        "milestones": {k: round(v, 3)
                       for k, v in milestones(spans).items()},
        "perf": summarize_times(times) if times else None,
        "metrics": _collect_metrics(root) if os.path.isdir(root) else [],
        "reports": report_refs,
    }


def write_ledger(ledger: Dict[str, Any],
                 path: Optional[str] = None) -> str:
    """Persist a ledger as ``RUNLEDGER_<unix>.json`` (atomic, like every
    other report artifact)."""
    out = path or f"RUNLEDGER_{int(ledger.get('unix', time.time()))}.json"
    atomic_write(out, lambda fh: json.dump(ledger, fh, indent=1),
                 mode="w")
    return out
