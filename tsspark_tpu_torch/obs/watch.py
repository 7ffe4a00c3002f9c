"""Live SLO watch: tail an in-flight run's scratch and gate it NOW.

``python -m tsspark_tpu_torch.obs watch <scratch>`` (the port's copy of
the JAX package's ``obs/watch.py``) re-reads the run's
``spans.jsonl`` (crash-safe append log — tailing it is always safe) and
its newest ``metrics_*.json`` snapshot every tick, derives the live
state — current stage, series landed and trailing-window series/s,
serve queue depth / shed rate / breaker state, live request p99 — and
evaluates the SAME SLO budgets the post-run sentinel applies
(``obs.regress`` over ``pyproject [tool.tsspark.slo]``) against the
run-history baselines, continuously.

A breach is recorded back into the run's own trace as an
``slo.breach`` event (same spans.jsonl, same trace id — deduplicated
per metric), so it lands in the run ledger next to the spans that
caused it; the watcher needs no signal channel to the watched process.

Works against any traced scratch: an orchestrate/bench out dir, a
chaos storm scratch, or a serve daemon's registry dir (pair with
``--metrics-every`` so the daemon exports snapshots periodically).
Device-free: imports no torch.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs import history, ledger, regress

#: Trailing window for the live series/s estimate.
RATE_WINDOW_S = 60.0


def _dominant_trace(records: Sequence[Dict[str, Any]]) -> Optional[str]:
    counts: Dict[str, int] = {}
    for r in records:
        t = r.get("trace_id")
        if t:
            counts[t] = counts.get(t, 0) + 1
    return max(counts, key=counts.get) if counts else None


def _newest_metrics(scratch: str) -> Optional[Dict[str, Any]]:
    """Newest exported metrics snapshot under ``scratch`` (recursive —
    the serve daemon exports next to its registry)."""
    best, best_unix = None, -1.0
    for path in glob.glob(os.path.join(scratch, "**", "metrics_*.json"),
                          recursive=True):
        try:
            with open(path) as fh:
                snap = json.load(fh)
        except (OSError, ValueError):
            continue  # mid-replace or torn: next tick sees it whole
        if not (isinstance(snap, dict)
                and snap.get("kind") == "metrics-snapshot"):
            continue
        unix = snap.get("unix") or 0.0
        if unix >= best_unix:
            best, best_unix = snap, unix
    return best


def _scratch_device(scratch: str) -> Optional[str]:
    """The watched run's device, read off its workers' ``times.jsonl``
    rows (the fit workers stamp one per chunk: the card's name on the
    card) — scopes the live baseline to the right device class so a
    card run's history never gates a CPU smoke run."""
    dev = None
    for path in glob.glob(os.path.join(scratch, "**", "times.jsonl"),
                          recursive=True):
        try:
            with open(path) as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a live writer
                    if isinstance(rec, dict) and rec.get("device"):
                        dev = rec["device"]
        except OSError:
            continue
    return dev


def _metric_lookup(snap: Optional[Dict[str, Any]]) -> Dict[str, float]:
    """Flatten a snapshot into {name[/label=value]: number}."""
    out: Dict[str, float] = {}
    metrics = (snap or {}).get("metrics") or {}
    for c in metrics.get("counters", ()):
        labels = c.get("labels") or {}
        suffix = "".join(f"/{k}={v}" for k, v in sorted(labels.items()))
        out[f"{c['name']}{suffix}"] = c.get("value", 0)
    for g in metrics.get("gauges", ()):
        labels = g.get("labels") or {}
        suffix = "".join(f"/{k}={v}" for k, v in sorted(labels.items()))
        out[f"{g['name']}{suffix}"] = g.get("value", 0.0)
    return out


def observe_run(scratch: str,
                history_rows: Sequence[Dict[str, Any]] = (),
                slo: Optional[Dict[str, Any]] = None,
                now: Optional[float] = None) -> Dict[str, Any]:
    """One observation of the in-flight run (pure read; no side
    effects).  ``now`` pins the rate-window clock for tests."""
    slo = slo or regress.load_slo()
    records = ledger.collect_records(scratch)
    trace = _dominant_trace(records)
    records = [r for r in records if r.get("trace_id") == trace]
    spans, events = ledger.merge_spans(records)

    # Current stage: the latest still-open span wins (depth-first runs
    # leave their whole open ancestry; last t0 = innermost); fall back
    # to the latest completed span's name.
    open_spans = [s for s in spans if s.get("status") == "open"
                  and s.get("t0") is not None]
    stage = None
    if open_spans:
        stage = max(open_spans, key=lambda s: s["t0"]).get("name")
    elif spans:
        stage = spans[-1].get("name")

    # Landed coverage + trailing-window throughput off chunk.land spans
    # (dedup to the last land per range — phase-2 patches rewrite).
    last_land: Dict[Any, Dict[str, Any]] = {}
    for s in spans:
        if s.get("name") != "chunk.land" or s.get("status") != "ok":
            continue
        end = ledger._span_end(s)
        if end is None:
            continue
        a = s.get("attrs") or {}
        key = (a.get("lo"), a.get("hi"))
        prev = last_land.get(key)
        if prev is None or end > prev["end"]:
            last_land[key] = {"end": end, "lo": a.get("lo"),
                              "hi": a.get("hi")}
    series_done = sum(
        (d["hi"] - d["lo"]) for d in last_land.values()
        if isinstance(d["lo"], int) and isinstance(d["hi"], int)
    )
    ends = [d["end"] for d in last_land.values()]
    t_ref = now if now is not None else (max(ends) if ends else None)
    series_per_s = None
    if t_ref is not None and ends:
        t0s = [s["t0"] for s in spans if s.get("t0") is not None]
        lo_t = max(min(t0s or [t_ref]), t_ref - RATE_WINDOW_S)
        window = max(t_ref - lo_t, 1e-6)
        in_window = sum(
            (d["hi"] - d["lo"]) for d in last_land.values()
            if lo_t <= d["end"] <= t_ref
            and isinstance(d["lo"], int) and isinstance(d["hi"], int)
        )
        series_per_s = round(in_window / window, 2)

    # Serve-side live state: metric snapshot + request spans.
    snap = _newest_metrics(scratch)
    flat = _metric_lookup(snap)
    queue_depth = flat.get("tsspark_serve_queue_depth")
    breaker_open = flat.get("tsspark_serve_breaker_open")
    carried = flat.get("tsspark_serve_cache_carried")
    shed = flat.get("tsspark_serve_requests_total/result=shed", 0)
    done = flat.get("tsspark_serve_requests_total/result=completed", 0)
    total = shed + done
    shed_rate = round(shed / total, 4) if total else None
    # Live p99 over the TRAILING window only (same discipline as the
    # series/s estimate): a cumulative percentile would dilute a
    # latency regression that develops mid-run past noticing.
    req = [(ledger._span_end(s), s) for s in spans
           if s.get("name") == "serve.request"
           and ledger._span_end(s) is not None]
    p99_ms = None
    if req:
        t_last = max(e for e, _s in req)
        recent = [s for e, s in req if e >= t_last - RATE_WINDOW_S]
        p99_ms = ledger.red_summary(recent)["serve.request"]["p99_ms"]

    # Live data-to-forecast freshness off the scheduler's
    # refit.freshness spans (t0 = the delta's land time, dur = land ->
    # first-served): trailing-window p95, same discipline as the p99.
    fr = [(ledger._span_end(s), s.get("dur_s")) for s in spans
          if s.get("name") == "refit.freshness"
          and ledger._span_end(s) is not None
          and isinstance(s.get("dur_s"), (int, float))]
    freshness_p95_s = None
    if fr:
        t_last = max(e for e, _d in fr)
        recent_fr = [d for e, d in fr if e >= t_last - RATE_WINDOW_S]
        if recent_fr:
            import numpy as _np

            freshness_p95_s = round(
                float(_np.percentile(_np.asarray(recent_fr), 95)), 4
            )

    # Live land->alert freshness off the alert stream's
    # alerts.freshness spans (t0 = the delta's land time, dur = land ->
    # sink ack of its last alert), plus the stream's own counters from
    # the metric snapshot — the alerts row of the dashboard.
    al = [(ledger._span_end(s), s.get("dur_s")) for s in spans
          if s.get("name") == "alerts.freshness"
          and ledger._span_end(s) is not None
          and isinstance(s.get("dur_s"), (int, float))]
    alerts_p95_s = None
    if al:
        t_last = max(e for e, _d in al)
        recent_al = [d for e, d in al if e >= t_last - RATE_WINDOW_S]
        if recent_al:
            import numpy as _np

            alerts_p95_s = round(
                float(_np.percentile(_np.asarray(recent_al), 95)), 4
            )
    alerts_fired = flat.get("tsspark_alerts_fired_total")
    alerts_suppressed = flat.get("tsspark_alerts_suppressed_total")
    alerts_queued = flat.get("tsspark_alerts_queued")
    alerts_breaker = flat.get("tsspark_alerts_breaker_open")

    # The live row(s), judged by the same sentinel machinery the
    # post-run gate uses — one pseudo-row per family so bench budgets
    # gate throughput and serve budgets gate the read path.
    breaches: List[Dict[str, Any]] = []
    live_rows = []
    device = _scratch_device(scratch)
    dev_class = history.device_class(device)
    if series_per_s is not None:
        live_rows.append({"kind": "bench", "row_id": "live:bench",
                          "device_class": dev_class,
                          "metrics": {"series_per_s": series_per_s}})
    serve_metrics: Dict[str, float] = {}
    if shed_rate is not None:
        serve_metrics["shed_rate"] = shed_rate
    if p99_ms is not None:
        serve_metrics["p99_ms"] = p99_ms
    if serve_metrics:
        live_rows.append({"kind": "serve", "row_id": "live:serve",
                          "device_class": dev_class,
                          "metrics": serve_metrics})
    if freshness_p95_s is not None:
        live_rows.append({
            "kind": "freshness", "row_id": "live:freshness",
            "device_class": dev_class,
            "metrics": {"freshness_p95_s": freshness_p95_s},
        })
    if alerts_p95_s is not None:
        live_rows.append({
            "kind": "alerts", "row_id": "live:alerts",
            "device_class": dev_class,
            "metrics": {"alerts_p95_s": alerts_p95_s},
        })
    verdicts = []
    for live in live_rows:
        v = regress.evaluate(live, history_rows, slo=slo)
        verdicts.append(v)
        breaches.extend(c for c in v["checks"] if not c["ok"])
    return {
        "scratch": scratch,
        "trace_id": trace,
        "stage": stage,
        "n_spans": len(spans),
        "open_spans": len(open_spans),
        "events": len(events),
        "series_done": series_done,
        "series_per_s": series_per_s,
        "queue_depth": queue_depth,
        "shed_rate": shed_rate,
        "breaker": (None if breaker_open is None
                    else ("open" if breaker_open >= 1.0 else "closed")),
        "p99_ms": p99_ms,
        "carried": carried,
        "freshness_p95_s": freshness_p95_s,
        "alerts_p95_s": alerts_p95_s,
        "alerts_fired": alerts_fired,
        "alerts_suppressed": alerts_suppressed,
        "alerts_queued": alerts_queued,
        "alerts_breaker": (None if alerts_breaker is None
                           else ("open" if alerts_breaker >= 1.0
                                 else "closed")),
        "breaches": breaches,
        "verdicts": verdicts,
    }


def _spans_path(scratch: str) -> Optional[str]:
    """The run's span log (first one under the scratch) — breach events
    append THERE so the ledger joins them."""
    if os.path.isfile(scratch):
        return scratch
    cands = sorted(glob.glob(
        os.path.join(scratch, "**", obs.SPANS_FILE), recursive=True
    ))
    return cands[0] if cands else None


def record_breach(scratch: str, trace: Optional[str],
                  check: Dict[str, Any]) -> bool:
    """Append one ``slo.breach`` event to the watched run's own trace
    (no-op when the scratch has no span log yet)."""
    path = _spans_path(scratch)
    if path is None:
        return False
    prev = obs.start_run(path, trace_id=trace)
    try:
        obs.event("slo.breach", source="watch", metric=check["metric"],
                  value=check["value"], bound=check["bound"],
                  median=check["median"], direction=check["direction"])
    finally:
        obs.end_run(prev)
    return True


def format_line(st: Dict[str, Any]) -> str:
    bits = [f"stage={st['stage'] or '-'}"]
    if st["series_done"]:
        bits.append(f"done={st['series_done']}")
    if st["series_per_s"] is not None:
        bits.append(f"series/s={st['series_per_s']}")
    if st["queue_depth"] is not None:
        bits.append(f"queue={int(st['queue_depth'])}")
    if st["shed_rate"] is not None:
        bits.append(f"shed_rate={st['shed_rate']}")
    if st["breaker"] is not None:
        bits.append(f"breaker={st['breaker']}")
    if st["p99_ms"] is not None:
        bits.append(f"p99={st['p99_ms']}ms")
    if st.get("carried") is not None:
        bits.append(f"carried={int(st['carried'])}")
    if st.get("freshness_p95_s") is not None:
        bits.append(f"fresh_p95={st['freshness_p95_s']}s")
    if st.get("alerts_p95_s") is not None:
        bits.append(f"alert_p95={st['alerts_p95_s']}s")
    if st.get("alerts_fired") is not None:
        bits.append(f"alerts={int(st['alerts_fired'])}"
                    f"/{int(st.get('alerts_suppressed') or 0)}supp"
                    f"/{int(st.get('alerts_queued') or 0)}q")
    if st.get("alerts_breaker") is not None:
        bits.append(f"alert_sink={st['alerts_breaker']}")
    if st["breaches"]:
        worst = ", ".join(
            f"{c['metric']}={c['value']} vs bound {c['bound']}"
            for c in st["breaches"]
        )
        bits.append(f"SLO:BREACH({worst})")
    else:
        bits.append("SLO:ok")
    return f"[watch +{st.get('t_offset_s', 0):.0f}s] " + " ".join(bits)


def watch(scratch: str,
          history_path: str = history.HISTORY_FILE,
          interval_s: float = 2.0,
          duration_s: Optional[float] = None,
          once: bool = False,
          emit=print) -> int:
    """Tail ``scratch`` until ``duration_s`` elapses (forever when
    None; one pass with ``once``).  Returns 1 iff any SLO breached."""
    slo = regress.load_slo()
    rows = (history.read_history(history_path)
            if os.path.exists(history_path) else [])
    t_start = time.monotonic()
    recorded: set = set()
    any_breach = False
    while True:
        st = observe_run(scratch, rows, slo=slo)
        st["t_offset_s"] = time.monotonic() - t_start
        emit(format_line(st))
        for check in st["breaches"]:
            any_breach = True
            if check["metric"] not in recorded:
                recorded.add(check["metric"])
                record_breach(scratch, st["trace_id"], check)
        if once:
            break
        if (duration_s is not None
                and time.monotonic() - t_start >= duration_s):
            break
        time.sleep(interval_s)
    return 1 if any_breach else 0
