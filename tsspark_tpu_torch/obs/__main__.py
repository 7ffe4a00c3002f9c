"""``python -m tsspark_tpu_torch.obs`` — render a run's observability story
(the port's copy of the JAX package's ``obs/__main__.py``).

Subcommands::

    report [target]   end-to-end timeline + RED/SLO summary.  ``target``
                      is a RUNLEDGER_*.json, a directory holding
                      spans.jsonl files (a run scratch), or omitted —
                      then the newest RUNLEDGER_*.json in the cwd.
                      ``--chrome-trace OUT`` instead exports the spans
                      as Chrome/Perfetto trace-event JSON (open at
                      ui.perfetto.dev) for timeline debugging.
    ledger <dir> [-o OUT]   build + write a RUNLEDGER from a scratch dir
    prom <target>     Prometheus text from a metrics_*.json snapshot or
                      a ledger's embedded snapshots
    history [root]    cross-run trajectory from RUNHISTORY.jsonl;
                      ``--backfill`` ingests the committed BENCH/SERVE/
                      CHAOS/EVAL/RUNLEDGER artifacts under ``root``
    sentinel <artifact>   ingest one report + judge it against the
                      rolling history baseline (exit 1 on breach)
    watch <scratch>   tail an in-flight run's spans + metric snapshots
                      and evaluate the SLO budgets live

Device-free: imports no torch (same contract as
``-m tsspark_tpu_torch.perf``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional


def _load_ledger(target: Optional[str]) -> Dict:
    from tsspark_tpu_torch.obs import ledger as ledger_mod

    if target is None:
        cands = sorted(glob.glob("RUNLEDGER_*.json"),
                       key=lambda p: os.path.getmtime(p))
        if not cands:
            raise SystemExit(
                "no RUNLEDGER_*.json in the cwd; pass a ledger file or "
                "a run scratch directory"
            )
        target = cands[-1]
    if os.path.isdir(target):
        return ledger_mod.build_ledger(target)
    with open(target) as fh:
        d = json.load(fh)
    if d.get("kind") != "run-ledger":
        raise SystemExit(f"{target}: not a run ledger (kind={d.get('kind')})")
    return d


def _fmt_dur(dur) -> str:
    if dur is None:
        return "…open"
    if dur >= 1.0:
        return f"{dur:.2f}s"
    return f"{dur * 1e3:.1f}ms"


def _render_timeline(ledger: Dict, max_rows: int) -> List[str]:
    spans = ledger.get("spans", [])
    t_base = ledger.get("t0") or 0.0
    children: Dict[Optional[str], List[Dict]] = {}
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        parent = s.get("parent_id")
        if parent is not None and parent not in by_id:
            parent = None  # orphan: render at the root, flagged below
        children.setdefault(parent, []).append(s)
    for group in children.values():
        group.sort(key=lambda s: s.get("t0") or 0.0)
    lines: List[str] = []

    def walk(parent: Optional[str], depth: int) -> None:
        for s in children.get(parent, ()):
            if len(lines) >= max_rows:
                return
            attrs = s.get("attrs") or {}
            bits = " ".join(
                f"{k}={v}" for k, v in sorted(attrs.items())
                if isinstance(v, (int, float, str, bool))
            )
            mark = " !" if s.get("status") == "err" else ""
            lines.append(
                f"  [{(s.get('t0') or 0.0) - t_base:9.3f}s] "
                f"{'  ' * depth}{s.get('name')} "
                f"({_fmt_dur(s.get('dur_s'))}) pid={s.get('pid')}"
                f"{(' ' + bits) if bits else ''}{mark}"
            )
            walk(s["span_id"], depth + 1)

    walk(None, 0)
    if len(lines) >= max_rows:
        lines.append(f"  ... ({len(spans)} spans total; --max-rows to "
                     f"see more)")
    return lines


def _chrome_trace(ledger: Dict, path: str) -> str:
    """Export a ledger's spans/events as Chrome trace-event JSON
    (``ph: X`` complete events; still-open spans extend to the trace
    end so a SIGKILLed worker's span is visible, not invisible)."""
    from tsspark_tpu_torch.utils.atomic import atomic_write

    t_base = ledger.get("t0") or 0.0
    # Trace end covers open spans' starts and event timestamps too: a
    # run that wedges at the end has its latest activity in exactly
    # those records, and computing the end off closed spans alone would
    # render the wedged worker's span as a zero-width sliver.
    marks = [
        s["t0"] + s["dur_s"] for s in ledger.get("spans", ())
        if s.get("t0") is not None and s.get("dur_s") is not None
    ] + [
        s["t0"] for s in ledger.get("spans", ())
        if s.get("t0") is not None
    ] + [
        e["t"] for e in ledger.get("events", ()) if e.get("t") is not None
    ]
    t_end = max(marks) if marks else t_base
    evs: List[Dict] = []
    for s in ledger.get("spans", ()):
        t0 = s.get("t0")
        if t0 is None:
            continue
        dur = s.get("dur_s")
        if dur is None:
            # Open span: extend to the trace end, floored at 1 ms so
            # even the LAST thing that happened stays visible.
            dur = max(1e-3, t_end - t0)
        args_d = {
            k: v for k, v in (s.get("attrs") or {}).items()
            if isinstance(v, (int, float, str, bool))
        }
        args_d["span_id"] = s.get("span_id")
        args_d["status"] = s.get("status")
        name = s.get("name") or "?"
        evs.append({
            "name": name, "cat": name.split(".")[0], "ph": "X",
            "ts": round((t0 - t_base) * 1e6, 1),
            "dur": round(dur * 1e6, 1),
            "pid": s.get("pid") or 0, "tid": s.get("pid") or 0,
            "args": args_d,
        })
    for e in ledger.get("events", ()):
        evs.append({
            "name": e.get("name") or "?", "cat": "event", "ph": "i",
            "s": "p",
            "ts": round(((e.get("t") or t_base) - t_base) * 1e6, 1),
            "pid": e.get("pid") or 0, "tid": e.get("pid") or 0,
            "args": e.get("attrs") or {},
        })
    payload = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": ledger.get("trace_id")},
    }
    atomic_write(path, lambda fh: json.dump(payload, fh), mode="w")
    return path


def _report(args) -> int:
    ledger = _load_ledger(args.target)
    if getattr(args, "chrome_trace", None):
        out = _chrome_trace(ledger, args.chrome_trace)
        print(f"chrome trace: {len(ledger.get('spans', []))} spans, "
              f"{len(ledger.get('events', []))} events, trace "
              f"{ledger.get('trace_id')} -> {out} "
              "(open at ui.perfetto.dev or chrome://tracing)")
        return 0
    t_base = ledger.get("t0") or 0.0
    print(
        f"run ledger: trace {ledger.get('trace_id')} | "
        f"{len(ledger.get('spans', []))} spans across "
        f"{len(ledger.get('processes', []))} process(es) | "
        f"wall {ledger.get('wall_s')}s"
    )
    orphans = ledger.get("orphan_spans", [])
    print(f"orphan spans: {len(orphans)}"
          + (f"  {orphans[:8]}" if orphans else ""))
    ms = ledger.get("milestones") or {}
    if ms:
        print("milestones (s from trace start):")
        for k, v in sorted(ms.items(), key=lambda kv: kv[1]):
            print(f"  {v - t_base:9.3f}  {k}")
    print("timeline:")
    for line in _render_timeline(ledger, args.max_rows):
        print(line)
    red = ledger.get("red") or {}
    if red:
        print("RED summary (per span name):")
        for name, r in sorted(red.items()):
            rate = f"{r['rate_per_s']}/s" if r.get("rate_per_s") else "-"
            print(
                f"  {name:<22} n={r['n']:<6} err={r['err']:<4} "
                f"open={r.get('open', 0):<3} rate={rate:<10} "
                f"p50={r['p50_ms']}ms p99={r['p99_ms']}ms "
                f"max={r['max_ms']}ms"
            )
    mttr = {k: v for k, v in (ledger.get("mttr_s") or {}).items()}
    if mttr:
        print("MTTR from spans (per fault class):")
        for cls, v in sorted(mttr.items()):
            print(f"  {cls:<18} "
                  + (f"{v}s" if v is not None else "NO RECOVERY"))
    reports = ledger.get("reports") or []
    if reports:
        print("joined reports:")
        for r in reports:
            print(f"  {r.get('kind')} trace={r.get('trace_id')} "
                  f"ok={r.get('ok')} joined={r.get('joined')}")
    return 0


def _ledger(args) -> int:
    from tsspark_tpu_torch.obs import ledger as ledger_mod

    ledger = ledger_mod.build_ledger(args.dir)
    out = ledger_mod.write_ledger(ledger, args.out)
    print(
        f"run ledger: {len(ledger['spans'])} spans, "
        f"{len(ledger['events'])} events, trace "
        f"{ledger['trace_id']} -> {out}"
    )
    return 0


def _prom(args) -> int:
    from tsspark_tpu_torch.obs.metrics import prometheus_text

    with open(args.target) as fh:
        d = json.load(fh)
    if d.get("kind") == "metrics-snapshot":
        sys.stdout.write(prometheus_text(d.get("metrics", {})))
        return 0
    if d.get("kind") == "run-ledger":
        for snap in d.get("metrics", []):
            sys.stdout.write(prometheus_text(snap.get("metrics", {})))
        return 0
    raise SystemExit(f"{args.target}: neither a metrics snapshot nor a "
                     "run ledger")


def _history(args) -> int:
    from tsspark_tpu_torch.obs import history as hist

    hpath = args.history or os.path.join(args.root, hist.HISTORY_FILE)
    if args.backfill:
        summary = hist.backfill(args.root, hpath)
        print(f"backfill: +{len(summary['ingested'])} row(s), "
              f"{len(summary['skipped'])} already indexed -> "
              f"{summary['history']}")
    for path in args.ingest or ():
        row, appended = hist.ingest_path(path, hpath)
        if appended:
            state = "ingested"
        elif row is not None:
            state = "already indexed"
        elif not os.path.exists(path):
            state = "missing file"
        else:
            state = "not a known artifact family"
        print(f"ingest {path}: {state}")
    rows = hist.read_history(hpath)
    print(f"run history: {len(rows)} row(s) ({hpath})")
    for line in hist.trajectory(rows):
        print(line)
    return 0


def _sentinel(args) -> int:
    from tsspark_tpu_torch.obs import regress

    try:
        with open(args.artifact) as fh:
            rep = json.load(fh)
    except (OSError, ValueError) as e:
        raise SystemExit(f"{args.artifact}: {e}")
    verdict = regress.sentinel_report(
        rep, history_path=args.history, source=args.artifact,
        out=args.out,
    )
    if verdict is None:
        raise SystemExit(
            f"{args.artifact}: not an ingestible run artifact"
        )
    print(regress.summarize(verdict))
    return 0 if verdict["ok"] else 1


def _watch(args) -> int:
    from tsspark_tpu_torch.obs import watch as watch_mod

    return watch_mod.watch(
        args.scratch, history_path=args.history,
        interval_s=args.interval, duration_s=args.duration,
        once=args.once,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tsspark_tpu_torch.obs",
        description="observability reports",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rep = sub.add_parser("report", help="timeline + RED/SLO summary")
    p_rep.add_argument("target", nargs="?", default=None)
    p_rep.add_argument("--max-rows", type=int, default=200)
    p_rep.add_argument("--chrome-trace", default=None, metavar="OUT",
                       help="export spans as Chrome/Perfetto "
                       "trace-event JSON instead of the text report")
    p_led = sub.add_parser("ledger", help="build a RUNLEDGER from a dir")
    p_led.add_argument("dir")
    p_led.add_argument("-o", "--out", default=None)
    p_prom = sub.add_parser("prom", help="Prometheus text dump")
    p_prom.add_argument("target")
    p_hist = sub.add_parser(
        "history", help="cross-run trajectory (RUNHISTORY.jsonl)"
    )
    p_hist.add_argument("root", nargs="?", default=".")
    p_hist.add_argument("--backfill", action="store_true",
                        help="ingest the BENCH/SERVE/CHAOS/EVAL/"
                        "RUNLEDGER artifacts under root first")
    p_hist.add_argument("--history", default=None,
                        help="index path (default: "
                        "<root>/RUNHISTORY.jsonl)")
    p_hist.add_argument("--ingest", action="append", default=None,
                        metavar="FILE",
                        help="additionally ingest this artifact "
                        "(repeatable)")
    p_sent = sub.add_parser(
        "sentinel", help="judge one artifact vs the rolling baseline"
    )
    p_sent.add_argument("artifact")
    p_sent.add_argument("--history", default="RUNHISTORY.jsonl")
    p_sent.add_argument("--out", default=None,
                        help="verdict path (default: "
                        "REGRESSION_<unix>.json)")
    p_watch = sub.add_parser(
        "watch", help="live SLO watch over an in-flight run scratch"
    )
    p_watch.add_argument("scratch")
    p_watch.add_argument("--history", default="RUNHISTORY.jsonl")
    p_watch.add_argument("--interval", type=float, default=2.0)
    p_watch.add_argument("--duration", type=float, default=None)
    p_watch.add_argument("--once", action="store_true",
                         help="one evaluation pass, then exit")
    args = ap.parse_args(argv)
    return {
        "report": _report, "ledger": _ledger, "prom": _prom,
        "history": _history, "sentinel": _sentinel, "watch": _watch,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
