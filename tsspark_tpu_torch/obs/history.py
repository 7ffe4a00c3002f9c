"""Cross-run history index: one normalized row per run artifact (the
port's copy of the JAX package's ``obs/history.py``, row for row).

A run with a trace, metrics and a ledger still dies alone: BENCH /
SERVE / CHAOS / EVAL artifacts sit side by side with no machine-readable
trajectory joining them, so a throughput or MTTR regression is caught
only if a human diffs JSON by hand.  This module is the temporal half of
observability: every report artifact the
package emits is normalized into ONE flat row schema and appended to
``RUNHISTORY.jsonl`` — trace id, git rev, NUMERICS_REV, config
fingerprint, device class, workload key, and a flat metric map
(series/s, first-flush, compile misses, serve p50/p95/p99 + shed/hit
rate, per-fault-class MTTR, sMAPE/parity deltas).

Contracts (same discipline as the span log):

* **append-only + crash-safe** — rows go down through
  ``utils.atomic.append_line`` (one ``O_APPEND`` write per row), and
  readers tolerate a torn final line;
* **idempotent by trace id** — a row's identity is
  ``<kind>:<trace_id>`` (content hash when the artifact predates trace
  stamping); re-ingesting the same artifact is a no-op, so every
  entrypoint can self-ingest unconditionally;
* **device-free** — imports neither torch nor the kernels (a history
  read must work on a machine whose card is wedged).

``backfill`` ingests the committed round artifacts (BENCH_r01–r06,
EVAL_*, plus any SERVE/CHAOS/RUNLEDGER files present) so the trajectory
starts with the project's recorded past, not an empty file.  The
regression sentinel (``obs.regress``) reads this index for its rolling
baselines.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tsspark_tpu_torch.obs.context import read_records
from tsspark_tpu_torch.utils.atomic import append_line

#: File name convention for the cross-run index (one per working dir,
#: next to the BENCH_*/SERVE_*/CHAOS_* artifacts it normalizes).
HISTORY_FILE = "RUNHISTORY.jsonl"

#: Artifact families the backfill scans for (filename prefixes).
FAMILIES = ("BENCH_", "SERVE_", "CHAOS_", "EVAL_", "RUNLEDGER_",
            "SCALE_", "ANALYSIS_")

_git_rev_cache: Dict[str, Optional[str]] = {}


def git_rev(root: Optional[str] = None) -> Optional[str]:
    """Short git revision of ``root`` (default: the checkout this
    package is imported from — a run's cwd is usually a scratch dir,
    but the code that produced the artifact lives here); None outside a
    checkout.  Cached per root — report emitters stamp it once per run."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
    key = os.path.abspath(root)
    if key not in _git_rev_cache:
        rev = None
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=10", "HEAD"],
                cwd=key, capture_output=True, text=True, timeout=10,
            )
            if out.returncode == 0:
                rev = out.stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            pass
        _git_rev_cache[key] = rev
    return _git_rev_cache[key]


def device_class(device: Optional[str]) -> Optional[str]:
    """Coarse accelerator class for baseline comparability: numbers off
    a TPU run must never gate a CPU-degraded run (or vice versa)."""
    if not device:
        return None
    d = str(device).lower()
    if "tpu" in d:
        return "tpu"
    if "cpu" in d:
        return "cpu"
    if "gpu" in d or "cuda" in d:
        return "gpu"
    return None


def _put(metrics: Dict[str, float], name: str, value: Any) -> None:
    """Admit only finite numbers (bools as 0/1) into the flat map."""
    if isinstance(value, bool):
        metrics[name] = int(value)
    elif isinstance(value, (int, float)) and value == value:  # not NaN
        metrics[name] = value


# ---------------------------------------------------------------------------
# per-family normalizers
# ---------------------------------------------------------------------------


def _bench_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    rc = None
    parsed: Optional[Dict[str, Any]] = rep
    if "cmd" in rep and "parsed" in rep:
        # Driver wrapper (BENCH_r01–r05): {"n", "cmd", "rc", "tail",
        # "parsed"} — the summary line lives under "parsed" (null when
        # the run never printed one; the row still records the rc so a
        # crashed round is a visible point on the trajectory).
        rc = rep.get("rc")
        parsed = rep.get("parsed")
    m: Dict[str, float] = {}
    if rc is not None:
        _put(m, "rc", rc)
    if not isinstance(parsed, dict):
        return {"kind": "bench", "trace_id": None, "unix": None,
                "workload": None, "device": None, "numerics_rev": None,
                "config_fingerprint": None, "git_rev": None, "metrics": m}
    extra = parsed.get("extra") or {}
    perf = extra.get("perf") or {}
    _put(m, "fit_wall_s", parsed.get("value"))
    for k in ("series_done", "datagen_s", "datagen_share",
              "ingest_wall_s", "ingest_overlap_s", "wall_s",
              "smape_insample_mean", "converged_frac", "phase2_s",
              "worker_retries", "complete"):
        _put(m, k, extra.get(k))
    # Throughput only exists when series actually landed: a wedged run
    # reports series_per_s=0.0 meaning "never ran", and admitting that
    # into the row would drag the sentinel's rolling median to 0 —
    # making the throughput budget vacuous (BENCH_r03-r05 are exactly
    # such rows in the committed trajectory).
    if extra.get("series_done"):
        _put(m, "series_per_s", extra.get("series_per_s"))
        # Path-scoped throughput (the mesh-resident fit's own SLO
        # metric): only stamped by resident-path runs, so its rolling
        # baseline is resident-only by construction.
        _put(m, "resident_series_per_s",
             extra.get("resident_series_per_s"))
    for k in ("first_flush_s", "compile_misses", "n_chunks"):
        _put(m, k, perf.get(k))
    # Delta-refit rows (bench --delta; tsspark_tpu.refit): cycle
    # throughput over the CHANGED set, the cycle wall as a fraction of
    # the same run's measured cold fit+publish wall, and the flip-window
    # cache carry-forward — budgeted in [tool.tsspark.slo.bench].
    for k in ("delta_series_per_s", "delta_wall_frac", "cache_carried",
              "flip_hit_rate"):
        _put(m, k, extra.get(k))
    # The fit path rides the workload key: resident and chunk-file runs
    # of the same shape are DIFFERENT workloads to the regression
    # sentinel — their throughput baselines must never mix.  Only the
    # NON-default path is suffixed: fileproto rows keep the historical
    # key, so the default path's entire committed baseline history stays
    # live instead of being orphaned by a rename.
    workload = parsed.get("metric")
    fit_path = extra.get("fit_path")
    if workload and fit_path and fit_path != "fileproto":
        workload = f"{workload}+{fit_path}"
    # Delta cycles additionally scope on the churn fraction: a 1%-churn
    # cycle's wall must never baseline a 30%-churn cycle's (and the
    # delta metric name already keeps them clear of cold-fit rows).
    delta_churn = extra.get("delta_churn")
    if workload and delta_churn is not None:
        workload = f"{workload}+delta{delta_churn}"
    return {
        "kind": "bench",
        "trace_id": extra.get("trace_id"),
        "unix": parsed.get("unix"),
        "workload": workload,
        "device": extra.get("device"),
        "numerics_rev": extra.get("numerics_rev"),
        "config_fingerprint": extra.get("config_fingerprint"),
        "git_rev": extra.get("git_rev"),
        "metrics": m,
    }


def _serve_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    eng = rep.get("engine") or {}
    lat = eng.get("latency_ms") or {}
    occ = eng.get("batch_occupancy") or {}
    cache = rep.get("cache") or {}
    pool = rep.get("pool") or {}
    m: Dict[str, float] = {}
    for k in ("p50", "p95", "p99", "mean", "max"):
        _put(m, f"{k}_ms", lat.get(k))
    for k in ("requests_per_s", "wall_s"):
        _put(m, k, rep.get(k))
    for k in ("submitted", "completed", "shed", "failed", "rejected",
              "fast_failed"):
        _put(m, k, eng.get(k))
    submitted = eng.get("submitted")
    if isinstance(submitted, (int, float)) and submitted:
        _put(m, "shed_rate",
             round(float(eng.get("shed", 0)) / submitted, 4))
    _put(m, "hit_rate", cache.get("hit_rate"))
    _put(m, "mean_fill", occ.get("mean_fill"))
    if pool:
        # Replica-pool loadgen rows (``serve/__main__.py --pool``):
        # aggregate throughput, failover count, and the flip-window p99
        # are the pool's SLO metrics ([tool.tsspark.slo.serve]).
        _put(m, "agg_requests_per_s", rep.get("requests_per_s"))
        _put(m, "failovers", pool.get("failovers"))
        _put(m, "respawns", pool.get("respawns"))
        _put(m, "wrong_version", pool.get("wrong_version"))
        _put(m, "flip_p99_ms", (pool.get("flip") or {}).get("p99_ms"))
        for slot, st in sorted((pool.get("per_replica") or {}).items()):
            if isinstance(st, dict):
                _put(m, f"replica{slot}_shed", st.get("shed"))
    plane = rep.get("plane") or {}
    if plane:
        # Forecast-plane serve rows (the JAX package's bench
        # --serveplane): plane hit rate and the zero-dispatch read
        # p99 are SLO metrics ([tool.tsspark.slo.serve]); throughputs
        # and TTFR ride along as trajectory context.
        _put(m, "plane_hit_rate", plane.get("plane_hit_rate"))
        _put(m, "plane_read_p99_ms",
             (plane.get("read_latency_ms") or {}).get("p99"))
        _put(m, "plane_requests_per_s",
             (plane.get("hot_read") or {}).get("plane_rps"))
        _put(m, "dispatch_requests_per_s",
             (plane.get("hot_read") or {}).get("dispatch_rps"))
        _put(m, "plane_publish_s", plane.get("publish_s"))
        _put(m, "ttfr_cold_s", (plane.get("ttfr") or {}).get("cold_s"))
        _put(m, "ttfr_aot_warm_s",
             (plane.get("ttfr") or {}).get("aot_warm_s"))
    workload = (f"loadgen_{rep.get('n_requests')}"
                f"x{rep.get('n_series')}")
    if pool:
        workload = f"pool{pool.get('replicas')}_{workload}"
    if plane:
        # Its own baseline family: a plane row's throughput/latency mix
        # (cache-disabled hot reads) must never judge — or be judged
        # by — an ordinary loadgen row.
        workload = f"serveplane_{workload}"
    return {
        "kind": "serve",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": workload,
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _serveplane_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Forecast-plane serve rows (bench --serveplane): the ordinary
    serve normalization re-kinded into its OWN row family.  A plane
    row's metric mix (cache-disabled hot reads, TTFR probes, publish
    walls) is a different experiment from an ordinary loadgen — giving
    it a family gives it its own trajectory block and its own SLO
    section ([tool.tsspark.slo.serveplane]) instead of riding serve's."""
    return dict(_serve_row(rep), kind="serveplane")


def _calibration_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Uncertainty-tier calibration rows (bench --uncertainty;
    uncertainty/calibrate.py).  The headline is coverage_abs_gap —
    |empirical - nominal| coverage of the served intervals on held-out
    data, the one metric that catches a silently mis-calibrated
    posterior — plus the ADVI fit throughput, the quantile plane's
    zero-dispatch read p99, and the NUTS gold audit's divergence.
    Budgeted in [tool.tsspark.slo.calibration]."""
    cal = rep.get("calibration") or {}
    m: Dict[str, float] = {}
    for k in ("coverage_abs_gap", "fit_s", "advi_fit_s",
              "advi_series_per_s", "publish_s", "nbytes",
              "qread_p99_ms", "draws"):
        _put(m, k, cal.get(k))
    _put(m, "wall_s", rep.get("wall_s"))
    _put(m, "mode_advi", cal.get("mode") == "advi")
    for hb, b in sorted((cal.get("buckets") or {}).items()):
        if isinstance(b, dict):
            _put(m, f"coverage_abs_gap_h{hb}", b.get("coverage_abs_gap"))
    gold = cal.get("gold") or {}
    for k in ("qdiv_max", "qdiv_mean", "rhat_max", "ess_min",
              "hmc_divergences"):
        _put(m, k, gold.get(k))
    return {
        "kind": "calibration",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": (f"calibration_{rep.get('n_series')}"
                     f"x{rep.get('holdout')}"),
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _scale_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Scale-ladder rung rows (bench --scale; tsspark_tpu.bench_scale).
    The rung name IS part of the workload key: a 1M-series row must
    never baseline against a smoke row — the same flat-namespace
    discipline as the fit path's suffix."""
    fit = rep.get("fit") or {}
    pub = rep.get("publish") or {}
    serve = rep.get("serve") or {}
    mem = serve.get("mem") or {}
    lat = serve.get("latency_ms") or {}
    flip = serve.get("flip") or {}
    cmp_ = serve.get("rss_compare") or {}
    m: Dict[str, float] = {}
    _put(m, "complete", rep.get("complete"))
    _put(m, "wall_s", rep.get("wall_s"))
    _put(m, "ingest_s", (rep.get("ingest") or {}).get("ingest_s"))
    _put(m, "fit_s", fit.get("fit_s"))
    if fit.get("series_done"):
        _put(m, "series_per_s", fit.get("series_per_s"))
    _put(m, "publish_s", pub.get("publish_s"))
    _put(m, "snapshot_mb", pub.get("snapshot_mb"))
    _put(m, "time_to_first_request_s",
         serve.get("time_to_first_request_s"))
    _put(m, "agg_requests_per_s", serve.get("agg_requests_per_s"))
    _put(m, "p50_ms", lat.get("p50"))
    _put(m, "p99_ms", lat.get("p99"))
    _put(m, "flip_p99_ms", flip.get("p99_ms"))
    _put(m, "rss_mb_per_replica", mem.get("rss_mb_per_replica"))
    _put(m, "pss_mb_per_replica", mem.get("pss_mb_per_replica"))
    _put(m, "rss_anon_mb_per_replica",
         mem.get("rss_anon_mb_per_replica"))
    _put(m, "snap_pss_total_mb", mem.get("snap_pss_total_mb"))
    _put(m, "rss_reduction_x", cmp_.get("rss_reduction_x"))
    _put(m, "wrong_version", serve.get("wrong_version"))
    return {
        "kind": "scale",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": f"scale_{rep.get('rung')}",
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _freshness_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Freshness-stream rows (bench --freshness; tsspark_tpu.sched).
    The workload key carries the rung, churn, AND loop mode: a
    pipelined stream must never baseline a serialized one — the p95
    gap between them is exactly the metric the bench exists to show."""
    m: Dict[str, float] = {}
    for k in ("freshness_p50_s", "freshness_p95_s",
              "freshness_mean_s", "freshness_vs_cold_frac",
              "cycle_overhead_frac", "spec_hit_rate", "cycles",
              "wrong_version", "probe_failures", "cold_wall_s",
              "complete", "wall_s"):
        _put(m, k, rep.get(k))
    churn = rep.get("churn")
    churn_key = (f"c{int(round(float(churn) * 1000)):04d}"
                 if isinstance(churn, (int, float)) else "c?")
    return {
        "kind": "freshness",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": (f"freshness_{rep.get('rung')}_{churn_key}"
                     f"+{rep.get('mode')}"),
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _alerts_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Alert-stream rows (bench --alerts; tsspark_tpu.alerts).  The
    workload key carries the rung, churn, AND scoring mode: interval
    runs (quantile plane published) must never baseline zscore
    fallback runs — their latency profiles differ by the qplane read
    path itself."""
    m: Dict[str, float] = {}
    for k in ("alerts_p50_s", "alerts_p95_s", "alerts_mean_s",
              "delivered_frac", "fired", "suppressed", "delivered",
              "deduped", "queued", "breaker_opens", "cold_wall_s",
              "complete", "wall_s"):
        _put(m, k, rep.get(k))
    churn = rep.get("churn")
    churn_key = (f"c{int(round(float(churn) * 1000)):04d}"
                 if isinstance(churn, (int, float)) else "c?")
    return {
        "kind": "alerts",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": (f"alerts_{rep.get('rung')}_{churn_key}"
                     f"+{rep.get('mode')}"),
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _analysis_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    """Static-analysis gate rows (python -m tsspark_tpu.analysis;
    analysis/report.py).  The gate's drift metrics — waiver creep,
    suppressed-finding growth, gate runtime — become trajectory points
    so a PR that quietly doubles the waiver count is as visible as one
    that halves throughput.  Only FULL gate runs write the artifact
    (the CLI skips it for --changed/partial runs, whose counts are not
    comparable), so every row here shares one workload key."""
    m: Dict[str, float] = {}
    for k in ("ok", "findings", "suppressed", "waivers_inline",
              "waivers_baseline", "wall_s"):
        _put(m, k, rep.get(k))
    for name, n in sorted((rep.get("checkers") or {}).items()):
        _put(m, f"raw_{name}", n)
    return {
        "kind": "analysis",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": "analysis_full",
        "device": None,
        "numerics_rev": None,
        "config_fingerprint": None,
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _chaos_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    m: Dict[str, float] = {}
    _put(m, "ok", rep.get("ok"))
    invs = rep.get("invariants") or {}
    _put(m, "invariant_fails",
         sum(1 for v in invs.values()
             if isinstance(v, dict) and not v.get("ok")))
    for cls, v in sorted((rep.get("mttr_s") or {}).items()):
        _put(m, f"mttr_{cls}", v)
    # Storage fault-domain accounting (the report's ``io`` section):
    # write/error/fault counters and budget/ladder gauges per storm.
    for name, v in sorted((rep.get("io") or {}).items()):
        _put(m, name.replace("tsspark_", ""), v)
    return {
        "kind": "chaos",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": f"storm_{rep.get('profile')}",
        "device": rep.get("device"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _eval_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    m: Dict[str, float] = {}
    for name, c in sorted((rep.get("configs") or {}).items()):
        if not isinstance(c, dict):
            continue
        for k in ("smape_holdout_cpu", "smape_holdout_tpu",
                  "delta_holdout_max_abs", "fit_seconds_tpu"):
            _put(m, f"{name}.{k}", c.get(k))
        dist = c.get("delta_holdout_dist") or {}
        _put(m, f"{name}.delta_holdout_p50", dist.get("p50"))
    return {
        "kind": "eval",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": f"parity_scale{rep.get('scale')}",
        "device": rep.get("platform"),
        "numerics_rev": rep.get("numerics_rev"),
        "config_fingerprint": rep.get("config_fingerprint"),
        "git_rev": rep.get("git_rev"),
        "metrics": m,
    }


def _ledger_row(rep: Dict[str, Any]) -> Dict[str, Any]:
    m: Dict[str, float] = {}
    _put(m, "wall_s", rep.get("wall_s"))
    _put(m, "n_spans", len(rep.get("spans") or ()))
    _put(m, "n_processes", len(rep.get("processes") or ()))
    _put(m, "orphan_spans", len(rep.get("orphan_spans") or ()))
    for cls, v in sorted((rep.get("mttr_s") or {}).items()):
        _put(m, f"mttr_{cls}", v)
    red = (rep.get("red") or {}).get("serve.request") or {}
    _put(m, "serve_request_p99_ms", red.get("p99_ms"))
    return {
        "kind": "ledger",
        "trace_id": rep.get("trace_id"),
        "unix": rep.get("unix"),
        "workload": None,
        "device": None,
        "numerics_rev": None,
        "config_fingerprint": None,
        "git_rev": None,
        "metrics": m,
    }


def classify(rep: Dict[str, Any]) -> Optional[str]:
    """Artifact family of a parsed report dict; None when it is not an
    ingestible run artifact (e.g. a REGRESSION verdict — verdicts must
    never feed back into the baselines that produced them)."""
    kind = rep.get("kind")
    if kind == "serve-loadgen":
        # Plane-bearing loadgen reports (bench --serveplane) are their
        # own family: different experiment, different baselines.
        return "serveplane" if rep.get("plane") else "serve"
    if kind == "calibration-eval":
        return "calibration"
    if kind == "scale-ladder":
        return "scale"
    if kind == "freshness-bench":
        return "freshness"
    if kind == "alerts-bench":
        return "alerts"
    if kind == "analysis-gate":
        return "analysis"
    if kind == "chaos-storm":
        return "chaos"
    if kind == "run-ledger":
        return "ledger"
    if kind == "eval-parity" or "configs" in rep:
        return "eval"
    if kind == "regression-verdict":
        return None
    if "metric" in rep and "extra" in rep:
        return "bench"
    if "cmd" in rep and "parsed" in rep:
        return "bench"
    return None


_ROW_BUILDERS = {
    "bench": _bench_row,
    "serve": _serve_row,
    "serveplane": _serveplane_row,
    "calibration": _calibration_row,
    "scale": _scale_row,
    "freshness": _freshness_row,
    "alerts": _alerts_row,
    "analysis": _analysis_row,
    "chaos": _chaos_row,
    "eval": _eval_row,
    "ledger": _ledger_row,
}


def row_from_report(rep: Dict[str, Any],
                    source: Optional[str] = None) -> Optional[Dict]:
    """Normalize one parsed artifact into a history row (None when the
    dict is no known artifact family)."""
    kind = classify(rep) if isinstance(rep, dict) else None
    if kind is None:
        return None
    row = _ROW_BUILDERS[kind](rep)
    if row["trace_id"]:
        row_id = f"{kind}:{row['trace_id']}"
    else:
        # Artifacts that predate trace stamping carry no trace id:
        # content-hash identity keeps re-ingesting the same committed
        # file a no-op.
        digest = hashlib.sha1(
            json.dumps(rep, sort_keys=True, default=str).encode()
        ).hexdigest()[:12]
        row_id = f"{kind}:sha-{digest}"
    row["row_id"] = row_id
    row["source"] = os.path.basename(source) if source else None
    row["device_class"] = device_class(row.get("device"))
    row["ingested_unix"] = round(time.time(), 3)
    return row


# ---------------------------------------------------------------------------
# the index: read / ingest / backfill
# ---------------------------------------------------------------------------


def read_history(path: str = HISTORY_FILE) -> List[Dict[str, Any]]:
    """All rows of the index, unique by ``row_id`` in first-ingest
    order — a LATER line with the same id amends the earlier one (how
    the sentinel retrofits its ``breached`` flag onto a row that was
    backfilled before being judged).  Torn final line and non-row junk
    tolerated — the append contract allows a writer killed mid-write to
    tear its own last line."""
    out: Dict[str, Dict[str, Any]] = {}
    for r in read_records(path):
        if isinstance(r, dict) and r.get("row_id"):
            # Re-assignment keeps the first occurrence's position.
            out[r["row_id"]] = r
    return list(out.values())


def append_row(row: Dict[str, Any],
               history_path: str = HISTORY_FILE,
               amend: bool = False) -> bool:
    """Append one prebuilt row; False when its ``row_id`` is already
    indexed (the idempotency that lets entrypoints self-ingest
    unconditionally).  ``amend`` appends anyway when the stored row's
    ``breached`` flag differs — the reader's last-wins dedupe makes the
    flagged version authoritative."""
    prev = next((r for r in read_history(history_path)
                 if r.get("row_id") == row["row_id"]), None)
    if prev is not None and not (
        amend and prev.get("breached") != row.get("breached")
    ):
        return False
    append_line(history_path, json.dumps(row))
    return True


def ingest(rep: Dict[str, Any], history_path: str = HISTORY_FILE,
           source: Optional[str] = None
           ) -> Tuple[Optional[Dict], bool]:
    """Normalize + append one report; returns ``(row, appended)``.
    Idempotent: a row whose ``row_id`` is already indexed is skipped."""
    row = row_from_report(rep, source=source)
    if row is None:
        return None, False
    return row, append_row(row, history_path)


def ingest_path(path: str, history_path: str = HISTORY_FILE
                ) -> Tuple[Optional[Dict], bool]:
    """Ingest one artifact file (unparseable/unknown files skipped)."""
    try:
        with open(path) as fh:
            rep = json.load(fh)
    except (OSError, ValueError):
        return None, False
    if not isinstance(rep, dict):
        return None, False
    return ingest(rep, history_path, source=path)


_ROUND_RE = re.compile(r"_r(\d+)")


def _backfill_sort_key(path: str, rep: Dict[str, Any]):
    """Committed round artifacts (``*_r01`` …) order by round number;
    unix-stamped artifacts by their timestamp; mtime as the tiebreak —
    so the backfilled trajectory reads in run order, not glob order."""
    mround = _ROUND_RE.search(os.path.basename(path))
    unix = rep.get("unix")
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    return (
        int(mround.group(1)) if mround else 10 ** 9,
        unix if isinstance(unix, (int, float)) else mtime,
        os.path.basename(path),
    )


def backfill(root: str = ".",
             history_path: Optional[str] = None) -> Dict[str, Any]:
    """Ingest every artifact of a known family under ``root`` (flat
    glob — artifacts live next to the index).  Returns a summary."""
    history_path = history_path or os.path.join(root, HISTORY_FILE)
    candidates: List[Tuple[Tuple, str, Dict]] = []
    for fam in FAMILIES:
        for path in glob.glob(os.path.join(root, f"{fam}*.json")):
            try:
                with open(path) as fh:
                    rep = json.load(fh)
            except (OSError, ValueError):
                continue
            if isinstance(rep, dict):
                candidates.append((_backfill_sort_key(path, rep),
                                   path, rep))
    candidates.sort(key=lambda c: c[0])
    ingested, skipped = [], []
    for _key, path, rep in candidates:
        row, appended = ingest(rep, history_path, source=path)
        if row is None:
            continue
        (ingested if appended else skipped).append(
            os.path.basename(path)
        )
    return {"history": history_path, "ingested": ingested,
            "skipped": skipped, "rows": len(read_history(history_path))}


# ---------------------------------------------------------------------------
# trajectory rendering
# ---------------------------------------------------------------------------

#: Headline metrics per family, in display order (missing ones elided).
_TRAJECTORY_COLUMNS = {
    "bench": ("series_per_s", "first_flush_s", "datagen_s",
              "datagen_share", "smape_insample_mean", "series_done",
              "complete", "rc"),
    "serve": ("requests_per_s", "p50_ms", "p99_ms", "shed_rate",
              "hit_rate", "agg_requests_per_s", "failovers",
              "flip_p99_ms"),
    "serveplane": ("plane_hit_rate", "plane_read_p99_ms",
                   "plane_requests_per_s", "dispatch_requests_per_s",
                   "plane_publish_s", "ttfr_cold_s",
                   "ttfr_aot_warm_s"),
    "calibration": ("coverage_abs_gap", "mode_advi",
                    "advi_series_per_s", "qread_p99_ms", "qdiv_max",
                    "rhat_max", "hmc_divergences"),
    "scale": ("series_per_s", "agg_requests_per_s",
              "time_to_first_request_s", "flip_p99_ms",
              "rss_mb_per_replica", "rss_reduction_x", "complete"),
    "freshness": ("freshness_p50_s", "freshness_p95_s",
                  "freshness_vs_cold_frac", "cycle_overhead_frac",
                  "spec_hit_rate", "wrong_version", "complete"),
    "alerts": ("alerts_p50_s", "alerts_p95_s", "delivered_frac",
               "fired", "suppressed", "deduped", "breaker_opens",
               "complete"),
    "analysis": ("ok", "findings", "suppressed", "waivers_inline",
                 "waivers_baseline", "wall_s"),
    "chaos": ("ok", "invariant_fails"),
    "eval": ("config3_m5.smape_holdout_cpu",
             "config3_m5.delta_holdout_p50",
             "config2_m4_hourly.delta_holdout_p50"),
    "ledger": ("wall_s", "n_spans", "n_processes", "orphan_spans"),
}


def _fmt_row(row: Dict[str, Any], columns: Sequence[str]) -> str:
    name = row.get("source") or row["row_id"]
    bits = [f"{name:<28}"]
    bits.append(f"dev={row.get('device_class') or '?':<4}")
    if row.get("numerics_rev") is not None:
        bits.append(f"rev={row['numerics_rev']}")
    if row.get("git_rev"):
        bits.append(f"git={row['git_rev']}")
    metrics = row.get("metrics") or {}
    shown = 0
    for col in columns:
        if col in metrics:
            bits.append(f"{col}={metrics[col]}")
            shown += 1
    if not shown and row["kind"] == "chaos":
        # mttr columns are per-class; show the worst one.
        mttrs = {k: v for k, v in metrics.items()
                 if k.startswith("mttr_")}
        if mttrs:
            worst = max(mttrs, key=lambda k: mttrs[k])
            bits.append(f"{worst}={mttrs[worst]}")
    if not metrics:
        bits.append("(no parsed summary)")
    return "  " + " ".join(bits)


def trajectory(rows: Sequence[Dict[str, Any]]) -> List[str]:
    """Human-readable trajectory: one line per row, grouped by family
    in ingest order (the roadmap's 'bench trajectory' block)."""
    lines: List[str] = []
    for kind in ("bench", "eval", "serve", "serveplane", "calibration",
                 "scale", "freshness", "alerts", "analysis", "chaos",
                 "ledger"):
        group = [r for r in rows if r.get("kind") == kind]
        if not group:
            continue
        lines.append(f"{kind} trajectory ({len(group)} runs):")
        for row in group:
            extra = _TRAJECTORY_COLUMNS.get(kind, ())
            lines.append(_fmt_row(row, extra))
        # Per-family chaos rows also carry per-class MTTR columns; the
        # sentinel (obs.regress) budgets them individually.
    return lines
