"""Regression sentinel: rolling robust SLOs over the run history (the
port's copy of the JAX package's ``obs/regress.py``; same budgets, same
verdicts on the same rows).

An artifact-producing entrypoint (``python -m tsspark_tpu_torch.serve
--loadgen``) ends by handing its report here: the report is ingested into the history index
(``obs.history``), compared against a rolling robust baseline —
median/MAD over the last K *comparable* rows: same artifact kind,
device class, NUMERICS_REV, and workload key — under per-metric budgets
declared in ``pyproject.toml [tool.tsspark.slo]``, and the verdict is
persisted as ``REGRESSION_<unix>.json``.  A breach makes the
entrypoint exit nonzero, so a perf or MTTR regression fails the run
that introduced it instead of waiting for a human to diff JSON.

Budget semantics, per metric (``direction`` = "higher" | "lower"):

* the *budget bound* comes from ``max_drop_frac``/``max_drop_abs``
  (higher-is-better) or ``max_rise_frac``/``max_rise_abs`` (lower-is-
  better) off the baseline median, plus optional ``slack_abs`` so tiny
  absolute values (a 0.2 s MTTR) don't trip fractional budgets on
  noise;
* the *noise bound* is ``mad_k`` scaled MADs from the median
  (1.4826·MAD ≈ one robust sigma);
* a value breaches only when it is worse than BOTH — robust to a noisy
  baseline, yet an identical re-run is always green and a 3× collapse
  is always red.

Device-free: imports neither torch nor the kernels (same contract as
``obs.history``).
"""

from __future__ import annotations

import fnmatch
import json
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

from tsspark_tpu_torch.obs import history
from tsspark_tpu_torch.utils.atomic import atomic_write

#: MAD -> robust sigma scale (normal consistency constant).
_MAD_SIGMA = 1.4826

#: Fallbacks when pyproject has no ``[tool.tsspark.slo]`` (kept in sync
#: with the committed table there — pyproject is the reviewed source of
#: truth; these only cover running outside a checkout).
DEFAULT_SLO: Dict[str, Any] = {
    "window": 8,
    "min_history": 1,
    "mad_k": 4.0,
    "budgets": {
        "bench": {
            "series_per_s": {"direction": "higher",
                             "max_drop_frac": 0.5},
            "resident_series_per_s": {"direction": "higher",
                                      "max_drop_frac": 0.5},
            "first_flush_s": {"direction": "lower",
                              "max_rise_frac": 1.5, "slack_abs": 5.0},
            "compile_misses": {"direction": "lower",
                               "max_rise_abs": 8},
            "datagen_s": {"direction": "lower", "max_rise_frac": 1.0,
                          "slack_abs": 10.0},
            "datagen_share": {"direction": "lower",
                              "max_rise_abs": 0.10,
                              "slack_abs": 0.02},
            "smape_insample_mean": {"direction": "lower",
                                    "max_rise_frac": 0.05},
            "delta_series_per_s": {"direction": "higher",
                                   "max_drop_frac": 0.5},
            "delta_wall_frac": {"direction": "lower",
                                "max_rise_frac": 0.5,
                                "slack_abs": 0.05},
        },
        "serve": {
            "p50_ms": {"direction": "lower", "max_rise_frac": 1.0,
                       "slack_abs": 2.0},
            "p99_ms": {"direction": "lower", "max_rise_frac": 1.0,
                       "slack_abs": 5.0},
            "requests_per_s": {"direction": "higher",
                               "max_drop_frac": 0.5},
            "shed_rate": {"direction": "lower", "max_rise_abs": 0.05},
            "hit_rate": {"direction": "higher", "max_drop_abs": 0.15},
            "agg_requests_per_s": {"direction": "higher",
                                   "max_drop_frac": 0.5},
            "failovers": {"direction": "lower", "max_rise_abs": 8},
            "flip_p99_ms": {"direction": "lower", "max_rise_frac": 1.0,
                            "slack_abs": 50.0},
            "plane_hit_rate": {"direction": "higher",
                               "max_drop_abs": 0.15},
            "plane_read_p99_ms": {"direction": "lower",
                                  "max_rise_frac": 1.0,
                                  "slack_abs": 2.0},
        },
        "serveplane": {
            "plane_hit_rate": {"direction": "higher",
                               "max_drop_abs": 0.15},
            "plane_read_p99_ms": {"direction": "lower",
                                  "max_rise_frac": 1.0,
                                  "slack_abs": 2.0},
            "plane_requests_per_s": {"direction": "higher",
                                     "max_drop_frac": 0.5},
            "ttfr_aot_warm_s": {"direction": "lower",
                                "max_rise_frac": 1.0,
                                "slack_abs": 5.0},
        },
        "calibration": {
            "coverage_abs_gap": {"direction": "lower",
                                 "max_rise_abs": 0.10,
                                 "slack_abs": 0.05},
            "advi_series_per_s": {"direction": "higher",
                                  "max_drop_frac": 0.5},
            "qread_p99_ms": {"direction": "lower",
                             "max_rise_frac": 1.0, "slack_abs": 2.0},
            "qdiv_max": {"direction": "lower", "max_rise_frac": 1.0,
                         "slack_abs": 1.0},
        },
        "scale": {
            "rss_mb_per_replica": {"direction": "lower",
                                   "max_rise_frac": 0.5,
                                   "slack_abs": 128.0},
            "agg_requests_per_s": {"direction": "higher",
                                   "max_drop_frac": 0.5},
            "time_to_first_request_s": {"direction": "lower",
                                        "max_rise_frac": 1.0,
                                        "slack_abs": 5.0},
            "flip_p99_ms": {"direction": "lower",
                            "max_rise_frac": 1.0,
                            "slack_abs": 50.0},
            "series_per_s": {"direction": "higher",
                             "max_drop_frac": 0.5},
        },
        "freshness": {
            "freshness_p95_s": {"direction": "lower",
                                "max_rise_frac": 1.0,
                                "slack_abs": 2.0},
            "cycle_overhead_frac": {"direction": "lower",
                                    "max_rise_abs": 0.25,
                                    "slack_abs": 0.05},
            "spec_hit_rate": {"direction": "higher",
                              "max_drop_abs": 0.5},
        },
        "alerts": {
            "alerts_p95_s": {"direction": "lower",
                             "max_rise_frac": 1.0,
                             "slack_abs": 2.0},
            "delivered_frac": {"direction": "higher",
                               "max_drop_abs": 0.25},
        },
        "chaos": {
            "ok": {"direction": "higher", "max_drop_abs": 0.5},
            "mttr_*": {"direction": "lower", "max_rise_frac": 1.0,
                       "slack_abs": 2.0},
        },
        "eval": {
            "*.delta_holdout_p50": {"direction": "lower",
                                    "max_rise_abs": 0.05},
            "*.smape_holdout_tpu": {"direction": "lower",
                                    "max_rise_frac": 0.05,
                                    "slack_abs": 0.2},
        },
        "analysis": {
            "findings": {"direction": "lower", "max_rise_abs": 0.0},
            "wall_s": {"direction": "lower", "max_rise_frac": 1.0,
                       "slack_abs": 30.0},
        },
    },
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def load_slo(root: Optional[str] = None) -> Dict[str, Any]:
    """SLO config: ``[tool.tsspark.slo]`` from ``root``'s (default: the
    checkout's, else the cwd's) pyproject, merged over the defaults.
    Per-kind tables merge per metric — overriding one budget does not
    drop the rest."""
    slo = {
        "window": DEFAULT_SLO["window"],
        "min_history": DEFAULT_SLO["min_history"],
        "mad_k": DEFAULT_SLO["mad_k"],
        "budgets": {k: dict(v)
                    for k, v in DEFAULT_SLO["budgets"].items()},
    }
    roots = [root] if root else [_repo_root(), os.getcwd()]
    raw: Dict[str, Any] = {}
    for r in roots:
        path = os.path.join(r, "pyproject.toml")
        if not os.path.exists(path):
            continue
        try:
            try:
                import tomllib as toml_mod  # Python >= 3.11
            except ImportError:
                import tomli as toml_mod
            with open(path, "rb") as fh:
                raw = (toml_mod.load(fh).get("tool", {})
                       .get("tsspark", {}).get("slo", {}))
        except Exception:
            raw = {}
        if raw:
            break
    for key in ("window", "min_history", "mad_k"):
        if isinstance(raw.get(key), (int, float)):
            slo[key] = raw[key]
    for kind, table in raw.items():
        if kind in ("window", "min_history", "mad_k"):
            continue
        if isinstance(table, dict):
            merged = dict(slo["budgets"].get(kind, {}))
            for metric, budget in table.items():
                if isinstance(budget, dict):
                    merged[metric] = budget
            slo["budgets"][kind] = merged
    return slo


# ---------------------------------------------------------------------------
# baseline selection + evaluation
# ---------------------------------------------------------------------------


def comparable(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Two rows may share a baseline: same kind, and device class /
    NUMERICS_REV / workload equal wherever both sides recorded them
    (artifacts that predate those fields carry None — a wildcard, so
    the backfilled past still seeds baselines)."""
    if a.get("kind") != b.get("kind"):
        return False
    for key in ("device_class", "numerics_rev", "workload"):
        va, vb = a.get(key), b.get(key)
        if va is not None and vb is not None and va != vb:
            return False
    return True


def _bound(direction: str, med: float, sigma: float,
           budget: Dict[str, Any], mad_k: float) -> float:
    """The effective threshold: worse than BOTH the declared budget and
    the noise band.  Multiple declared budget forms combine loosely
    (the sentinel must be conservative — it exits runs nonzero)."""
    budget_bounds: List[float] = []
    if direction == "higher":
        if "max_drop_frac" in budget:
            budget_bounds.append(med * (1.0 - budget["max_drop_frac"]))
        if "max_drop_abs" in budget:
            budget_bounds.append(med - budget["max_drop_abs"])
        if not budget_bounds:
            budget_bounds.append(med)
        b = min(budget_bounds) - budget.get("slack_abs", 0.0)
        return min(b, med - mad_k * sigma)
    if "max_rise_frac" in budget:
        budget_bounds.append(med * (1.0 + budget["max_rise_frac"]))
    if "max_rise_abs" in budget:
        budget_bounds.append(med + budget["max_rise_abs"])
    if not budget_bounds:
        budget_bounds.append(med)
    b = max(budget_bounds) + budget.get("slack_abs", 0.0)
    return max(b, med + mad_k * sigma)


def evaluate(row: Dict[str, Any],
             history_rows: Sequence[Dict[str, Any]],
             slo: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Judge one history row against its rolling baseline; returns the
    verdict dict (``write_verdict`` for the file form)."""
    slo = slo or load_slo()
    window = int(slo["window"])
    min_history = int(slo["min_history"])
    # Rows that themselves breached are no baseline: a persistent
    # regression re-ingested run after run would otherwise drag the
    # median down until the unfixed regression judges green.
    base = [r for r in history_rows
            if r.get("row_id") != row.get("row_id")
            and not r.get("breached")
            and comparable(r, row)][-window:]
    budgets: Dict[str, Dict] = slo["budgets"].get(row.get("kind"), {})
    metrics: Dict[str, Any] = row.get("metrics") or {}
    checks: List[Dict[str, Any]] = []
    breaches: List[str] = []
    skipped: List[str] = []
    for pattern in sorted(budgets):
        budget = budgets[pattern]
        if any(c in pattern for c in "*?["):
            names = sorted(fnmatch.filter(metrics, pattern))
        else:
            names = [pattern]
        for name in names:
            value = metrics.get(name)
            series = [r["metrics"][name] for r in base
                      if isinstance((r.get("metrics") or {}).get(name),
                                    (int, float))]
            if not isinstance(value, (int, float)):
                skipped.append(name)
                continue
            if len(series) < min_history:
                skipped.append(name)
                continue
            med = float(statistics.median(series))
            mad = float(statistics.median(
                abs(x - med) for x in series
            ))
            sigma = _MAD_SIGMA * mad
            direction = budget.get("direction", "higher")
            mad_k = float(budget.get("mad_k", slo["mad_k"]))
            bound = _bound(direction, med, sigma, budget, mad_k)
            ok = (value >= bound if direction == "higher"
                  else value <= bound)
            checks.append({
                "metric": name, "value": value,
                "median": round(med, 6), "mad": round(mad, 6),
                "n_baseline": len(series),
                "direction": direction,
                "bound": round(bound, 6), "ok": ok,
            })
            if not ok:
                breaches.append(name)
    return {
        "kind": "regression-verdict",
        "unix": round(time.time(), 3),
        "trace_id": row.get("trace_id"),
        "row_id": row.get("row_id"),
        "row_kind": row.get("kind"),
        "source": row.get("source"),
        "workload": row.get("workload"),
        "git_rev": row.get("git_rev") or history.git_rev(),
        "baseline": {
            "n": len(base), "window": window,
            "row_ids": [r.get("row_id") for r in base],
        },
        "checks": checks,
        "breaches": breaches,
        "skipped": sorted(set(skipped)),
        "ok": not breaches,
    }


def write_verdict(verdict: Dict[str, Any],
                  path: Optional[str] = None) -> str:
    """Persist a verdict as ``REGRESSION_<unix>.json`` (atomic, like
    every other report artifact)."""
    out = path or f"REGRESSION_{int(verdict.get('unix', time.time()))}.json"
    atomic_write(out, lambda fh: json.dump(verdict, fh, indent=1),
                 mode="w")
    return out


# ---------------------------------------------------------------------------
# the entrypoint post-step
# ---------------------------------------------------------------------------


def sentinel_report(rep: Dict[str, Any],
                    history_path: str = history.HISTORY_FILE,
                    source: Optional[str] = None,
                    out: Optional[str] = None,
                    slo: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
    """The self-gate every artifact-producing entrypoint calls: ingest
    ``rep`` into the history (idempotent), judge it against the rows
    that PRECEDED it, write the ``REGRESSION_*.json`` verdict.  Returns
    the verdict (with ``path`` filled in), or None when ``rep`` is not
    an ingestible artifact.  Never raises for a malformed report — the
    caller decides what a breach does to its exit code."""
    before = history.read_history(history_path)
    row = history.row_from_report(rep, source=source)
    if row is None:
        return None
    verdict = evaluate(row, before, slo=slo)
    if not verdict["ok"]:
        # The verdict travels WITH the row: ``evaluate`` skips breached
        # rows when baselining, so a regressed run never normalizes
        # the very baseline that would have to catch it.  ``amend``
        # covers the row having reached the index unjudged first (a
        # backfill, or an entrypoint run with the sentinel opted out).
        row["breached"] = verdict["breaches"]
    history.append_row(row, history_path, amend=not verdict["ok"])
    verdict["history"] = history_path
    verdict["path"] = write_verdict(verdict, out)
    return verdict


def summarize(verdict: Dict[str, Any]) -> str:
    """One operator-facing line per verdict (entrypoints print it)."""
    if verdict["ok"]:
        judged = [c["metric"] for c in verdict["checks"]]
        basis = verdict["baseline"]["n"]
        return (f"sentinel OK: {len(judged)} metric(s) within budget "
                f"vs {basis}-run baseline -> {verdict.get('path')}")
    bits = []
    for c in verdict["checks"]:
        if not c["ok"]:
            cmp_ = "<" if c["direction"] == "higher" else ">"
            bits.append(f"{c['metric']}={c['value']} {cmp_} "
                        f"bound {c['bound']} (median {c['median']})")
    return ("sentinel REGRESSION: " + "; ".join(bits)
            + f" -> {verdict.get('path')}")
