"""``python -m tsspark_tpu_torch.alerts --bench RUNG``: the land→alert
freshness stream (the port's copy of the JAX package's
``alerts/bench.py``).

A churn lander feeds synthetic deltas into the plane while an
:class:`~tsspark_tpu_torch.alerts.stream.AlertStream` scores and delivers
against the rung's cold-published version; the measurement is the
land→sink-ack latency per delta (the ``alerts.freshness`` span
stream), summarized as p50/p95 and judged by the regression sentinel
under ``[tool.tsspark.slo.alerts]``.  The cold fit is only the
denominator and is amortized exactly like the freshness bench
(``--reuse-cold`` / internal coldbase).  The fits, publishes and the
scoring engine run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from tsspark_tpu_torch.alerts.sink import JsonlSink
from tsspark_tpu_torch.alerts.stream import AlertStream
from tsspark_tpu_torch.io import atomic_write
from tsspark_tpu_torch.obs import context as obs

#: Default churn fraction / delta count of the alert stream bench.
DEFAULT_ALERTS_CHURN = 0.05
DEFAULT_ALERTS_DELTAS = 6


def _write_alerts_report(rep: Dict) -> str:
    path = f"BENCH_alerts_{rep['rung']}_{int(rep['unix'])}.json"
    atomic_write(path, lambda fh: json.dump(rep, fh, indent=1),
                 mode="w")
    return path


def _alerts_report(rung, churn: float, n_deltas: int, gap: float,
                   cold: Dict, stream: AlertStream, seq0: int,
                   totals: Dict, wall_s: float, cfg,
                   device=None) -> Dict:
    from tsspark_tpu_torch.bench_scale import device_name
    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs.history import git_rev
    from tsspark_tpu_torch.utils import checkpoint as ckpt

    fresh = stream.freshness_summary()
    cold_wall = float(cold["fit_s"]) + float(cold["publish_s"])
    delivered_seqs = max(0, stream.delivered_seq() - int(seq0))
    last = stream.record_ok(stream.scored_seq()) \
        if stream.scored_seq() else None
    return {
        "kind": "alerts-bench",
        "unix": round(time.time(), 3),
        "trace_id": obs.trace_id(),
        "numerics_rev": NUMERICS_REV,
        "git_rev": git_rev(),
        "config_fingerprint": ckpt.config_fingerprint(cfg),
        "device": device_name(device),
        "rung": rung.name,
        "series": rung.series,
        "timesteps": rung.timesteps,
        # The scoring mode the stream actually ran in (interval when
        # the version publishes a quantile plane, zscore fallback
        # otherwise) — the workload key includes it, so the sentinel
        # never compares interval runs against fallback runs.
        "mode": (last or {}).get("mode", "unknown"),
        "degraded": bool((last or {}).get("degraded", True)),
        "churn": churn,
        "deltas": int(n_deltas),
        "interval_s": round(gap, 3),
        "complete": bool(delivered_seqs >= int(n_deltas)
                         and fresh["n"] >= int(n_deltas)),
        "cold_fit_s": round(float(cold["fit_s"]), 3),
        "cold_publish_s": round(float(cold["publish_s"]), 3),
        "cold_wall_s": round(cold_wall, 3),
        "cold_reused": bool(cold.get("reused")),
        "alerts_n": fresh["n"],
        "alerts_p50_s": fresh["p50_s"],
        "alerts_p95_s": fresh["p95_s"],
        "alerts_mean_s": fresh["mean_s"],
        "alerts_max_s": fresh["max_s"],
        "fired": int(totals["fired"]),
        "suppressed": int(totals["suppressed"]),
        "delivered": int(totals["delivered"]),
        "deduped": int(totals["deduped"]),
        "queued": int(totals["queued"]),
        "delivered_frac": (round(delivered_seqs / int(n_deltas), 4)
                           if n_deltas else None),
        "breaker_opens": int(stream.breaker.snapshot()["opens"]),
        "wall_s": round(wall_s, 3),
    }


def run_alerts_bench(rung="smoke", *,
                     churn: float = DEFAULT_ALERTS_CHURN,
                     n_deltas: int = DEFAULT_ALERTS_DELTAS,
                     interval_s: Optional[float] = None,
                     reuse_cold: Optional[str] = None,
                     scratch_root: Optional[str] = None,
                     sentinel: Optional[bool] = None,
                     device=None, mesh=None) -> List[Dict]:
    """Land a churn stream and measure land→alert-ack freshness through
    a live AlertStream + JSONL sink.  One ``BENCH_alerts_*`` artifact (in
    the working directory), ingested into RUNHISTORY as the ``alerts``
    family.  ``device`` / ``mesh``: the cold base's fit and publish and
    the scoring engine's (None: the card, on the default mesh)."""
    import tempfile

    from tsspark_tpu_torch import bench_scale, refit
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.serve.cache import ForecastCache
    from tsspark_tpu_torch.serve.engine import PredictionEngine

    if isinstance(rung, str):
        rung = bench_scale.RUNGS[rung]
    cfg = bench_scale._config()
    solver = SolverConfig(max_iters=rung.max_iters)
    scratch = os.path.join(
        scratch_root or tempfile.gettempdir(),
        f"tsalerts_{rung.name}_{rung.series}x{rung.timesteps}"
        f"_{plane.dataset_fingerprint()}",
    )
    os.makedirs(scratch, exist_ok=True)
    base_dir = reuse_cold or os.path.join(scratch, "coldbase")
    os.makedirs(base_dir, exist_ok=True)
    prev_run = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    reports: List[Dict] = []
    try:
        spec = plane.DatasetSpec(
            generator="demo_weekly", n_series=rung.series,
            n_timesteps=rung.timesteps, seed=2,
        )
        dset_dir = plane.ensure(spec, root=os.path.join(base_dir,
                                                        "plane"))
        ids = plane.series_ids(spec)
        run_dir = os.path.join(scratch, f"run_{int(time.time())}")
        refit._sweep_stale_runs(scratch, keep=run_dir)
        registry, cold, _catchup = refit.prepare_cold_registry(
            rung, cfg, solver, run_dir, dset_dir, ids,
            reuse_cold=base_dir, device=device, mesh=mesh,
        )
        if registry is None:
            print("[alerts] cold fit incomplete; aborting",
                  file=sys.stderr)
            return [{"complete": False, "stage": "cold-fit"}]
        cold_wall = float(cold["fit_s"]) + float(cold["publish_s"])
        gap = interval_s if interval_s is not None else \
            min(5.0, max(0.2, 0.05 * cold_wall))

        engine = PredictionEngine(registry, cache=ForecastCache(),
                                  device=device)
        stream = AlertStream(
            os.path.join(run_dir, "alerts"), dset_dir, engine,
            JsonlSink(os.path.join(run_dir, "alerts_sink.jsonl")),
            horizon=1,
        )
        seq0 = plane.delta_seq(dset_dir)
        target = seq0 + int(n_deltas)
        rng = np.random.default_rng([13, seq0])
        k = max(1, int(round(churn * rung.series)))

        def _land_stream():
            for _i in range(int(n_deltas)):
                rows = np.sort(rng.choice(rung.series, size=k,
                                          replace=False)).astype(
                    np.int64
                )
                try:
                    plane.land_synthetic_delta(dset_dir, churn,
                                               rows=rows)
                except Exception as e:
                    print(f"[alerts] land failed: {e!r}",
                          file=sys.stderr)
                    return
                time.sleep(gap)

        lander = threading.Thread(target=_land_stream,
                                  name="alerts-lander", daemon=True)
        totals = {"fired": 0, "suppressed": 0, "delivered": 0,
                  "deduped": 0, "queued": 0}
        t0 = time.time()
        lander.start()
        deadline = t0 + max(60.0, n_deltas * gap + 20 * cold_wall)
        while time.time() < deadline:
            res = stream.poll_once()
            totals["delivered"] += res["delivered"]
            totals["deduped"] += res["deduped"]
            totals["queued"] = res["queued"]
            if stream.delivered_seq() >= target:
                break
            time.sleep(0.05)
        lander.join(timeout=10.0)
        for s in range(seq0 + 1, stream.scored_seq() + 1):
            rec = stream.record_ok(s)
            if rec is not None:
                totals["fired"] += int(rec["n_fired"])
                totals["suppressed"] += int(rec["n_suppressed"])
        rep = _alerts_report(rung, churn, int(n_deltas), gap, cold,
                             stream, seq0, totals,
                             time.time() - t0, cfg, device=device)
        path = _write_alerts_report(rep)
        rep["path"] = path
        print(json.dumps({
            "rung": rung.name, "mode": rep["mode"], "churn": churn,
            "deltas": n_deltas,
            "alerts_p50_s": rep["alerts_p50_s"],
            "alerts_p95_s": rep["alerts_p95_s"],
            "fired": rep["fired"], "suppressed": rep["suppressed"],
            "delivered_frac": rep["delivered_frac"],
            "report": path,
        }), flush=True)
        if sentinel is None:
            sentinel_on = (os.environ.get("TSSPARK_SENTINEL", "1")
                           != "0")
        else:
            sentinel_on = sentinel
        if sentinel_on:
            try:
                from tsspark_tpu_torch.obs import regress

                verdict = regress.sentinel_report(rep, source=path)
                if verdict is not None:
                    print(f"[alerts] {regress.summarize(verdict)}",
                          file=sys.stderr)
                    rep["sentinel_ok"] = verdict["ok"]
            except Exception as e:  # never mask the report
                print(f"[alerts] sentinel skipped: {e!r}",
                      file=sys.stderr)
        reports.append(rep)
        return reports
    finally:
        obs.end_run(prev_run)
