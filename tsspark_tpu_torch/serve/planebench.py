"""The forecast plane's economics, measured (the port's copy of the JAX
package's ``serve/planebench.py``, which its ``bench.py --serveplane``
drives; here ``run_serveplane_bench`` is called as a function).

One run, three questions:

1. **Hot-read throughput** — the same deterministic hot mix (point
   forecasts at the pool's hot horizons, caches DISABLED so every
   request pays its real path) replayed through two engines over the
   same registry: one serving from the materialized plane, one forced
   onto the compute path.  The ratio is the plane's whole claim.
2. **Zero-dispatch read latency** — per-request walls on the plane
   engine; p99 feeds the ``plane_read_p99_ms`` SLO budget.
3. **Replica cold start** — TTFR of a 1-replica pool without the
   kernel bank vs one armed with it (``serve/aotbank.py``).  The port
   has no JIT cache to start empty: its programs are the one kernel
   library, built by ``nvcc``.  So the cold arm is a replica without the
   bank on an install whose library is already built (it loads that
   build), and the report says so (``plane.ttfr.cold_arm``); the warm
   arm loads the library from the bank.

The report is a ``BENCH_serveplane_<unix>.json`` artifact (kind
``serve-loadgen`` plus a ``plane`` section) ingested into RUNHISTORY
under a ``serveplane_``-prefixed workload key and judged by the
regression sentinel against ``[tool.tsspark.slo.serve]``.  The fit,
both engines and the replicas run on the card unless ``args.device`` is
``"cpu"``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

HOT_HORIZONS = (7, 14, 28)

#: What the cold TTFR arm is in the port (no JIT cache to empty).
COLD_ARM = ("a replica without the kernel bank on an install whose "
            "kernel library is already built (it loads that build)")


def _percentiles(walls_s: Sequence[float]) -> Dict[str, Optional[float]]:
    if not walls_s:
        return {"p50": None, "p95": None, "p99": None}
    a = np.asarray(walls_s, np.float64) * 1e3
    return {k: round(float(np.percentile(a, q)), 3)
            for k, q in (("p50", 50), ("p95", 95), ("p99", 99))}


def _hot_mix(rng, snap, n: int) -> List[Dict]:
    """The deterministic hot-read mix: 1-8 Zipf-picked series per
    request, hot horizons only, num_samples=0 — exactly the traffic
    the plane exists for (sampled intervals stay on compute and are
    measured by the ordinary loadgen)."""
    n_series = len(snap.series_ids)
    w = 1.0 / (1.0 + np.arange(n_series))
    w = w / w.sum()
    reqs = []
    for _ in range(n):
        k = int(rng.integers(1, min(9, n_series + 1)))
        pick = rng.choice(n_series, size=k, replace=False, p=w)
        reqs.append({
            "series_ids": [snap.series_ids[i] for i in pick],
            "horizon": int(rng.choice(HOT_HORIZONS)),
        })
    return reqs


def _replay(engine, reqs: Sequence[Dict],
            record_walls: bool = False):
    """Replay ``reqs`` synchronously; returns (wall_s, per-request
    walls).  Synchronous on purpose: the throughput under test is the
    read path itself, not queue coalescing."""
    walls: List[float] = []
    t0 = time.perf_counter()
    for r in reqs:
        t1 = time.perf_counter()
        engine.forecast(r["series_ids"], r["horizon"], num_samples=0,
                        seed=0, deadline_in_s=None)
        if record_walls:
            walls.append(time.perf_counter() - t1)
    return time.perf_counter() - t0, walls


@contextlib.contextmanager
def _env(overrides: Dict[str, Optional[str]]):
    """Temporarily set/unset env vars (None = unset) — the TTFR pools
    read their cache contract from the environment they inherit."""
    old = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _ttfr(pool_dir: str, registry_root: str, sid, device=None) -> Dict:
    """Spawn a 1-replica pool and time its path to first service:
    ``spawn_s`` (start() wall: fork + imports + lease + socket),
    ``first_request_s`` (one request per hot horizon bucket — the
    whole first-contact shape ladder), and their sum ``ttfr_s`` (the
    scale bench's time_to_first_request_s analog)."""
    from tsspark_tpu_torch.serve.pool import ReplicaPool

    pool = ReplicaPool(pool_dir, registry_root, n_replicas=1,
                       device=device)
    t0 = time.perf_counter()
    pool.start()
    t_ready = time.perf_counter()
    try:
        resp = pool.submit_wave([
            {"id": f"ttfr-{h}", "series_ids": [sid], "horizon": int(h),
             "num_samples": 0, "seed": 0, "deadline_ms": 300_000.0}
            for h in HOT_HORIZONS
        ])
        t_done = time.perf_counter()
        ok = all(r.get("ok") for r in resp.values()) and \
            len(resp) == len(HOT_HORIZONS)
    finally:
        pool.stop()
    return {
        "ok": ok,
        "spawn_s": round(t_ready - t0, 3),
        "first_request_s": round(t_done - t_ready, 3),
        "ttfr_s": round(t_done - t0, 3),
    }


def run_serveplane_bench(args) -> int:
    """The serve-plane bench (an argparse-style namespace, as the JAX
    package's ``bench.py --serveplane`` passes: series / requests / seed
    / dir / report / data_root, and ``device``: None is the card).  The
    report goes to ``args.report`` (default ``BENCH_serveplane_<unix>
    .json`` in the working directory) and the sentinel's history to the
    working directory's ``RUNHISTORY.jsonl``.  Returns the exit code.
    The run's trace binding is restored when it ends."""
    from tsspark_tpu_torch.obs import context as obs

    scratch = os.path.join(args.dir or ".", "serveplane_scratch")
    prev = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    try:
        return _serveplane(args, scratch)
    finally:
        obs.end_run(prev)


def _serveplane(args, scratch: str) -> int:
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
    from tsspark_tpu_torch.io import atomic_write
    from tsspark_tpu_torch.serve import aotbank, fplane
    from tsspark_tpu_torch.serve.__main__ import (
        _build_demo_registry, _report_identity, _sentinel_gate,
    )
    from tsspark_tpu_torch.serve.cache import ForecastCache
    from tsspark_tpu_torch.serve.engine import PredictionEngine

    device = getattr(args, "device", None)
    t_start = time.perf_counter()
    METRICS.reset()
    registry = _build_demo_registry(
        os.path.join(scratch, "registry"), args.series, args.seed,
        data_root=args.data_root, device=device,
    )
    snap = registry.load()
    v = int(registry.active_version())
    setup_s = round(time.perf_counter() - t_start, 3)

    # -- replica cold start: no bank vs the kernel bank --------------------
    # Measured BEFORE the plane publish so the first request actually
    # takes the compute path (a plane-covered read launches nothing —
    # that is the tentpole, not this probe).
    sid0 = snap.series_ids[0]
    with _env({"TSSPARK_AOT_CACHE_DIR": None}):
        ttfr_cold = _ttfr(os.path.join(scratch, "pool_cold"),
                          registry.root, sid0, device=device)

    aot_dir = os.path.join(scratch, "aot_bank")
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import SolverConfig

    backend = get_backend("cuda", registry.config, SolverConfig(),
                          device=device)
    t0 = time.perf_counter()
    bank = aotbank.build_bank(snap, backend, dirpath=aot_dir,
                              horizons=HOT_HORIZONS)
    bank_s = round(time.perf_counter() - t0, 3)
    with _env({"TSSPARK_AOT_CACHE_DIR": aot_dir}):
        ttfr_warm = _ttfr(os.path.join(scratch, "pool_warm"),
                          registry.root, sid0, device=device)

    # -- plane publish ------------------------------------------------------
    fpub = fplane.maybe_publish(registry, v, backend,
                                horizons=HOT_HORIZONS)
    if fpub is None or fpub.get("status") == "present":
        fpub = dict(fpub or {}, status=(fpub or {}).get("status"))

    # -- hot-read throughput: plane vs forced compute path ------------------
    # Caches disabled (capacity=0) on BOTH engines: every request pays
    # its real path, so the ratio is plane-vs-dispatch, not LRU-vs-LRU.
    rng = np.random.default_rng(args.seed)
    reqs_plane = _hot_mix(rng, snap, args.requests)
    reqs_disp = _hot_mix(np.random.default_rng(args.seed),
                         snap, max(1, args.requests // 8))

    eng_plane = PredictionEngine(registry, cache=ForecastCache(0),
                                 device=device)
    eng_plane.refresh()
    _replay(eng_plane, reqs_plane[:16])  # warm pages / settle
    plane_wall, walls = _replay(eng_plane, reqs_plane,
                                record_walls=True)
    stats_plane = eng_plane.stats.snapshot()

    eng_disp = PredictionEngine(registry, cache=ForecastCache(0),
                                device=device)
    eng_disp.refresh()
    eng_disp._planes = {v: None}     # force the compute path
    _replay(eng_disp, reqs_disp[:8])  # load the library outside the clock
    disp_wall, _ = _replay(eng_disp, reqs_disp)
    stats_disp = eng_disp.stats.snapshot()

    plane_rps = round(len(reqs_plane) / plane_wall, 1)
    disp_rps = round(len(reqs_disp) / disp_wall, 1)
    read_lat = _percentiles(walls)

    METRICS.export(os.path.join(scratch, "metrics_serveplane.json"),
                   trace_id=obs.trace_id())
    report = {
        **_report_identity(registry, device),
        "n_requests": len(reqs_plane),
        "n_series": len(snap.series_ids),
        "mix": {"horizons": list(HOT_HORIZONS), "sampled_fraction": 0.0,
                "series_per_request": [1, 8], "zipf": True,
                "seed": args.seed, "cache_capacity": 0},
        "setup_s": setup_s,
        "wall_s": round(plane_wall, 3),
        "requests_per_s": plane_rps,
        "engine": stats_plane,
        "cache": eng_plane.cache.stats(),
        "plane": {
            "status": fpub.get("status"),
            "publish_s": fpub.get("publish_s"),
            "nbytes": fpub.get("nbytes"),
            "buckets": fpub.get("buckets"),
            "plane_hit_rate": stats_plane.get("plane_hit_rate"),
            "read_latency_ms": read_lat,
            "hot_read": {
                "plane_rps": plane_rps,
                "dispatch_rps": disp_rps,
                "speedup": (round(plane_rps / disp_rps, 2)
                            if disp_rps else None),
                "n_plane": len(reqs_plane),
                "n_dispatch": len(reqs_disp),
                "dispatch_engine": {
                    k: stats_disp.get(k)
                    for k in ("dispatches", "plane_hits", "completed")
                },
            },
            "ttfr": {
                "cold_arm": COLD_ARM,
                "cold_s": ttfr_cold["ttfr_s"],
                "aot_warm_s": ttfr_warm["ttfr_s"],
                "cold": ttfr_cold,
                "aot_warm": ttfr_warm,
            },
            "aot": {
                "dir": aot_dir,
                "built_s": (bank or {}).get("built_s"),
                "entries": len((bank or {}).get("entries") or ()),
                "bank_wall_s": bank_s,
            },
        },
        "active_version": v,
    }
    out = args.report or f"BENCH_serveplane_{int(time.time())}.json"
    atomic_write(out, lambda fh: json.dump(report, fh, indent=1),
                 mode="w")
    print(
        f"serveplane: plane {plane_rps}/s vs dispatch {disp_rps}/s "
        f"({report['plane']['hot_read']['speedup']}x) | plane read "
        f"p50={read_lat['p50']} p99={read_lat['p99']} ms | plane hit "
        f"rate {report['plane']['plane_hit_rate']} | publish "
        f"{fpub.get('publish_s')}s ({fpub.get('nbytes')} B) | TTFR "
        f"cold {ttfr_cold['ttfr_s']}s (first req "
        f"{ttfr_cold['first_request_s']}s) -> bank-armed "
        f"{ttfr_warm['ttfr_s']}s (first req "
        f"{ttfr_warm['first_request_s']}s) | report -> {out}"
    )
    return _sentinel_gate(report, out)
