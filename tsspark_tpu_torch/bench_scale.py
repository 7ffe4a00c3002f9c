"""The million-series ladder over ONE data plane (the port's copy of the
JAX package's ``bench_scale.py``; there ``bench.py --scale`` drives it,
here ``run_rung`` / ``run_ladder`` are called as functions).

ROADMAP item 2 ("prove millions of users") needs more than a big fit:
ingest, fit, publish, and serve must all survive the same series count
against the same storage, and every rung must leave a comparable row in
the cross-run history.  This module drives that ladder:

    ingest  — the shared columnar data plane (``data/plane``),
              block-seeded so a 1M-series dataset is representable
              without ever materializing it whole;
    fit     — the mesh-resident single-program path
              (``tsspark_tpu_torch.resident`` on ``mesh``; with no mesh on
              one card it degrades to the chunk-file protocol with the
              same artifacts, named in ``fit.fit_path``);
    publish — ``orchestrate.publish_fit_state`` into a serve registry
              whose snapshots land as the memmap column plane
              (``serve.snapplane``) plus the archival npz;
    serve   — the replica pool (or, on the smoke rung, one in-process
              engine) over that registry: time-to-first-request, a
              Zipf request mix, one mid-run version flip through the
              ahead-of-time materializer, and sharing-aware RSS
              accounting (``utils.procmem``) proving N replicas map ONE
              physical snapshot copy.

Everything runs on the card (``device=None``: the fit's kernels, the
replicas' and the engine's forecasts) unless ``device="cpu"`` asks for
the CPU; then a caller passes the host mesh (``parallel.mesh.
force_virtual_host_mesh``) for the resident fit, as the JAX package
forces its virtual CPU mesh.  Reports and history rows name the device
(``cuda:<i> (<card name>)`` or ``cpu``).

Rungs: ``smoke`` (tier-1 sized, in-process serve — the rung the test
suite and the regression sentinel accrue baselines from) then
``30k -> 100k -> 1m``.  Each rung emits one ``SCALE_<rung>_<unix>.json``
report; the history index keys its workload ``scale_<rung>`` so a 1M
row can never baseline against a smoke row, and the sentinel judges
``rss_mb_per_replica`` / ``agg_requests_per_s`` /
``time_to_first_request_s`` / ``flip_p99_ms`` against
``[tool.tsspark.slo.scale]``.

The RSS-reduction claim is MEASURED, not asserted: after the mmap pool
is scored, the same rung optionally restarts the pool with
``TSSPARK_SNAPSHOT_FORMAT=npz`` (each replica materializing a private
heap copy, the pre-plane behavior) and the report stamps both pools'
``RssAnon``/``Pss`` plus ``rss_reduction_x`` — private npz heap bytes
across the pool over the plane's shared resident bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

#: Serving horizons every rung exercises (two pow-2 buckets).
HORIZONS = (7, 14)


@dataclasses.dataclass(frozen=True)
class ScaleRung:
    """One rung of the ladder (sizes chosen so the top rung completes
    end-to-end on a one-core box; the ladder is about what breaks at
    scale, not about repeating the M5 depth benchmark)."""

    name: str
    series: int
    timesteps: int
    max_iters: int
    chunk: int
    pool_replicas: int      # 0 = in-process engine serve (tier-1)
    requests: int           # serve requests (split around the flip)
    hot: int                # hot-set size the flip materializes
    sample: int             # distinct ids in the request mix
    rss_compare: bool       # also run the npz private-heap pool


RUNGS: Dict[str, ScaleRung] = {
    "smoke": ScaleRung("smoke", 1024, 64, 8, 512, 0, 96, 24, 256,
                       False),
    "30k": ScaleRung("30k", 30_490, 128, 12, 2048, 4, 320, 64, 2048,
                     True),
    "100k": ScaleRung("100k", 100_000, 96, 8, 4096, 4, 320, 64, 2048,
                      True),
    "1m": ScaleRung("1m", 1_000_000, 64, 6, 8192, 4, 320, 64, 2048,
                    True),
}

#: The default ladder ``--scale ladder`` climbs, in order.
LADDER: Sequence[str] = ("30k", "100k", "1m")


def _config():
    """The ladder's model config — deliberately the serve loadgen's
    demo config, so registry fingerprints are shared with the serving
    tests."""
    from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig

    return ProphetConfig(
        seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3,
    )


def device_name(device=None) -> str:
    """A report's ``device``: ``cuda:<i> (<card name>)`` on the card,
    ``cpu`` on the CPU (``obs.history.device_class`` reads "gpu" / "cpu"
    off it), the name every bench report of the port carries."""
    from tsspark_tpu_torch.serve.__main__ import _device_name

    return _device_name(device)


def _identity(device=None) -> Dict:
    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.history import git_rev
    from tsspark_tpu_torch.utils import checkpoint as ckpt

    return {
        "kind": "scale-ladder",
        "unix": round(time.time(), 3),
        "trace_id": obs.trace_id(),
        "numerics_rev": NUMERICS_REV,
        "git_rev": git_rev(),
        "device": device_name(device),
        "config_fingerprint": ckpt.config_fingerprint(_config()),
    }


def _pct(vals: List[float], q: float) -> Optional[float]:
    return (round(float(np.percentile(np.asarray(vals), q)) * 1e3, 3)
            if vals else None)


def _mean(vals) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    return round(float(np.mean(vals)), 3) if vals else None


def _write_scale_report(report: Dict,
                        path: Optional[str] = None) -> str:
    """Persist one rung's report as ``SCALE_<rung>_<unix>.json``
    (atomic, like every other report artifact)."""
    from tsspark_tpu_torch.utils.atomic import atomic_write

    out = path or (f"SCALE_{report.get('rung')}"
                   f"_{int(report.get('unix', time.time()))}.json")
    atomic_write(out, lambda fh: json.dump(report, fh, indent=1),
                 mode="w")
    return out


# ---------------------------------------------------------------------------
# serve-side measurement
# ---------------------------------------------------------------------------


def _request_mix(rung: ScaleRung, ids: np.ndarray, seed: int = 0):
    """Deterministic Zipf-ish mix over a row sample spread across the
    WHOLE id range (random rows = random pages — the on-demand paging
    the mmap snapshot must serve).  Returns (sample_ids, picks) where
    picks is a list of (series_list, horizon)."""
    rng = np.random.default_rng(seed)
    n = len(ids)
    sample_rows = np.sort(rng.choice(n, size=min(rung.sample, n),
                                     replace=False))
    sample = ids[sample_rows]
    w = 1.0 / (1.0 + np.arange(len(sample)))
    w /= w.sum()
    picks = []
    for i in range(rung.requests):
        k = int(rng.integers(1, min(9, len(sample) + 1)))
        rows = rng.choice(len(sample), size=k, replace=False, p=w)
        picks.append(([str(sample[j]) for j in rows],
                      int(HORIZONS[i % len(HORIZONS)])))
    return sample, picks


def _pool_mem(stats: Dict) -> Dict:
    """Fold ``ReplicaPool.stats()`` per-replica memory into the rung's
    RSS metrics (sharing-aware: see utils.procmem)."""
    per = [v.get("mem") or {} for v in stats["replicas"].values()
           if isinstance(v, dict) and not v.get("down")]
    snap_pss = [((m.get("snap") or {}).get("pss_mb")) for m in per]
    return {
        "replicas_sampled": len(per),
        "rss_mb_per_replica": _mean([m.get("rss_mb") for m in per]),
        "pss_mb_per_replica": _mean([m.get("pss_mb") for m in per]),
        "rss_anon_mb_per_replica": _mean(
            [m.get("rss_anon_mb") for m in per]
        ),
        "snap_pss_total_mb": (round(sum(v for v in snap_pss
                                        if v is not None), 3)
                              if any(v is not None for v in snap_pss)
                              else None),
        "per_replica": per,
    }


def _serve_pool(rung: ScaleRung, registry, ids: np.ndarray,
                scratch: str, v_next: int, device=None) -> Dict:
    """Pool-serve one rung: spawn, first-request, mix, mid-run flip,
    sharing-aware memory.  The replicas serve on ``device`` (None: the
    card, a CUDA context each)."""
    from tsspark_tpu_torch.serve.pool import ReplicaPool

    sample, picks = _request_mix(rung, ids)
    hot = [str(s) for s in sample[:rung.hot]]
    pool = ReplicaPool(
        os.path.join(scratch, "pool"), registry.root,
        n_replicas=rung.pool_replicas, device=device,
    )
    t_start = time.monotonic()
    pool.start()
    first = pool.forecast([str(sample[0])], HORIZONS[0])
    t_first = time.monotonic() - t_start
    assert first.get("ok"), f"first request failed: {first}"
    # Warm the hot set ahead of the measured window (the steady state a
    # production pool serves; the flip re-warms the same set for v2).
    for slot in range(rung.pool_replicas):
        try:
            pool._request_slot(slot, {
                "cmd": "warm", "version": registry.active_version(),
                "series_ids": hot, "horizons": list(HORIZONS),
            }, timeout_s=600.0)
        except Exception:
            pass
    latencies: List[float] = []
    done_at: List[float] = []
    outcomes = {"ok": 0, "failed": 0}
    flip = {}
    t0 = time.monotonic()
    for i, (sids, h) in enumerate(picks):
        if i == len(picks) // 2:
            t_f0 = time.monotonic()
            pool.activate(v_next, hot_series=hot,
                          horizons=HORIZONS)
            flip = {"version": v_next, "t0": t_f0,
                    "t1": time.monotonic()}
        t_r0 = time.monotonic()
        try:
            resp = pool.forecast(sids, h)
            ok = bool(resp.get("ok"))
        except Exception:
            ok = False
        t_r1 = time.monotonic()
        outcomes["ok" if ok else "failed"] += 1
        if ok:
            latencies.append(t_r1 - t_r0)
            done_at.append(t_r1)
    wall = time.monotonic() - t0
    stats = pool.stats()
    mem = _pool_mem(stats)
    win = [lat for lat, done in zip(latencies, done_at)
           if flip and flip["t0"] <= done <= flip["t1"] + 1.0]
    out = {
        "mode": "pool",
        "replicas": rung.pool_replicas,
        "time_to_first_request_s": round(t_first, 3),
        "wall_s": round(wall, 3),
        "requests": rung.requests,
        "outcomes": outcomes,
        "agg_requests_per_s": (round(rung.requests / wall, 2)
                               if wall > 0 else None),
        "latency_ms": {"p50": _pct(latencies, 50),
                       "p99": _pct(latencies, 99)},
        "flip": {
            "version": flip.get("version"),
            "wall_s": (round(flip["t1"] - flip["t0"], 3)
                       if flip else None),
            "n_in_window": len(win),
            "p99_ms": _pct(win, 99),
        },
        "failovers": stats["failovers"],
        "wrong_version": stats["wrong_version"],
        "mem": mem,
    }
    pool.stop()
    return out


def _serve_engine(rung: ScaleRung, registry, ids: np.ndarray,
                  v_next: int, device=None) -> Dict:
    """In-process engine serve (the smoke rung / tier-1 path): same
    stages, no replica processes — memory read from /proc/self."""
    from tsspark_tpu_torch.serve.engine import PredictionEngine
    from tsspark_tpu_torch.utils.procmem import mapped_file_mem, proc_mem

    sample, picks = _request_mix(rung, ids)
    hot = [str(s) for s in sample[:rung.hot]]
    t_start = time.monotonic()
    engine = PredictionEngine(registry, device=device)
    engine.forecast([str(sample[0])], HORIZONS[0])
    t_first = time.monotonic() - t_start
    engine.materialize(hot, HORIZONS)
    latencies: List[float] = []
    done_at: List[float] = []
    failed = 0
    flip = {}
    t0 = time.monotonic()
    for i, (sids, h) in enumerate(picks):
        if i == len(picks) // 2:
            t_f0 = time.monotonic()
            # The engine analog of the pool's materialize->flip: pages
            # warm during prefetch (the plane's CRC sweep), forecasts
            # for the hot set land in the cache's warm window, then the
            # pointer flips.
            engine.prefetch(v_next)
            engine.materialize(hot, HORIZONS, version=v_next)
            registry.activate(v_next)
            flip = {"version": v_next, "t0": t_f0,
                    "t1": time.monotonic()}
        t_r0 = time.monotonic()
        try:
            engine.forecast(sids, h)
        except Exception:
            failed += 1  # a shed/failed request must not abort the rung
            continue
        t_r1 = time.monotonic()
        latencies.append(t_r1 - t_r0)
        done_at.append(t_r1)
    wall = time.monotonic() - t0
    win = [lat for lat, done in zip(latencies, done_at)
           if flip and flip["t0"] <= done <= flip["t1"] + 1.0]
    mem = proc_mem()
    return {
        "mode": "engine",
        "replicas": 0,
        "time_to_first_request_s": round(t_first, 3),
        "wall_s": round(wall, 3),
        "requests": rung.requests,
        "outcomes": {"ok": len(latencies), "failed": failed},
        "agg_requests_per_s": (round(rung.requests / wall, 2)
                               if wall > 0 else None),
        "latency_ms": {"p50": _pct(latencies, 50),
                       "p99": _pct(latencies, 99)},
        "flip": {
            "version": flip.get("version"),
            "wall_s": (round(flip["t1"] - flip["t0"], 3)
                       if flip else None),
            "n_in_window": len(win),
            "p99_ms": _pct(win, 99),
        },
        "mem": {
            "replicas_sampled": 1,
            "rss_mb_per_replica": mem.get("rss_mb"),
            "pss_mb_per_replica": mem.get("pss_mb"),
            "rss_anon_mb_per_replica": mem.get("rss_anon_mb"),
            "snap_pss_total_mb": mapped_file_mem().get("pss_mb"),
        },
        "cache": engine.cache.stats(),
    }


def _rss_comparison(rung: ScaleRung, registry, ids: np.ndarray,
                    scratch: str, mmap_mem: Dict, device=None) -> Dict:
    """Restart the pool with snapshots pinned to the npz format (each
    replica parses a PRIVATE heap copy — the pre-plane behavior) and
    measure the same sharing-aware counters.  The reduction ratio is
    private npz snapshot bytes across the pool over the plane's shared
    resident bytes."""
    from tsspark_tpu_torch.serve.pool import ReplicaPool

    sample, _ = _request_mix(rung, ids)
    hot = [str(s) for s in sample[:rung.hot]]
    prev = os.environ.get("TSSPARK_SNAPSHOT_FORMAT")
    os.environ["TSSPARK_SNAPSHOT_FORMAT"] = "npz"
    try:
        pool = ReplicaPool(
            os.path.join(scratch, "pool_npz"), registry.root,
            n_replicas=rung.pool_replicas, device=device,
        )
        pool.start()
        pool.forecast([str(sample[0])], HORIZONS[0])
        for slot in range(rung.pool_replicas):
            try:
                pool._request_slot(slot, {
                    "cmd": "warm",
                    "version": registry.active_version(),
                    "series_ids": hot, "horizons": list(HORIZONS),
                }, timeout_s=600.0)
            except Exception:
                pass
        npz_mem = _pool_mem(pool.stats())
        pool.stop()
    finally:
        if prev is None:
            os.environ.pop("TSSPARK_SNAPSHOT_FORMAT", None)
        else:
            os.environ["TSSPARK_SNAPSHOT_FORMAT"] = prev
    out = {"npz": npz_mem}
    anon_npz = npz_mem.get("rss_anon_mb_per_replica")
    anon_mmap = mmap_mem.get("rss_anon_mb_per_replica")
    shared = mmap_mem.get("snap_pss_total_mb")
    if None not in (anon_npz, anon_mmap) and shared:
        # Numerator: the private anonymous bytes the npz snapshots cost
        # across the pool (npz replicas' anon heap minus the mmap
        # replicas' anon baseline — same engine, same warm set).
        # Denominator: the ONE physical copy the plane keeps resident.
        private = max(0.0, anon_npz - anon_mmap) * rung.pool_replicas
        out["snapshot_private_mb_total"] = round(private, 3)
        out["snapshot_shared_mb_total"] = shared
        out["rss_reduction_x"] = round(private / shared, 2)
    return out


# ---------------------------------------------------------------------------
# one rung, end to end
# ---------------------------------------------------------------------------


def run_rung(rung, *, data_root: Optional[str] = None,
             scratch_root: Optional[str] = None,
             report_path: Optional[str] = None,
             deadline_s: Optional[float] = None,
             sentinel: Optional[bool] = None,
             rss_compare: Optional[bool] = None,
             device=None, mesh=None) -> Dict:
    """Drive one rung ingest -> fit -> publish -> serve; returns the
    report dict (also written as ``SCALE_*.json`` in the working
    directory and, unless the sentinel is opted out, judged against the
    rolling baseline in its ``RUNHISTORY.jsonl``).

    ``device``: where the fit and the serving run (None: the card).
    ``mesh``: the resident fit's mesh (None: the default one; on one card
    the chunk-file protocol's worker process)."""
    import tempfile

    from tsspark_tpu_torch import orchestrate, resident
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.serve import snapplane
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    if isinstance(rung, str):
        rung = RUNGS[rung]
    cfg = _config()
    scratch = os.path.join(
        scratch_root or tempfile.gettempdir(),
        f"tsscale_{rung.name}_{rung.series}x{rung.timesteps}"
        f"_{plane.dataset_fingerprint()}",
    )
    os.makedirs(scratch, exist_ok=True)
    prev_run = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    t_rung0 = time.time()
    report = {**_identity(device), "rung": rung.name,
              "series": rung.series, "timesteps": rung.timesteps}
    try:
        # ---- ingest: the shared columnar plane ----------------------
        spec = plane.DatasetSpec(
            generator="demo_weekly", n_series=rung.series,
            n_timesteps=rung.timesteps, seed=2,
        )
        dset_dir = plane.dataset_dir(spec, data_root)
        warm = plane.is_complete(dset_dir)
        t0 = time.time()
        dset_dir = plane.ensure(spec, root=data_root)
        ingest_s = time.time() - t0
        ids = plane.series_ids(spec)
        report["ingest"] = {"warm": warm,
                            "ingest_s": round(ingest_s, 3),
                            "dataset": os.path.basename(dset_dir)}

        # ---- fit: the mesh-resident path ----------------------------
        out_dir = os.path.join(scratch, "out")
        os.makedirs(out_dir, exist_ok=True)
        solver = SolverConfig(max_iters=rung.max_iters)
        orchestrate.save_run_config(out_dir, cfg, solver)
        t0 = time.time()
        fit_state = resident.run_resident(
            data_dir=dset_dir, out_dir=out_dir, series=rung.series,
            chunk=rung.chunk, phase1_iters=0, no_phase1_tune=True,
            deadline=(time.time() + deadline_s
                      if deadline_s else None),
            mesh=mesh, device=device,
        )
        fit_s = time.time() - t0
        n_done = sum(hi - lo for lo, hi in
                     orchestrate.completed_ranges(out_dir))
        report["fit"] = {
            "fit_s": round(fit_s, 3),
            "fit_path": fit_state.get("fit_path"),
            "complete": bool(fit_state.get("complete")),
            "series_done": n_done,
            "series_per_s": (round(n_done / fit_s, 2)
                             if fit_s > 0 else None),
        }
        if not fit_state.get("complete"):
            report["complete"] = False
            return report

        # ---- publish: mmap plane + archival npz ---------------------
        registry = ParamRegistry(
            os.path.join(scratch, "registry"), cfg,
        )
        t0 = time.time()
        v1 = orchestrate.publish_fit_state(registry, out_dir, ids)
        publish_s = time.time() - t0
        vdir = os.path.join(registry.root, f"v{v1:06d}")
        nbytes = snapplane.snapshot_nbytes(vdir)
        report["publish"] = {
            "publish_s": round(publish_s, 3),
            "version": v1,
            "snapshot_mb": (round(nbytes / 1e6, 3)
                            if nbytes else None),
            "format": registry.snapshot_format,
        }
        # The mid-run flip target, published before the clock starts.
        snap = registry.load(v1, fallback=False)
        v2 = registry.publish(
            snap.state._replace(
                theta=np.asarray(snap.state.theta) * 1.01
            ),
            ids, step=np.asarray(snap.step), activate=False,
        )

        # ---- serve: pool (or in-process engine) ---------------------
        if rung.pool_replicas:
            serve = _serve_pool(rung, registry, ids, scratch, v2,
                                device=device)
            compare = (rung.rss_compare if rss_compare is None
                       else rss_compare)
            if compare:
                serve["rss_compare"] = _rss_comparison(
                    rung, registry, ids, scratch, serve["mem"],
                    device=device,
                )
        else:
            serve = _serve_engine(rung, registry, ids, v2, device=device)
        report["serve"] = serve
        report["complete"] = True
        return report
    finally:
        report["wall_s"] = round(time.time() - t_rung0, 3)
        obs.end_run(prev_run)
        out = _write_scale_report(report, report_path)
        report["path"] = out
        if sentinel is None:
            sentinel = os.environ.get("TSSPARK_SENTINEL", "1") != "0"
        if sentinel:
            try:
                from tsspark_tpu_torch.obs import regress

                verdict = regress.sentinel_report(
                    report, source=f"scale:{rung.name}"
                )
                if verdict is not None:
                    print(f"[scale] {regress.summarize(verdict)}")
                    report["sentinel_ok"] = verdict["ok"]
            except Exception as e:  # never mask the report itself
                print(f"[scale] sentinel skipped: {e!r}")


def run_ladder(rungs: Sequence[str] = LADDER, **kwargs) -> List[Dict]:
    """Climb the ladder rung by rung (each rung is independently
    resumable through the resident fit's chunk protocol)."""
    out = []
    for name in rungs:
        print(f"[scale] rung {name}: "
              f"{RUNGS[name].series} series x "
              f"{RUNGS[name].timesteps} steps")
        rep = run_rung(name, **kwargs)
        serve = rep.get("serve") or {}
        print(json.dumps({
            "rung": rep.get("rung"),
            "complete": rep.get("complete"),
            "fit_s": (rep.get("fit") or {}).get("fit_s"),
            "publish_s": (rep.get("publish") or {}).get("publish_s"),
            "ttfr_s": serve.get("time_to_first_request_s"),
            "agg_rps": serve.get("agg_requests_per_s"),
            "flip_p99_ms": (serve.get("flip") or {}).get("p99_ms"),
            "rss_reduction_x": (serve.get("rss_compare") or {}
                                ).get("rss_reduction_x"),
            "report": rep.get("path"),
        }), flush=True)
        out.append(rep)
        if not rep.get("complete"):
            break  # a failed rung gates the rungs above it
    return out
