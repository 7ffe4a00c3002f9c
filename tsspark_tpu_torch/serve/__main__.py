"""``python -m tsspark_tpu_torch.serve`` — serve forecasts, or load-test
the serving stack (the port's copy of the JAX package's serve CLI).

Daemon mode (default): attach to a registry and answer stdin JSONL::

    {"series_ids": ["a", "b"], "horizon": 14, "num_samples": 0,
     "deadline_ms": 250, "id": "req-1"}

one response line per request (``ok``/``error`` + (B, H) arrays), plus
``{"cmd": "stats"}`` / ``{"cmd": "metrics"}`` / ``{"cmd": "activate",
"version": N}`` / ``{"cmd": "rollback"}`` control lines.  A request
line may carry a ``trace`` envelope (``{"trace_id", "parent_span_id"}``)
and its engine spans then join the caller's trace.

Loadgen mode (``--loadgen N``): build a demo registry (the data plane's
``demo_weekly`` fitted through ``CudaBackend``) or reuse ``--registry``,
replay a deterministic Zipf-ish request mix of N requests through the
engine, and write a ``SERVE_<unix>.json`` report — p50/p95/p99 latency,
batch occupancy, cache hit rate, per-dispatch telemetry via
``perf.PerfRecorder``.  With ``--pool R`` the same mix is replayed
against R replica PROCESSES behind the sharding pool front
(``serve.pool.ReplicaPool``) in pipelined waves with one mid-run version
flip through the ahead-of-time materializer; the report gains a
``pool`` section (aggregate req/s, failovers, per-replica shed counts,
flip-window p99).  Either loadgen ends with the regression sentinel
(``obs.regress``; ``TSSPARK_SENTINEL=0`` turns it off): the report
joins the run history (``--history``, default ``RUNHISTORY.jsonl`` in
the working directory) and a breach of the rolling baseline makes the
exit code 1.

One departure from the JAX package's CLI, which pins itself to the CPU:
the port's entry points run on the card unless the caller asks for the
CPU.  So the daemon, the loadgen and the pool's replicas run on ``cuda``
by default, on the CPU only with ``--device cpu`` (or
``TSSPARK_SERVE_DEVICE=cpu``), and without a card and without that
request they fail loudly.  ``$TSSPARK_AOT_CACHE_DIR`` arms the kernel
bank (``serve/aotbank.py``) before anything loads the kernel library.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

#: The reference's request mix.
HORIZONS = (7, 14, 28)
SAMPLED_FRACTION = 0.1
SAMPLES = 20
HOPELESS_FRACTION = 0.02


def _build_demo_registry(root: str, n_series: int, seed: int,
                         data_root: str = None, device=None):
    """Fit the shared demo dataset and publish it as version 1.

    The batch comes from the columnar data plane (generator
    ``demo_weekly``), so the loadgen has no private datagen path and a
    repeated loadgen is a pure memmap read.  The fit runs through
    ``CudaBackend`` on ``device`` (K3 and K4 on the card)."""
    import numpy as np

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        ProphetConfig, SeasonalityConfig, SolverConfig,
    )
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    config = ProphetConfig(
        seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3,
    )
    spec = plane.DatasetSpec(
        generator="demo_weekly", n_series=n_series, n_timesteps=180,
        seed=seed,
    )
    batch = plane.open_batch(plane.ensure(spec, root=data_root))
    backend = get_backend("cuda", config, SolverConfig(max_iters=25),
                          device=device)
    state = backend.fit(np.asarray(batch.ds, np.float64),
                        np.asarray(batch.y))
    registry = ParamRegistry(root, config)
    registry.publish(state, np.asarray(batch.series_ids),
                     step=np.ones(n_series))
    return registry


def _zipf_weights(n: int):
    import numpy as np

    w = 1.0 / (1.0 + np.arange(n))
    return w / w.sum()


def _loadgen_setup(args):
    """Shared loadgen scaffolding: bind the run's trace, reset the
    metrics registry, and open (or demo-build) the registry.  Returns
    ``(scratch_root, registry, prev)``: ``prev`` is the run binding to
    restore with ``obs.end_run`` when the loadgen ends."""
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    # One trace per loadgen run: engine request/dispatch spans land in
    # the scratch's spans.jsonl, and the report is stamped with the
    # trace id.
    scratch_root = os.path.join(args.dir or ".", "serve_scratch")
    prev = obs.start_run(os.path.join(scratch_root, "spans.jsonl"))
    try:
        METRICS.reset()  # this run's snapshot describes this run only
        if args.registry and os.path.exists(
            os.path.join(args.registry, "manifest.json")
        ):
            registry = ParamRegistry.open(args.registry)
        else:
            root = args.registry or os.path.join(scratch_root, "registry")
            registry = _build_demo_registry(root, args.series, args.seed,
                                            data_root=args.data_root,
                                            device=args.device)
    except BaseException:
        obs.end_run(prev)
        raise
    return scratch_root, registry, prev


def _device_name(device) -> str:
    """The report's ``device``: ``cuda:<i> (<card name>)`` on the card,
    ``cpu`` on the CPU (``obs.history.device_class`` reads "gpu" /
    "cpu" off it, so a card run never baselines against a CPU row)."""
    import torch

    from tsspark_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return f"cuda:{idx} ({torch.cuda.get_device_name(idx)})"
    return str(dev)


def _report_identity(registry, device=None) -> dict:
    """The cross-run identity block every SERVE report carries
    (``obs.history``): the sentinel baselines latency/shed/hit-rate only
    across matching numerics revs and device classes."""
    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.history import git_rev
    from tsspark_tpu_torch.utils import checkpoint as ckpt

    return {
        "kind": "serve-loadgen",
        "unix": round(time.time(), 3),
        "trace_id": obs.trace_id(),
        "numerics_rev": NUMERICS_REV,
        "git_rev": git_rev(),
        "device": _device_name(device),
        "config_fingerprint": ckpt.config_fingerprint(registry.config),
    }


def _write_report(report, args) -> str:
    """Persist the SERVE report atomically; returns its path."""
    from tsspark_tpu_torch.io import atomic_write

    out = args.report or f"SERVE_{int(time.time())}.json"
    atomic_write(out, lambda fh: json.dump(report, fh, indent=1),
                 mode="w")
    return out


def _sentinel_gate(report, out, history_path: Optional[str] = None) -> int:
    """Regression sentinel post-step: the report joins the run history
    and a breach of the rolling baseline makes the loadgen exit nonzero.
    ``history_path`` (default: ``obs.history.HISTORY_FILE`` in the
    working directory) also decides where the ``REGRESSION_*.json``
    verdict goes: beside the history file.  Returns the exit code."""
    if os.environ.get("TSSPARK_SENTINEL", "1") != "0":
        try:
            from tsspark_tpu_torch.obs import history, regress

            path = history_path or history.HISTORY_FILE
            verdict_out = None
            if history_path:
                hist_dir = os.path.dirname(os.path.abspath(history_path))
                os.makedirs(hist_dir, exist_ok=True)
                verdict_out = os.path.join(
                    hist_dir, f"REGRESSION_{int(time.time())}.json")
            verdict = regress.sentinel_report(report, history_path=path,
                                              source=out, out=verdict_out)
            if verdict is not None:
                print(regress.summarize(verdict))
                if not verdict["ok"]:
                    return 1
        except Exception as e:
            print(f"sentinel skipped: {e!r}", file=sys.stderr)
    return 0


def _mix(seed: int, **extra) -> dict:
    return {
        "horizons": list(HORIZONS),
        "sampled_fraction": SAMPLED_FRACTION,
        "hopeless_deadline_fraction": HOPELESS_FRACTION,
        "series_per_request": [1, 8],
        "zipf": True,
        "seed": seed,
        **extra,
    }


def _loadgen(args) -> int:
    import numpy as np

    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
    from tsspark_tpu_torch.perf import CompileWatch, PerfRecorder
    from tsspark_tpu_torch.resilience import RetryPolicy
    from tsspark_tpu_torch.serve.cache import ForecastCache
    from tsspark_tpu_torch.serve.engine import (
        EngineOverloaded, ForecastRequest, PredictionEngine,
    )

    t_start = time.perf_counter()
    scratch_root, registry, prev = _loadgen_setup(args)
    try:
        # Kernel-library loads and builds stand in for the JAX package's
        # trace compiles in each dispatch's record.
        recorder = PerfRecorder(watch=CompileWatch.default())
        engine = PredictionEngine(
            registry,
            max_queue=args.max_queue,
            max_batch=args.max_batch,
            cache=ForecastCache(capacity=args.cache_capacity),
            device=args.device,
            recorder=recorder,
            retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                                     backoff=2.0, max_delay_s=0.1),
        )
        snap = engine.refresh()
        n_series = len(snap.series_ids)

        rng = np.random.default_rng(args.seed)
        weights = _zipf_weights(n_series)
        n = args.loadgen
        pending = []
        wave = max(1, args.max_batch // 2)
        submitted = 0
        t0 = time.perf_counter()
        while submitted < n:
            k = min(wave, n - submitted)
            for _ in range(k):
                k_sids = rng.integers(1, min(9, n_series + 1))
                sids = rng.choice(n_series, size=k_sids, replace=False,
                                  p=weights)
                sampled = rng.random() < SAMPLED_FRACTION
                req = ForecastRequest.make(
                    [snap.series_ids[i] for i in sids],
                    horizon=int(rng.choice(HORIZONS)),
                    num_samples=SAMPLES if sampled else 0,
                    seed=args.seed,
                    # ~2% arrive already hopeless: the shedding path
                    # under load, not just in unit tests.
                    deadline_in_s=(0.0 if rng.random() < HOPELESS_FRACTION
                                   else 30.0),
                )
                try:
                    pending.append(engine.submit(req))
                except EngineOverloaded:
                    pass  # counted in engine.stats.rejected
                submitted += 1
            while engine.pump() > 0:
                pass
        wall_s = time.perf_counter() - t0

        stats = engine.stats.snapshot()
        METRICS.export(os.path.join(scratch_root, "metrics_loadgen.json"),
                       trace_id=obs.trace_id())
        report = {
            **_report_identity(registry, args.device),
            "n_requests": n,
            "n_series": n_series,
            "mix": _mix(args.seed),
            "wall_s": round(wall_s, 3),
            "setup_s": round(t0 - t_start, 3),
            "requests_per_s": round(n / wall_s, 1) if wall_s > 0 else None,
            "engine": stats,
            "cache": engine.cache.stats(),
            "dispatch": recorder.report().to_dict(),
            "active_version": registry.active_version(),
        }
        out = _write_report(report, args)
        lat = stats["latency_ms"]
        print(
            f"serve loadgen: {n} requests in {wall_s:.2f}s "
            f"({report['requests_per_s']}/s) | latency p50={lat['p50']} "
            f"p95={lat['p95']} p99={lat['p99']} ms | cache hit rate "
            f"{report['cache']['hit_rate']} | shed {stats['shed']} | "
            f"report -> {out}"
        )
        return _sentinel_gate(report, out, args.history)
    finally:
        obs.end_run(prev)


def _pool_replay(pool, sids_all: Sequence[str], n: int, seed: int,
                 wave: int, n_threads: int, flip_version: int,
                 hooks: Sequence[Tuple[float, Callable]] = (),
                 flip_horizons: Sequence[int] = HORIZONS) -> Dict:
    """Replay ``n`` requests of the mix against ``pool`` from
    ``n_threads`` client threads in pipelined waves of ``wave``, with
    one version flip (``pool.activate(flip_version)``, the 16 hottest
    series materialized at ``flip_horizons``) once half the requests
    completed.  ``hooks``:
    ``(fraction, fn)`` pairs, each ``fn(pool)`` run in this thread once
    that fraction of the requests completed (before the flip when the
    fraction is below one half).  Returns the outcomes, the latencies,
    the flip window and the walls."""
    import numpy as np

    n_series = len(sids_all)
    weights = _zipf_weights(n_series)
    lock = threading.Lock()
    completed = [0]
    outcomes = {"ok": 0, "shed": 0, "rejected": 0, "failed": 0}
    failures: list = []
    latencies: list = []   # (t_done_monotonic, latency_s)

    def client(tid: int, share: int) -> None:
        rng = np.random.default_rng(seed * 1009 + tid)
        sent = 0
        while sent < share:
            k = min(wave, share - sent)
            reqs = []
            for j in range(k):
                k_sids = int(rng.integers(1, min(9, n_series + 1)))
                pick = rng.choice(n_series, size=k_sids, replace=False,
                                  p=weights)
                sampled = rng.random() < SAMPLED_FRACTION
                reqs.append({
                    "id": f"t{tid}-{sent + j}",
                    "series_ids": [sids_all[i] for i in pick],
                    "horizon": int(rng.choice(HORIZONS)),
                    "num_samples": SAMPLES if sampled else 0,
                    "seed": seed,
                    "deadline_ms": (0.0 if rng.random() < HOPELESS_FRACTION
                                    else 30_000.0),
                })
            t0 = time.monotonic()
            resp = pool.submit_wave(reqs)
            t1 = time.monotonic()
            with lock:
                for r in resp.values():
                    if r.get("ok"):
                        outcomes["ok"] += 1
                        latencies.append((t1, t1 - t0))
                    else:
                        reason = (r.get("error") or {}).get("reason")
                        if reason == "deadline-exceeded":
                            outcomes["shed"] += 1
                        elif reason == "overloaded":
                            outcomes["rejected"] += 1
                        else:
                            outcomes["failed"] += 1
                            failures.append(r)
                completed[0] += len(resp)
            sent += k

    shares = [n // n_threads + (1 if t < n % n_threads else 0)
              for t in range(n_threads)]
    threads = [threading.Thread(target=client, args=(t, shares[t]),
                                daemon=True)
               for t in range(n_threads)]
    todo = sorted(hooks, key=lambda h: h[0]) + [(0.5, None)]
    hooks_s = []
    flip: dict = {}
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for frac, fn in todo:
        while (completed[0] < n * frac
               and any(t.is_alive() for t in threads)):
            time.sleep(0.005)
        if fn is not None:
            h0 = time.perf_counter()
            fn(pool)
            hooks_s.append(round(time.perf_counter() - h0, 3))
            continue
        # Mid-run version flip behind the materializer: warm the
        # hottest series for the new version on every replica, flip,
        # drain one at a time.
        hot = [sids_all[i] for i in np.argsort(-weights)[:16]]
        t_f0 = time.monotonic()
        at = completed[0]
        warmed = pool.activate(flip_version, hot_series=hot,
                               horizons=flip_horizons)
        t_f1 = time.monotonic()
        flip = {"version": int(flip_version), "t0": t_f0, "t1": t_f1,
                "wall_s": round(t_f1 - t_f0, 3), "at_completed": at,
                "hot": hot, "warmed": warmed}
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    # Flip-window p99: client-observed latency of requests completing
    # from warm-start to one second past the drain.
    win = [lat for (done, lat) in latencies
           if flip and flip["t0"] <= done <= flip["t1"] + 1.0]
    flip["n_in_window"] = len(win)
    flip["p99_ms"] = (round(float(np.percentile(win, 99)) * 1e3, 3)
                      if win else None)
    lat_all = np.asarray([lat for _, lat in latencies], np.float64)
    pct = (lambda q: round(float(np.percentile(lat_all, q)) * 1e3, 3)) \
        if lat_all.size else (lambda q: None)
    return {
        "wall_s": wall_s,
        "outcomes": outcomes,
        "failures": failures[:20],
        "flip": flip,
        "hooks_s": hooks_s,
        "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                       "mean": (round(float(lat_all.mean()) * 1e3, 3)
                                if lat_all.size else None),
                       "max": (round(float(lat_all.max()) * 1e3, 3)
                               if lat_all.size else None)},
    }


def pool_report(registry, pool, replay: Dict, n: int, seed: int,
                n_threads: int, wave: int, setup_s: float,
                device=None) -> Dict:
    """The pool loadgen's SERVE report from a ``_pool_replay`` result
    and the pool's stats."""
    stats = pool.stats()
    outcomes = replay["outcomes"]
    wall_s = replay["wall_s"]
    return {
        **_report_identity(registry, device),
        "n_requests": n,
        "n_series": len(registry.load().series_ids),
        "mix": _mix(seed, clients=n_threads, wave=wave),
        "wall_s": round(wall_s, 3),
        "setup_s": round(setup_s, 3),
        "requests_per_s": round(n / wall_s, 1) if wall_s > 0 else None,
        "engine": {
            "submitted": n,
            "completed": outcomes["ok"],
            "shed": outcomes["shed"],
            "rejected": outcomes["rejected"],
            "failed": outcomes["failed"],
            "latency_ms": replay["latency_ms"],
        },
        "pool": {
            "replicas": pool.n_replicas,
            "clients": n_threads,
            "failovers": stats["failovers"],
            "respawns": stats["respawns"],
            "wrong_version": stats["wrong_version"],
            "fenced_seen": stats["fenced_seen"],
            "per_replica": stats["replicas"],
            "flip": {k: v for k, v in replay["flip"].items()
                     if k not in ("hot", "warmed")},
        },
        "active_version": registry.active_version(),
    }


def _pool_loadgen(args) -> int:
    """Loadgen against a replica pool (``--loadgen N --pool R``): R
    replica processes behind the sharding front, T client threads
    replaying the same deterministic Zipf mix in pipelined waves, one
    mid-run version flip through the ahead-of-time materializer."""
    import numpy as np

    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
    from tsspark_tpu_torch.serve.pool import ReplicaPool

    t_start = time.perf_counter()
    scratch_root, registry, prev = _loadgen_setup(args)
    pool = None
    try:
        snap = registry.load()
        sids_all = list(snap.series_ids)
        # The mid-run flip target, published ahead of the replay.
        v_next = registry.publish(
            snap.state._replace(theta=snap.state.theta * 1.01),
            sids_all, step=np.asarray(snap.step), activate=False,
        )
        pool = ReplicaPool(
            os.path.join(scratch_root, "pool"), registry.root,
            n_replicas=args.pool, max_queue=args.max_queue,
            max_batch=args.max_batch, cache_capacity=args.cache_capacity,
            device=args.device,
        )
        pool.start()
        pool.start_watch(0.3)
        # Ahead-of-time materialization before the clock starts: the
        # replay measures serving, not each replica cold-filling its
        # deterministic working set.
        active_v = registry.active_version()
        for slot in range(args.pool):
            try:
                pool._request_slot(slot, {
                    "cmd": "warm", "version": active_v,
                    "series_ids": sids_all[:256],
                    "horizons": list(HORIZONS),
                }, timeout_s=300.0)
            except Exception:
                pass  # cold replicas warm in-run instead
        n = args.loadgen
        n_threads = args.pool_clients or min(8, 2 * args.pool)
        wave = max(1, args.max_batch // 2)
        setup_s = time.perf_counter() - t_start
        replay = _pool_replay(pool, sids_all, n, args.seed, wave,
                              n_threads, v_next)
        METRICS.export(os.path.join(scratch_root, "metrics_loadgen.json"),
                       trace_id=obs.trace_id())
        report = pool_report(registry, pool, replay, n, args.seed,
                             n_threads, wave, setup_s, args.device)
        pool.stop()
        pool = None
        out = _write_report(report, args)
        lat = report["engine"]["latency_ms"]
        flip = report["pool"]["flip"]
        shed_pr = {k: (v or {}).get("shed")
                   for k, v in report["pool"]["per_replica"].items()}
        print(
            f"pool loadgen: {n} requests x {args.pool} replicas in "
            f"{report['wall_s']:.2f}s ({report['requests_per_s']}/s "
            f"aggregate) | client p50={lat['p50']} p99={lat['p99']} ms | "
            f"flip p99={flip['p99_ms']} ms over {flip['n_in_window']} | "
            f"failovers {report['pool']['failovers']} | wrong-version "
            f"{report['pool']['wrong_version']} | shed/replica {shed_pr} "
            f"| report -> {out}"
        )
        return _sentinel_gate(report, out, args.history)
    finally:
        if pool is not None:
            pool.stop()
        obs.end_run(prev)


def _daemon(args) -> int:
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.serve.engine import PredictionEngine
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    registry = ParamRegistry.open(args.registry)
    # Daemon spans live next to the registry it serves.
    prev = obs.start_run(os.path.join(args.registry, "spans.jsonl"))
    try:
        engine = PredictionEngine(
            registry, max_queue=args.max_queue, max_batch=args.max_batch,
            device=args.device,
        )

        def emit(obj):
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()

        try:
            return _serve_lines(registry, engine, emit,
                                metrics_every=args.metrics_every,
                                metrics_dir=args.registry)
        except BrokenPipeError:
            return 0  # client went away; nothing left to answer
    finally:
        obs.end_run(prev)


def _serve_lines(registry, engine, emit, lines=None,
                 metrics_every=None, metrics_dir=None) -> int:
    """The daemon's request loop (``lines`` defaults to stdin; tests
    pass a list).  ``metrics_every``: export an atomic
    ``metrics_daemon.json`` snapshot next to the registry at most every
    N seconds (checked per request line, so an idle daemon leaves its
    last snapshot in place)."""
    import contextlib

    import numpy as np

    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
    from tsspark_tpu_torch.serve.engine import ServeError
    from tsspark_tpu_torch.serve.registry import RegistryError

    def export_metrics():
        METRICS.export(
            os.path.join(metrics_dir or ".", "metrics_daemon.json"),
            trace_id=obs.trace_id(),
        )

    last_export = 0.0
    if metrics_every is not None:
        export_metrics()  # a watcher sees a snapshot before traffic
        last_export = time.monotonic()
    for line in (lines if lines is not None else sys.stdin):
        line = line.strip()
        if not line:
            continue
        if (metrics_every is not None
                and time.monotonic() - last_export >= metrics_every):
            export_metrics()
            last_export = time.monotonic()
        try:
            msg = json.loads(line)
        except ValueError as e:
            emit({"ok": False,
                  "error": {"type": "BadRequest", "detail": str(e)}})
            continue
        rid = msg.get("id")
        try:
            cmd = msg.get("cmd")
            if cmd == "stats":
                emit({"ok": True, "id": rid,
                      "stats": engine.stats.snapshot(),
                      "cache": engine.cache.stats(),
                      "active_version": registry.active_version()})
                continue
            if cmd == "metrics":
                # Prometheus text over the request channel.
                emit({"ok": True, "id": rid,
                      "prometheus": METRICS.to_prometheus()})
                continue
            if cmd == "activate":
                registry.activate(int(msg["version"]))
                emit({"ok": True, "id": rid,
                      "active_version": registry.active_version()})
                continue
            if cmd == "rollback":
                v = registry.rollback()
                emit({"ok": True, "id": rid, "active_version": v})
                continue
            deadline_ms = msg.get("deadline_ms")
            tr = msg.get("trace") or {}
            ctx = (obs.remote_context(tr.get("trace_id"),
                                      tr.get("parent_span_id"))
                   if tr else contextlib.nullcontext())
            with ctx:
                res = engine.forecast(
                    msg["series_ids"], int(msg["horizon"]),
                    num_samples=int(msg.get("num_samples", 0)),
                    seed=int(msg.get("seed", 0)),
                    deadline_in_s=(None if deadline_ms is None
                                   else float(deadline_ms) / 1e3),
                )
            emit({
                "ok": True, "id": rid, "version": res.version,
                "series_ids": list(res.series_ids),
                "latency_ms": round(res.latency_s * 1e3, 3),
                "ds": np.asarray(res.ds).tolist(),
                **{k: np.asarray(v).tolist()
                   for k, v in res.values.items()},
            })
        except (ServeError, RegistryError) as e:
            err = (e.to_dict() if isinstance(e, ServeError)
                   else {"type": "RegistryError", "reason": e.reason,
                         "detail": str(e)})
            emit({"ok": False, "id": rid, "error": err})
        except (KeyError, TypeError, ValueError) as e:
            emit({"ok": False, "id": rid,
                  "error": {"type": "BadRequest", "detail": str(e)}})
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tsspark_tpu_torch.serve",
        description="forecast serving daemon / load generator",
    )
    ap.add_argument("--registry", default=None,
                    help="registry root (daemon: required; loadgen: "
                    "reused when it exists, else built synthetic)")
    ap.add_argument("--loadgen", type=int, default=None, metavar="N",
                    help="replay a synthetic mix of N requests and "
                    "emit a SERVE_*.json report")
    ap.add_argument("--pool", type=int, default=None, metavar="R",
                    help="loadgen: drive R replica processes behind "
                    "the sharding pool front instead of one in-process "
                    "engine")
    ap.add_argument("--pool-clients", type=int, default=None,
                    metavar="T",
                    help="pool loadgen: client threads (default: "
                    "min(8, 2*R))")
    ap.add_argument("--dir", default=None,
                    help="loadgen scratch root (default: cwd)")
    ap.add_argument("--report", default=None,
                    help="loadgen report path (default: SERVE_<unix>.json)")
    ap.add_argument("--history", default=None,
                    help="loadgen: the sentinel's run-history file "
                    "(default: RUNHISTORY.jsonl in the working "
                    "directory); its REGRESSION_*.json verdict goes "
                    "beside it")
    ap.add_argument("--series", type=int, default=48,
                    help="loadgen synthetic series count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-root", default=None,
                    help="columnar data-plane root the loadgen demo "
                    "dataset is cached under (default: the shared "
                    "plane root, data.plane.default_root)")
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--cache-capacity", type=int, default=None,
                    help="forecast-cache entries per engine (default: "
                    "$TSSPARK_SERVE_CACHE_CAPACITY, else 8192)")
    ap.add_argument("--metrics-every", type=float, default=None,
                    metavar="N",
                    help="daemon: export an atomic metrics_daemon.json "
                    "snapshot next to the registry at most every N "
                    "seconds")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; $TSSPARK_SERVE_DEVICE "
                    "when the flag is absent")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.device = (args.device or os.environ.get("TSSPARK_SERVE_DEVICE")
                   or None)
    # The kernel bank first: nothing may load the library before it.
    from tsspark_tpu_torch.serve import aotbank

    aotbank.arm_from_env()
    if args.loadgen is not None:
        if args.pool:
            return _pool_loadgen(args)
        return _loadgen(args)
    if not args.registry:
        ap.error("daemon mode needs --registry (or pass --loadgen N)")
    return _daemon(args)


if __name__ == "__main__":
    sys.exit(main())
