"""Streaming dataset ingestion: produce plane shards ahead of consumers.

The port's copy of the JAX package's ``data/ingest.py``.  ``run_ingest``
fills a :mod:`tsspark_tpu_torch.data.plane` dataset shard by shard --
serially or on a process pool -- landing each shard's sentinel the
moment its rows are durable, so consumers gated on
``plane.ready_coverage`` start work while later shards are still
generating.  ``IngestDriver`` runs the whole thing as a detached
background process for callers that must stay on their own critical
path (``chip_smoke.py`` ingests the M5 fleet beside its card phases):
generation overlaps fitting instead of preceding it.

Torch-free and JAX-free by construction (pure numpy): a process that
holds a CUDA context never has to be forked for data production, and a
wedged accelerator runtime can never block it.

CLI::

    python -m tsspark_tpu_torch.data.ingest --generator m5 --series 30490 \
        --timesteps 1941 [--seed 2] [--shard-rows 1024] [--root DIR] \
        [--processes N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from tsspark_tpu_torch.data import plane
from tsspark_tpu_torch.io import atomic_write
from tsspark_tpu_torch.obs import context as obs

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))
))

INGEST_REPORT = "ingest_report.json"


def _fork_unsafe() -> bool:
    """True when this process has JAX loaded or torch's CUDA context
    initialised: pool workers must then start by spawn, not fork."""
    if "jax" in sys.modules:
        return True
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    return bool(cuda is not None and cuda.is_initialized())


def _pool_init(env_blob: Optional[str]) -> None:
    """Process-pool worker init: adopt the parent's trace so every
    ``datagen.shard`` span joins the run (fork already inherits the
    binding; this also covers spawn-start platforms)."""
    if env_blob:
        os.environ[obs.ENV_VAR] = env_blob
        obs.adopt_env()


def _shard_job(spec_dict: Dict, root: Optional[str], index: int) -> float:
    t0 = time.time()
    plane.write_shard(plane.DatasetSpec.from_dict(spec_dict), index,
                      root=root)
    return time.time() - t0


def run_ingest(spec: plane.DatasetSpec, root: Optional[str] = None,
               processes: int = 0) -> str:
    """Ingest every still-missing shard of ``spec`` and finalize the
    manifest.  Resumable: a previous crashed ingest's landed shards are
    kept (sentinel-gated), only the holes are produced.  Returns the
    dataset dir and leaves an ``ingest_report.json`` beside the data
    (the overlap accounting: wall, first and last shard's times)."""
    t0 = time.time()
    plane.sweep_stale_datasets(root)  # cold path: reap superseded keys
    dset_dir = plane.create_columns(spec, root)
    missing = plane.missing_shards(spec, root)
    span = obs.open_span("datagen.ingest", generator=spec.generator,
                         n_series=spec.n_series, shards=len(missing))
    t_first = t_last = None
    if len(missing) > 1 and processes and processes > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        env_blob = None
        if obs.active():
            env: Dict[str, str] = {}
            obs.inject_env(env, parent_id=span)
            env_blob = env.get(obs.ENV_VAR)
        # Forking a process that holds a CUDA context (or JAX's
        # runtime threads) is unsafe; the IngestDriver subprocess is
        # numpy-only so its pool forks, but an in-process caller that
        # did either gets spawn-start workers -- _pool_init re-adopts
        # the trace either way.
        ctx = multiprocessing.get_context(
            "spawn" if _fork_unsafe() else None
        )
        with ProcessPoolExecutor(
            max_workers=min(processes, len(missing)),
            initializer=_pool_init, initargs=(env_blob,),
            mp_context=ctx,
        ) as pool:
            futs = [
                pool.submit(_shard_job, spec.to_dict(), root, i)
                for i in missing
            ]
            # Completion order, not submission order: shard 0 being the
            # slowest must not overstate first_shard_s.
            for f in as_completed(futs):
                f.result()
                now = time.time()
                t_first = t_first or now
                t_last = now
    else:
        for i in missing:
            plane.write_shard(spec, i, root=root)
            now = time.time()
            t_first = t_first or now
            t_last = now
    plane.finalize(spec, root)
    obs.close_span(span, "datagen.ingest", t0, shards=len(missing))
    wall = time.time() - t0
    report = {
        "generator": spec.generator, "n_series": spec.n_series,
        "n_timesteps": spec.n_timesteps, "shards_produced": len(missing),
        "shards_total": len(plane.shard_ranges(spec)),
        "processes": int(processes or 1),
        "wall_s": round(wall, 3),
        "first_shard_s": round((t_first - t0), 3) if t_first else 0.0,
        "last_shard_s": round((t_last - t0), 3) if t_last else 0.0,
        "unix": round(time.time(), 3),
    }
    atomic_write(
        os.path.join(dset_dir, INGEST_REPORT),
        lambda fh: json.dump(report, fh, indent=1), mode="w",
    )
    return dset_dir


def read_ingest_report(dset_dir: str) -> Optional[Dict]:
    try:
        with open(os.path.join(dset_dir, INGEST_REPORT)) as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


class IngestDriver:
    """A background ingest subprocess (the overlap producer).

    The child is plain ``python -m tsspark_tpu_torch.data.ingest``: it
    imports neither torch nor JAX, so it never shares the spawner's
    CUDA context, and its ``datagen.shard`` spans join the spawner's
    trace through the injected ``TSSPARK_TRACE`` env.  The caller
    consumes ``plane.ready_coverage`` while this runs, checks
    ``wait()``'s exit code (a child that died is a failed ingest), and
    must ``kill()`` it on the way out like any other worker child."""

    def __init__(self, spec: plane.DatasetSpec, proc: subprocess.Popen,
                 root: Optional[str]):
        self.spec = spec
        self.proc = proc
        self.dataset_dir = plane.dataset_dir(spec, root)

    @classmethod
    def start(cls, spec: plane.DatasetSpec, root: Optional[str] = None,
              processes: Optional[int] = None,
              log_stream=None) -> "IngestDriver":
        if processes is None:
            processes = max(1, (os.cpu_count() or 2) - 1)
        # Columns are preallocated HERE, synchronously, so a consumer
        # spawned the instant this returns always finds a valid plane
        # dir (spec.json + calendar + column files) — only shard
        # coverage, never dir existence, gates it.  Cheap: a 1-row
        # probe plus sparse-file preallocation.
        plane.create_columns(spec, root)
        env = dict(os.environ)
        parts = [_REPO_ROOT] + (
            [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []
        )
        env["PYTHONPATH"] = os.pathsep.join(parts)
        obs.inject_env(env)
        cmd = [
            sys.executable, "-m", "tsspark_tpu_torch.data.ingest",
            "--generator", spec.generator,
            "--series", str(spec.n_series),
            "--timesteps", str(spec.n_timesteps),
            "--seed", str(spec.seed),
            "--shard-rows", str(spec.shard_rows),
            "--processes", str(processes),
        ]
        if root:
            cmd += ["--root", root]
        proc = subprocess.Popen(cmd, stdout=log_stream or sys.stderr,
                                stderr=log_stream or sys.stderr, env=env)
        return cls(spec, proc, root)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="produce plane dataset shards (numpy-only)"
    )
    ap.add_argument("--generator", required=True)
    ap.add_argument("--series", type=int, required=True)
    ap.add_argument("--timesteps", type=int, required=True)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--shard-rows", type=int,
                    default=plane.DEFAULT_SHARD_ROWS)
    ap.add_argument("--root", default=None)
    ap.add_argument("--processes", type=int, default=1)
    args = ap.parse_args(argv)
    obs.adopt_env()
    spec = plane.DatasetSpec(
        generator=args.generator, n_series=args.series,
        n_timesteps=args.timesteps, seed=args.seed,
        shard_rows=args.shard_rows,
    )
    dset_dir = run_ingest(spec, root=args.root, processes=args.processes)
    print(f"[ingest] {spec.cache_key()} complete -> {dset_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
