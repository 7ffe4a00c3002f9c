"""Incremental delta-refit cycle: refit cost scales with CHANGED series (the
port's copy of the JAX package's ``refit.py``, its cycle; the churn-sweep
bench comes with the port's benches).

One ``run_refit`` cycle:

1. **detect**: the data plane's row-advance accounting
   (``data.plane.advanced_since``): the active registry version records
   the delta coverage stamp it was fitted at
   (``ParamRegistry.version_stamp``), and the changed set is exactly the
   rows of every delta landed after it.  The set is pinned in an atomic
   ``refit_plan.json`` (the JAX package's format: either package resumes
   the other's plan) so a killed cycle's successor refits the SAME plan
   instead of racing fresh deltas.
2. **plan + fit**: the changed rows are compacted into a dense
   ``[0, n_changed)`` claim space and run through the resident path
   (``tsspark_tpu_torch.resident``) over a gathered spill: the same
   ``plan_chunks`` / lease / chunk-file machinery, so 10% churn runs ~10%
   of the waves and a killed cycle resumes from its landed flushes.
   Waves are warm-started from the active snapshot's theta, gathered per
   wave off the snapshot plane (``warm_theta_gather``: only the touched
   pages are read).  ``warm_start=False`` is bitwise the cold resident
   path.  With no usable mesh (one card) ``run_resident`` falls back, with
   one warning, to the cold chunk-file protocol, as the reference does on
   a one-device host: the cycle's fit is then bitwise a cold
   ``run_resilient`` of its spill, whatever ``warm_start`` says.
3. **delta publish**: ``ParamRegistry.publish_delta`` /
   ``snapplane.write_plane_delta``: the new version's plane copy-forwards
   unchanged rows from the active plane; a column no changed row lands
   in (EVERY column on a zero-delta cycle) is hardlinked, zero new bytes.
   The forecast plane (K1) and, when the base has an ADVI posterior, the
   posterior of the changed rows (K3's draw stack and K7) and the
   quantile plane follow as delta publishes.
4. **flip**: ``ReplicaPool.activate`` when a pool is attached, else
   ``flip_fn``, else ``registry.activate``; a flip carries unchanged
   series' forecast-cache entries forward (``ForecastCache.
   carry_forward``).

``device``: where the fit, the posterior advance and the planes' forecasts
run (``None``: the card, raising without one; ``"cpu"`` on request).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.io import atomic_write
from tsspark_tpu_torch.obs import context as obs

#: The cycle's pinned plan: base version, coverage stamps, the changed row
#: set, replaced atomically.
REFIT_PLAN_FILE = "refit_plan.json"

#: Spill-set visibility marker inside a cycle dir, written LAST: each
#: spill column is atomic on its own but the SET is not.
SPILL_OK_FILE = "spillok.json"


def warm_theta_gather(theta, idx):
    """Warm-start gather: rows ``idx`` of the active snapshot's theta as
    float32, NaN / inf scrubbed (a warm INIT must never smuggle a poison
    value into the solver).  A host array (the snapshot plane's memmap)
    and a CPU tensor over it both read only the touched pages; a tensor
    comes back as a tensor.  The cast comes before the scrub, so a wider
    input's inf becomes float32's largest finite value, not inf (the
    reference scrubs first: a float64 inf comes back inf there)."""
    if isinstance(theta, np.ndarray):
        rows = np.take(np.asarray(theta), np.asarray(idx, np.int64), axis=0)
        with np.errstate(over="ignore"):
            return np.nan_to_num(rows.astype(np.float32))
    import torch

    ix = torch.as_tensor(np.asarray(idx, np.int64), device=theta.device)
    return torch.nan_to_num(theta.index_select(0, ix).to(torch.float32))


def read_refit_plan(scratch: str) -> Optional[Dict]:
    """The pinned plan in ``scratch``, or None (absent / torn)."""
    try:
        with open(os.path.join(scratch, REFIT_PLAN_FILE)) as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


def _write_refit_plan(scratch: str, plan: Dict) -> None:
    atomic_write(
        os.path.join(scratch, REFIT_PLAN_FILE),
        lambda fh: json.dump(plan, fh), mode="w",
    )


# ---------------------------------------------------------------------------
# cycle stages (a scheduler pipelines these; run_refit composes them)
# ---------------------------------------------------------------------------


def draft_plan(data_dir: str, base_stamp: int,
               base_version: Optional[int] = None) -> Dict:
    """An IN-MEMORY cycle plan against a coverage stamp; ``base_version``
    may stay None until :func:`pin_drafted` adopts it."""
    from tsspark_tpu_torch.data import plane

    plan_stamp = plane.delta_seq(data_dir)
    changed = plane.advanced_since(data_dir, int(base_stamp))
    return {
        "base_version": (None if base_version is None
                         else int(base_version)),
        "base_stamp": int(base_stamp),
        "plan_stamp": int(plan_stamp),
        "n_changed": int(len(changed)),
        "changed_rows": [int(r) for r in changed.tolist()],
        "complete": False,
    }


def pin_drafted(scratch: str, plan: Dict, base_version: int) -> Dict:
    """Adopt a drafted plan's base version and pin it to disk."""
    plan = dict(plan, base_version=int(base_version))
    _write_refit_plan(scratch, plan)
    return plan


def resolve_plan(data_dir: str, registry, scratch: str,
                 base_version: int) -> tuple:
    """(plan, resumed): resume the pinned plan when it is incomplete and
    its base is usable: the active version, a draft pinned before its
    base version existed (matched by base STAMP), or a published but not
    yet active version whose stamp the plan was drafted against (a front
    elsewhere owns the flip and the publisher died between publish and
    flip), provided the plan covers at least the active version's data
    stamp.  Else pin a fresh detect against ``base_version``."""
    plan = read_refit_plan(scratch)
    active_stamp = int(registry.version_stamp(int(base_version)))
    if plan is not None and not plan.get("complete"):
        pv = plan.get("base_version")
        if pv == int(base_version):
            return plan, True
        if pv is None and plan.get("base_stamp") == active_stamp:
            return pin_drafted(scratch, plan, base_version), True
        if pv is not None:
            try:
                pv_stamp = int(registry.version_stamp(int(pv)))
            except Exception:
                pv_stamp = None  # base vanished: fall through to detect
            if (pv_stamp == plan.get("base_stamp")
                    and int(plan.get("plan_stamp", -1)) >= active_stamp):
                return plan, True
    plan = draft_plan(data_dir, active_stamp, base_version=int(base_version))
    _write_refit_plan(scratch, plan)
    return plan, False


def cycle_paths(scratch: str, plan: Dict) -> tuple:
    """(cycle_dir, spill data dir, fit out dir) for a plan, keyed by the
    STAMP pair so a draft's paths never move when its version is pinned."""
    cycle_dir = os.path.join(
        scratch,
        f"cycle_b{plan['base_stamp']:06d}_s{plan['plan_stamp']:06d}",
    )
    return (cycle_dir, os.path.join(cycle_dir, "delta_data"),
            os.path.join(cycle_dir, "out"))


def ensure_spill(data_dir: str, plan: Dict, scratch: str) -> str:
    """Gather the plan's changed rows into the cycle's spill dir
    (idempotent: ``SPILL_OK_FILE`` is the unit of visibility).  Pure mmap
    reads.  Returns the spill dir."""
    from tsspark_tpu_torch.data import plane

    cycle_dir, ddir, _out = cycle_paths(scratch, plan)
    marker = os.path.join(cycle_dir, SPILL_OK_FILE)
    if os.path.exists(marker):
        return ddir
    os.makedirs(cycle_dir, exist_ok=True)
    changed = np.asarray(plan["changed_rows"], np.int64)
    batch = plane.open_batch(data_dir)
    sub = lambda a: (None if a is None  # noqa: E731
                     else np.ascontiguousarray(a[changed]))
    orchestrate.spill_data(
        ddir, np.asarray(batch.ds), sub(batch.y),
        mask=sub(batch.mask), regressors=sub(batch.regressors),
        cap=sub(batch.cap),
    )
    atomic_write(
        marker,
        lambda fh: json.dump({"n_changed": int(plan["n_changed"]),
                              "unix": round(time.time(), 3)}, fh),
        mode="w",
    )
    return ddir


def fit_changed(
    data_dir: str,
    registry,
    plan: Dict,
    scratch: str,
    *,
    chunk: int,
    solver_config,
    phase1_iters: int = 0,
    no_phase1_tune: bool = True,
    warm_start: bool = True,
    theta_cache: Optional[Dict] = None,
    deadline: Optional[float] = None,
    device=None,
    mesh=None,
) -> Dict:
    """The exclusive stage: spill (if not prefetched), warm-gather, and run
    the changed set through ``resident.run_resident`` (``mesh``: its
    mesh; None takes the default one, or the file-protocol fallback).
    Returns a dict with ``complete``, ``fit_s``, ``fit_dispatches``,
    ``fit_path``, ``state_sub``, ``step_sub`` and ``warm_cache_hits``.

    ``theta_cache``: pre-gathered warm-init rows ``{"base_stamp": int,
    "rows": sorted int64 array, "theta": float32 (k, P)}``, consulted
    only when its ``base_stamp`` is the plan's; rows it misses fall back
    to the per-wave plane gather.  Its values are the base plane's bits,
    so a hit changes no numerics."""
    from tsspark_tpu_torch import resident
    from tsspark_tpu_torch.serve import snapplane

    changed = np.asarray(plan["changed_rows"], np.int64)
    n_changed = int(plan["n_changed"])
    ddir = ensure_spill(data_dir, plan, scratch)
    _cycle_dir, _ddir, out_dir = cycle_paths(scratch, plan)
    os.makedirs(out_dir, exist_ok=True)
    orchestrate.save_run_config(out_dir, registry.config, solver_config)

    cache_rows = cache_theta = None
    if (warm_start and theta_cache is not None
            and int(theta_cache.get("base_stamp", -1))
            == int(plan["base_stamp"])
            and len(theta_cache.get("rows", ()))):
        cache_rows = np.asarray(theta_cache["rows"], np.int64)
        cache_theta = np.asarray(theta_cache["theta"], np.float32)
    hits = {"n": 0}

    theta0_fn = None
    base_view = None
    theta_mm = None
    if warm_start:
        base_vdir = registry.version_dir(int(plan["base_version"]))
        try:
            # verify=False: the registry CRC-swept this plane when it was
            # loaded for serving, and a warm INIT cannot affect
            # correctness (warm_theta_gather scrubs non-finite values).
            base_view = snapplane.attach(base_vdir, verify=False)
            theta_mm = base_view.state.theta
        except snapplane.SnapshotPlaneError:
            import warnings

            warnings.warn(
                f"refit: base version {plan['base_version']} has no "
                "readable snapshot plane; warm start disabled for this "
                "cycle (cold ridge init: results stay correct, the "
                "warm-start lever is lost)",
                RuntimeWarning,
            )
    if theta_mm is not None:
        def gather(rows):
            return np.asarray(warm_theta_gather(theta_mm, rows), np.float32)

        def theta0_fn(lo, hi):
            rows = changed[lo:hi]
            if cache_rows is None:
                return gather(rows)
            pos = np.minimum(np.searchsorted(cache_rows, rows),
                             len(cache_rows) - 1)
            hit = cache_rows[pos] == rows
            if not hit.any():
                return gather(rows)
            out = np.empty((len(rows), cache_theta.shape[1]), np.float32)
            out[hit] = cache_theta[pos[hit]]
            if not hit.all():
                out[~hit] = gather(rows[~hit])
            hits["n"] += int(hit.sum())
            return np.nan_to_num(out)

    chunks_before = len(orchestrate.completed_ranges(out_dir))
    t0 = time.time()
    fit_state = resident.run_resident(
        data_dir=ddir, out_dir=out_dir, series=n_changed,
        chunk=int(chunk), phase1_iters=phase1_iters,
        no_phase1_tune=no_phase1_tune, autotune=False,
        deadline=deadline, theta0_fn=theta0_fn, device=device, mesh=mesh,
    )
    out: Dict = {
        "complete": bool(fit_state.get("complete")),
        "fit_s": round(time.time() - t0, 3),
        "fit_path": fit_state.get("fit_path"),
        "fit_dispatches": (len(orchestrate.completed_ranges(out_dir))
                           - chunks_before),
        "warm_cache_hits": hits["n"],
        "state_sub": None,
        "step_sub": None,
    }
    if not out["complete"]:
        return out
    out["state_sub"] = orchestrate.load_fit_state(out_dir, n_changed)
    if base_view is not None and "step" in base_view.extras:
        out["step_sub"] = np.asarray(
            base_view.extras["step"][changed], np.float64
        )
    return out


def reap_cycles(scratch: str, keep: Sequence[str] = ()) -> None:
    """Remove completed cycle dirs, sparing the in-flight dirs named."""
    keep_abs = {os.path.abspath(k) for k in keep}
    try:
        names = os.listdir(scratch)
    except OSError:
        return
    for name in names:
        d = os.path.join(scratch, name)
        if (name.startswith("cycle_")
                and os.path.abspath(d) not in keep_abs):
            shutil.rmtree(d, ignore_errors=True)


def posterior_seed(seed: int, version: int) -> int:
    """The posterior advance's generator seed: deterministic per (base
    seed, new version), decorrelated across cycles (the counterpart of
    the reference's ``fold_in(PRNGKey(seed), version)``)."""
    return int(np.random.SeedSequence(
        (int(seed), int(version))).generate_state(1)[0])


def _advance_posterior(registry, plan, state_sub, changed, scratch,
                       v_new, device=None) -> bool:
    """Delta-cycle ADVI posterior advance: re-fit the changed rows'
    variational posteriors (warm from the cycle's fresh MAP theta, over
    the cycle's spilled data: K3's draw stack and K7 on the card) and
    copy the rest forward from the base version's posterior.  Without it
    a delta flip would drop the fleet from the ADVI tier to MAP.

    Returns True when a posterior landed in ``v_new``'s version dir;
    False when the base has none, the config is outside the ADVI family,
    or the fleet grew past the posterior's rows."""
    import torch

    from tsspark_tpu_torch.config import AdviConfig
    from tsspark_tpu_torch.device import resolve_device
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    base_loaded = advi_mod.load_posterior(
        registry.version_dir(int(plan["base_version"])))
    if base_loaded is None:
        return False
    base_post, header = base_loaded
    config = registry.config
    if not qplane._advi_eligible(config):
        return False
    n_base = int(np.asarray(base_post.mu).shape[0])
    if len(changed) and int(changed.max()) >= n_base:
        return False

    _cycle_dir, ddir, _out = cycle_paths(scratch, plan)
    load = lambda name: (np.load(os.path.join(ddir, name))  # noqa: E731
                         if os.path.exists(os.path.join(ddir, name))
                         else None)
    ds, y = np.load(os.path.join(ddir, "ds.npy")), load("y.npy")
    data, _meta = prepare_fit_data(
        ds, y, config, mask=load("mask.npy"), cap=load("cap.npy"),
    )
    seed = int(header.get("seed", 0))
    num_steps = int(header.get("num_steps", 0)) or None
    advi_cfg = (AdviConfig(num_steps=num_steps) if num_steps
                else AdviConfig())
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(
        posterior_seed(seed, v_new))
    sub = advi_mod.fit_advi(
        np.asarray(state_sub.theta, np.float32), data, gen, config,
        advi_cfg, device=dev,
    )
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    mu = np.array(base_post.mu, np.float32)
    rho = np.array(base_post.rho, np.float32)
    elbo = np.array(base_post.elbo, np.float32)
    mu[changed] = host(sub.mu)
    rho[changed] = host(sub.rho)
    elbo[changed] = host(sub.elbo)
    advi_mod.save_posterior(
        registry.version_dir(int(v_new)),
        advi_mod.AdviPosterior(mu=mu, rho=rho, elbo=elbo),
        seed=seed, num_steps=advi_cfg.num_steps,
    )
    return True


def publish_plan(
    registry,
    plan: Dict,
    state_sub,
    step_sub,
    scratch: str,
    *,
    pool=None,
    flip_fn: Optional[Callable[[int], None]] = None,
    activate: bool = True,
    hot_series: Optional[Sequence[str]] = None,
    horizons: Sequence[int] = (7, 14),
    reap: bool = True,
    device=None,
) -> Dict:
    """Copy-forward delta publish + flip + mark the plan complete.
    Returns ``{"version", "publish_s", "flip_s", "flipped", "fplane",
    "qplane"}``.  The forecast and quantile planes are best-effort: a
    failure there sheds to the compute path and never fails the flip."""
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.serve import fplane
    from tsspark_tpu_torch.uncertainty import qplane

    changed = np.asarray(plan["changed_rows"], np.int64)
    t0 = time.time()
    v_new = registry.publish_delta(
        state_sub, changed, base_version=int(plan["base_version"]),
        step_sub=step_sub, data_stamp=plan["plan_stamp"],
        activate=False,
    )
    backend = get_backend("cuda", registry.config, SolverConfig(),
                          device=device)
    # Forecast-plane copy-forward BEFORE the flip: unchanged series'
    # columns hardlink / scatter from the base plane, only the refit rows
    # recompute (K1), and replicas refreshing onto v_new adopt the plane
    # at once.
    try:
        fpub = fplane.maybe_publish(registry, int(v_new), backend,
                                    horizons=tuple(horizons))
    except Exception as e:
        fpub = None
        obs.event("fplane.publish_failed", version=int(v_new),
                  error=repr(e))
    qpub = None
    try:
        _advance_posterior(registry, plan, state_sub, changed, scratch,
                           int(v_new), device=device)
        qpub = qplane.maybe_publish(registry, int(v_new), backend,
                                    horizons=tuple(horizons))
    except Exception as e:
        obs.event("qplane.publish_failed", version=int(v_new),
                  error=repr(e))
    publish_s = round(time.time() - t0, 3)

    t0 = time.time()
    if pool is not None:
        pool.activate(v_new, hot_series=list(hot_series or ()),
                      horizons=tuple(horizons))
    elif flip_fn is not None:
        flip_fn(int(v_new))
    elif activate:
        registry.activate(int(v_new))
    flip_s = round(time.time() - t0, 3)

    _write_refit_plan(scratch, dict(plan, complete=True,
                                    published_version=int(v_new)))
    if reap:
        reap_cycles(scratch)
    return {
        "version": int(v_new),
        "publish_s": publish_s,
        "flip_s": flip_s,
        "flipped": bool(pool is not None or flip_fn is not None
                        or activate),
        "fplane": None if fpub is None else fpub.get("status"),
        "qplane": None if qpub is None else qpub.get("status"),
    }


def run_refit(
    *,
    data_dir: str,
    registry,
    scratch: str,
    chunk: int = 512,
    solver_config=None,
    phase1_iters: int = 0,
    no_phase1_tune: bool = True,
    warm_start: bool = True,
    pool=None,
    hot_series: Optional[Sequence[str]] = None,
    horizons: Sequence[int] = (7, 14),
    activate: bool = True,
    flip_fn: Optional[Callable[[int], None]] = None,
    deadline: Optional[float] = None,
    theta_cache: Optional[Dict] = None,
    device=None,
    mesh=None,
) -> Dict:
    """One delta-refit cycle: detect -> resident fit over the changed set
    -> copy-forward delta publish -> flip.  Returns the cycle's metrics
    dict (versions, per-stage walls, dispatch count, ``fit_path``).

    ``registry`` is a ``ParamRegistry`` with an ACTIVE version whose
    snapshot plane exists.  ``scratch`` persists across cycles: the plan
    plus a per-(stamp pair) cycle dir whose chunk files make a killed
    cycle resumable.  ``activate=False`` publishes without flipping (a
    pool front owns the flip).  Zero-delta fast path: no advanced series
    -> zero fit dispatches and a fully hardlinked version."""
    from tsspark_tpu_torch.config import SolverConfig

    t_cycle0 = time.time()
    os.makedirs(scratch, exist_ok=True)
    if solver_config is None:
        solver_config = SolverConfig()
    base_version = registry.active_version()
    if base_version is None:
        from tsspark_tpu_torch.serve.registry import RegistryError

        raise RegistryError("no-active-version",
                            "delta refit needs an active base version")

    t0 = time.time()
    plan, resumed = resolve_plan(data_dir, registry, scratch,
                                 int(base_version))
    n_changed = int(plan["n_changed"])
    detect_s = time.time() - t0
    obs.record("refit.detect", t0, detect_s, n_changed=n_changed,
               base_version=int(base_version), resumed=resumed)

    result: Dict = {
        "base_version": int(plan["base_version"]),
        "base_stamp": plan["base_stamp"],
        "plan_stamp": plan["plan_stamp"],
        "n_changed": n_changed,
        "resumed": resumed,
        "warm_start": bool(warm_start),
        "detect_s": round(detect_s, 3),
        "fit_dispatches": 0,
        "fit_s": 0.0,
    }

    state_sub = None
    step_sub = None
    if n_changed:
        fit_res = fit_changed(
            data_dir, registry, plan, scratch, chunk=int(chunk),
            solver_config=solver_config, phase1_iters=phase1_iters,
            no_phase1_tune=no_phase1_tune, warm_start=warm_start,
            theta_cache=theta_cache, deadline=deadline, device=device,
            mesh=mesh,
        )
        result["fit_s"] = fit_res["fit_s"]
        result["fit_path"] = fit_res["fit_path"]
        result["fit_dispatches"] = fit_res["fit_dispatches"]
        if fit_res["warm_cache_hits"]:
            result["warm_cache_hits"] = fit_res["warm_cache_hits"]
        if not fit_res["complete"]:
            result["complete"] = False
            result["wall_s"] = round(time.time() - t_cycle0, 3)
            return result
        state_sub = fit_res["state_sub"]
        step_sub = fit_res["step_sub"]

    pub = publish_plan(
        registry, plan, state_sub, step_sub, scratch,
        pool=pool, flip_fn=flip_fn, activate=activate,
        hot_series=hot_series, horizons=horizons, device=device,
    )
    result.update(pub)
    result["complete"] = True
    result["wall_s"] = round(time.time() - t_cycle0, 3)
    obs.record("refit.cycle", t_cycle0, result["wall_s"],
               n_changed=n_changed, version=result.get("version"),
               warm_start=bool(warm_start))
    return result


# ---------------------------------------------------------------------------
# CLI (python -m tsspark_tpu_torch.refit): one cycle as a killable process
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one delta-refit cycle as its own process (the unit a chaos run
    kills mid delta-publish).  Adopts the spawner's trace.  ``--device
    cpu`` asks for the CPU and forces the virtual host mesh, as the
    reference's CLI forces its virtual CPU mesh; with no ``--device`` the
    cycle runs on the card."""
    ap = argparse.ArgumentParser(prog="python -m tsspark_tpu_torch.refit")
    ap.add_argument("--data", help="plane dataset dir")
    ap.add_argument("--registry", help="serve registry root")
    ap.add_argument("--scratch", help="refit scratch dir")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--max-iters", type=int, default=20)
    ap.add_argument("--phase1-iters", type=int, default=0)
    ap.add_argument("--cold", action="store_true",
                    help="disable the warm start (bitwise the cold "
                         "resident path over the changed set)")
    ap.add_argument("--no-activate", action="store_true",
                    help="publish without flipping (a pool front owns "
                         "the flip)")
    ap.add_argument("--delta-bench", default=None, metavar="RUNG",
                    help="the churn-fraction sweep (not ported yet)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.delta_bench:
        # The sweep comes with the port's benches; it must never run
        # something else in its place.
        print("tsspark_tpu_torch.refit: --delta-bench (the churn-fraction "
              "sweep) is not ported yet", file=sys.stderr)
        return 2
    if not (args.data and args.registry and args.scratch):
        ap.error("--data, --registry and --scratch are required for a "
                 "refit cycle")
    if args.device == "cpu":
        from tsspark_tpu_torch.parallel.mesh import force_virtual_host_mesh

        force_virtual_host_mesh()
    obs.adopt_env()
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    registry = ParamRegistry.open(args.registry)
    res = run_refit(
        data_dir=args.data, registry=registry, scratch=args.scratch,
        chunk=args.chunk,
        solver_config=SolverConfig(max_iters=args.max_iters),
        phase1_iters=args.phase1_iters,
        warm_start=not args.cold,
        activate=not args.no_activate,
        device=args.device,
    )
    print(json.dumps(res), flush=True)
    return 0 if res.get("complete") else 1


if __name__ == "__main__":
    sys.exit(main())
