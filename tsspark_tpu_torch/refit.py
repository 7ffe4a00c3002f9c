"""Incremental delta-refit cycle: refit cost scales with CHANGED series (the
port's copy of the JAX package's ``refit.py``: the cycle, and the
churn-sweep bench ``run_delta_bench`` with its reusable cold base).

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
from typing import Callable, Dict, List, Optional, Sequence

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

#: Reused cold-reference record (``run_delta_bench(reuse_cold=)`` /
#: ``sched.run_freshness_bench``): the measured cold fit+publish walls
#: plus the shape/fingerprint identity that makes reuse safe.
COLD_META_FILE = "cold_meta.json"


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
# reusable cold reference (bench --delta/--freshness --reuse-cold)
# ---------------------------------------------------------------------------


def load_cold_meta(base_dir: str, rung) -> Optional[Dict]:
    """The recorded cold fit+publish reference under ``base_dir``, or
    None when absent or not reusable for this rung (shape or data
    fingerprint mismatch, or the cold out dir lost its coverage)."""
    from tsspark_tpu_torch.data import plane

    try:
        with open(os.path.join(base_dir, COLD_META_FILE)) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict):
        return None
    if (meta.get("series") != rung.series
            or meta.get("timesteps") != rung.timesteps
            or meta.get("fingerprint") != plane.dataset_fingerprint()):
        return None
    out_dir = os.path.join(base_dir, "cold_out")
    done = sum(hi - lo for lo, hi
               in orchestrate.completed_ranges(out_dir))
    if done < rung.series:
        return None
    return dict(meta, out_dir=out_dir)


def save_cold_meta(base_dir: str, meta: Dict) -> None:
    atomic_write(
        os.path.join(base_dir, COLD_META_FILE),
        lambda fh: json.dump(meta, fh, indent=1), mode="w",
    )


def cold_base(rung, cfg, solver, run_dir: str, dset_dir: str,
              reuse_cold: Optional[str] = None, device=None,
              mesh=None) -> Dict:
    """The sweep's cold reference: a complete resident fit of the rung
    plus the measured fit wall.  With ``reuse_cold`` pointing at a
    prior run's base dir, the recorded measurement (and the fitted
    chunk files) are reused instead of re-fitting the whole rung on
    every invocation — the amortization churn sweeps and the freshness
    bench ride.  Returns ``{"out_dir", "fit_s", "publish_s" (None when
    the caller must measure its own publish), "fit_path", "reused"}``.
    ``device`` / ``mesh``: the resident fit's, as ``run_refit`` takes
    them."""
    from tsspark_tpu_torch import resident
    from tsspark_tpu_torch.data import plane

    if reuse_cold:
        meta = load_cold_meta(reuse_cold, rung)
        if meta is not None:
            return {"out_dir": meta["out_dir"],
                    "fit_s": float(meta["fit_s"]),
                    "publish_s": float(meta["publish_s"]),
                    "fit_path": meta.get("fit_path"),
                    "data_stamp": int(meta.get("data_stamp") or 0),
                    "reused": True}
    base_dir = reuse_cold or run_dir
    out_dir = os.path.join(base_dir, "cold_out")
    # No (valid) meta means whatever lives in cold_out is NOT a
    # reusable fit for THIS rung/dataset — a different shape, or a
    # rotated data fingerprint.  Clear it: run_resident resumes from
    # completed chunk files, so stale coverage would silently publish
    # parameters fit against different data AND record a near-zero
    # "cold" wall into the meta (poisoning every *_vs_cold metric).
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    orchestrate.save_run_config(out_dir, cfg, solver)
    data_stamp = plane.delta_seq(dset_dir)
    t0 = time.time()
    cold_state = resident.run_resident(
        data_dir=dset_dir, out_dir=out_dir, series=rung.series,
        chunk=rung.chunk, phase1_iters=0, no_phase1_tune=True,
        mesh=mesh, device=device,
    )
    fit_s = time.time() - t0
    if not cold_state.get("complete"):
        return {"out_dir": out_dir, "fit_s": fit_s, "publish_s": None,
                "fit_path": cold_state.get("fit_path"),
                "data_stamp": data_stamp,
                "reused": False, "complete": False}
    return {"out_dir": out_dir, "fit_s": fit_s, "publish_s": None,
            "fit_path": cold_state.get("fit_path"),
            "data_stamp": data_stamp, "reused": False,
            "complete": True}


# ---------------------------------------------------------------------------
# bench --delta: the churn-fraction sweep
# ---------------------------------------------------------------------------

#: Churn fractions ``bench --delta`` sweeps by default.
DEFAULT_CHURNS = (0.01, 0.1, 0.3)


def parse_churns(spec: Optional[str]):
    """Churn fractions from a ``--churns`` CLI string (None -> the
    defaults): the parser of ``python -m tsspark_tpu_torch.refit
    --delta-bench``, as of both the JAX package's entry points."""
    if not spec:
        return DEFAULT_CHURNS
    return tuple(float(c) for c in spec.split(","))


def sweep_ok(reports: Sequence[Dict]) -> bool:
    """The sweep's pass/fail contract — every cycle complete AND
    sentinel-green — reduced in ONE place so every bench CLI's exit
    code (the delta, freshness and alert benches) means the same.  Success reports are bench-shaped
    (``complete`` lives under ``extra``); failure records carry it at
    the top level — accept both, and an EMPTY sweep is a failure."""
    if not reports:
        return False
    return all(
        bool(r.get("complete", (r.get("extra") or {}).get("complete")))
        and r.get("sentinel_ok", True)
        for r in reports
    )


#: A delta-bench run tree untouched this long is reaped on the next
#: sweep: each invocation keys a fresh ``run_<unix>`` dir (the cold
#: fit must be a real measurement, never a warm resume), so without an
#: age gate repeated sweeps accumulate rung-sized chunk/registry trees
#: forever.
STALE_RUN_S = 6 * 3600.0


def _sweep_stale_runs(scratch: str, keep: str,
                      max_age_s: float = STALE_RUN_S) -> int:
    removed = 0
    try:
        names = os.listdir(scratch)
    except OSError:
        return 0
    for name in names:
        d = os.path.join(scratch, name)
        if (not name.startswith("run_") or not os.path.isdir(d)
                or os.path.abspath(d) == os.path.abspath(keep)):
            continue
        try:
            import glob as glob_mod

            newest = max(
                (os.path.getmtime(p) for p in
                 glob_mod.glob(os.path.join(d, "**"), recursive=True)),
                default=os.path.getmtime(d),
            )
        except OSError:
            continue
        if time.time() - newest > max_age_s:
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
    return removed


def _delta_report(rung, churn: float, cold: Dict, res: Dict,
                  serve_stats: Dict, cfg, device=None) -> Dict:
    """One bench-family report per (rung, churn): the regression
    sentinel keys its workload ``...+delta<churn>`` (obs.history), so
    delta cycles are never baselined against cold fits."""
    from tsspark_tpu_torch.bench_scale import device_name
    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs.history import git_rev
    from tsspark_tpu_torch.utils import checkpoint as ckpt

    n_changed = res["n_changed"]
    fit_s = res.get("fit_s") or 0.0
    wall = res["wall_s"]
    cold_wall = cold["fit_s"] + cold["publish_s"]
    extra = {
        "trace_id": obs.trace_id(),
        "numerics_rev": NUMERICS_REV,
        "git_rev": git_rev(),
        "config_fingerprint": ckpt.config_fingerprint(cfg),
        "device": device_name(device),
        "complete": bool(res.get("complete")),
        "fit_path": res.get("fit_path", "resident"),
        "warm_start": res.get("warm_start"),
        "delta_churn": churn,
        "n_changed": n_changed,
        "series_done": n_changed,
        "series_total": rung.series,
        "delta_series_per_s": (round(n_changed / fit_s, 2)
                               if fit_s and n_changed else None),
        "delta_wall_frac": (round(wall / cold_wall, 4)
                            if cold_wall else None),
        "cold_fit_s": round(cold["fit_s"], 3),
        "cold_publish_s": round(cold["publish_s"], 3),
        "cold_wall_s": round(cold_wall, 3),
        "cold_reused": bool(cold.get("reused")),
        "detect_s": res.get("detect_s"),
        "fit_s": round(fit_s, 3),
        "publish_s": res.get("publish_s"),
        "flip_s": res.get("flip_s"),
        "fit_dispatches": res.get("fit_dispatches"),
        "version": res.get("version"),
        **serve_stats,
    }
    return {
        "metric": (f"delta_{rung.name}_{rung.series}x{rung.timesteps}"
                   "_refit_wall"),
        "value": round(wall, 3),
        "unit": "s",
        "vs_baseline": 0.0,
        "unix": round(time.time(), 3),
        "extra": extra,
    }


def prepare_cold_registry(rung, cfg, solver, run_dir: str,
                          dset_dir: str, ids,
                          reuse_cold: Optional[str] = None,
                          device=None, mesh=None) -> tuple:
    """(registry, cold, catchup) shared by ``bench --delta`` and
    ``bench --freshness``: the cold reference via :func:`cold_base`
    (measured fresh, or reused from ``reuse_cold``), published into a
    fresh registry under ``run_dir``.  When the reused base predates
    deltas already landed on the plane, one UNTIMED warm catch-up
    cycle brings the registry current so the measured sweep starts
    from a warm, current base — the reuse must amortize the cold fit,
    never skew the measured cycles with a backlog."""
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    cold = cold_base(rung, cfg, solver, run_dir, dset_dir,
                     reuse_cold=reuse_cold, device=device, mesh=mesh)
    if cold.get("complete") is False:
        return None, cold, None
    registry = ParamRegistry(os.path.join(run_dir, "registry"), cfg)
    t0 = time.time()
    orchestrate.publish_fit_state(
        registry, cold["out_dir"], ids,
        data_stamp=int(cold.get("data_stamp") or 0),
    )
    publish_s = time.time() - t0
    if cold["publish_s"] is None:
        cold["publish_s"] = publish_s
        if reuse_cold:
            save_cold_meta(reuse_cold, {
                "rung": rung.name, "series": rung.series,
                "timesteps": rung.timesteps,
                "fingerprint": plane.dataset_fingerprint(),
                "fit_s": round(cold["fit_s"], 3),
                "publish_s": round(cold["publish_s"], 3),
                "fit_path": cold.get("fit_path"),
                "data_stamp": int(cold.get("data_stamp") or 0),
                "unix": round(time.time(), 3),
            })
    catchup = None
    if plane.delta_seq(dset_dir) > int(cold.get("data_stamp") or 0):
        # Prior sweeps' deltas: refit them untimed so measured cycles
        # see only their own churn.
        catchup = run_refit(
            data_dir=dset_dir, registry=registry,
            scratch=os.path.join(run_dir, "catchup"),
            chunk=rung.chunk,
            solver_config=SolverConfig(max_iters=rung.max_iters),
            warm_start=True, device=device, mesh=mesh,
        )
    return registry, cold, catchup


def run_delta_bench(rung="smoke",
                    churns: Sequence[float] = DEFAULT_CHURNS,
                    data_root: Optional[str] = None,
                    scratch_root: Optional[str] = None,
                    sentinel: Optional[bool] = None,
                    reuse_cold: Optional[str] = None,
                    device=None, mesh=None) -> List[Dict]:
    """``bench --delta``: cold-fit one scale-ladder rung, then sweep
    ``churns`` — land a synthetic advance, run one warm delta-refit
    cycle (detect -> fit -> delta publish -> engine-materialized flip),
    and measure the flip-window cache carry-forward.  One bench-family
    ``BENCH_delta_*`` artifact per churn, each judged by the regression
    sentinel.

    The rung's plane dataset lives under a PRIVATE data root (deltas
    mutate landed rows in place; the shared cache's bytes must stay
    bitwise-stable for every other bench).  The cold fit runs in a
    fresh out dir each invocation so ``cold_wall`` is always a real
    measured fit, never a warm resume — UNLESS ``reuse_cold`` names a
    base dir, in which case the recorded cold measurement (and warm
    base) is reused so repeated churn sweeps amortize the cold fit.

    ``device``: where the fits, the publishes and the engine run (None:
    the card); ``mesh``: each fit's (None: the default one; on one card
    the chunk-file protocol's worker process, named in ``fit_path``).
    Reports go to the working directory, as the reference's."""
    import tempfile

    from tsspark_tpu_torch import bench_scale
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
        f"tsdelta_{rung.name}_{rung.series}x{rung.timesteps}"
        f"_{plane.dataset_fingerprint()}",
    )
    os.makedirs(scratch, exist_ok=True)
    prev_run = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    reports: List[Dict] = []
    try:
        droot = data_root or (os.path.join(reuse_cold, "plane")
                              if reuse_cold
                              else os.path.join(scratch, "plane"))
        spec = plane.DatasetSpec(
            generator="demo_weekly", n_series=rung.series,
            n_timesteps=rung.timesteps, seed=2,
        )
        dset_dir = plane.ensure(spec, root=droot)
        ids = plane.series_ids(spec)

        # ---- cold reference: resident fit + publish (or reuse) ------
        run_dir = os.path.join(scratch, f"run_{int(time.time())}")
        _sweep_stale_runs(scratch, keep=run_dir)
        registry, cold, _catchup = prepare_cold_registry(
            rung, cfg, solver, run_dir, dset_dir, ids,
            reuse_cold=reuse_cold, device=device, mesh=mesh,
        )
        if registry is None:
            print("[delta] cold fit incomplete; aborting the sweep",
                  file=sys.stderr)
            return [{"complete": False, "stage": "cold-fit"}]
        print(json.dumps({"delta_bench": rung.name,
                          "cold_fit_s": round(cold["fit_s"], 3),
                          "cold_publish_s": round(cold["publish_s"], 3),
                          "cold_reused": bool(cold.get("reused")),
                          "fit_path": cold["fit_path"]}), flush=True)

        # ---- serving side: in-process engine, warm hot set ----------
        sample, _ = bench_scale._request_mix(rung, ids)
        hot = [str(s) for s in sample[:rung.hot]]
        engine = PredictionEngine(registry, cache=ForecastCache(),
                                  device=device)
        engine.materialize(hot, bench_scale.HORIZONS)

        for churn in churns:
            t0 = time.time()
            delta_rec = plane.land_synthetic_delta(dset_dir, churn)
            land_s = time.time() - t0
            # Idempotent re-warm: the flip-window stats must start from
            # a warm steady state, not a cold cache.
            engine.materialize(hot, bench_scale.HORIZONS)
            stats0 = engine.cache.stats()

            def flip_fn(v):
                # The engine analog of the pool's materialize/drain
                # flip: prefetch (plane CRC sweep = page warming),
                # materialize the hot set into the warm window, flip.
                engine.prefetch(v)
                engine.materialize(hot, bench_scale.HORIZONS, version=v)
                registry.activate(v)

            res = run_refit(
                data_dir=dset_dir, registry=registry,
                scratch=os.path.join(run_dir, "refit"),
                chunk=rung.chunk, solver_config=solver,
                warm_start=True, flip_fn=flip_fn,
                horizons=bench_scale.HORIZONS, device=device, mesh=mesh,
            )
            if not res.get("complete"):
                # Same graceful failure as the cold-fit path: record
                # the incomplete cycle instead of crashing the sweep.
                print(f"[delta] churn {churn}: refit cycle incomplete; "
                      f"stopping the sweep", file=sys.stderr)
                reports.append({"complete": False, "stage": "refit",
                                "churn": churn, **res})
                break
            # Flip-window loadgen over the hot set: carried entries
            # serve unchanged series without a dispatch — the hit-rate
            # win partial invalidation buys.
            changed_ids = set(
                (registry.delta_info(res["version"]) or {})
                .get("changed_ids") or ()
            )
            n_req = 0
            for sid in hot:
                engine.forecast([sid], bench_scale.HORIZONS[0])
                n_req += 1
            stats1 = engine.cache.stats()
            d_hits = stats1["hits"] - stats0["hits"]
            d_total = (stats1["hits"] + stats1["misses"]
                       - stats0["hits"] - stats0["misses"])
            serve_stats = {
                "land_s": round(land_s, 3),
                "delta_seq": delta_rec["seq"],
                "cache_carried": stats1["carried"] - stats0["carried"],
                "flip_requests": n_req,
                "flip_hit_rate": (round(d_hits / d_total, 4)
                                  if d_total else None),
                "hot_changed": sum(1 for s in hot if s in changed_ids),
            }
            rep = _delta_report(rung, churn, cold, res, serve_stats,
                                cfg, device=device)
            path = (f"BENCH_delta_{rung.name}_c{int(churn * 1000):04d}"
                    f"_{int(rep['unix'])}.json")
            atomic_write(path,
                         lambda fh: json.dump(rep, fh, indent=1),
                         mode="w")
            rep["path"] = path
            print(json.dumps({
                "rung": rung.name, "churn": churn,
                "n_changed": res["n_changed"],
                "delta_wall_s": res["wall_s"],
                "delta_wall_frac": rep["extra"]["delta_wall_frac"],
                "delta_series_per_s":
                    rep["extra"]["delta_series_per_s"],
                "cache_carried": serve_stats["cache_carried"],
                "flip_hit_rate": serve_stats["flip_hit_rate"],
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

                    verdict = regress.sentinel_report(
                        rep, source=path
                    )
                    if verdict is not None:
                        print(f"[delta] {regress.summarize(verdict)}",
                              file=sys.stderr)
                        rep["sentinel_ok"] = verdict["ok"]
                except Exception as e:  # never mask the report
                    print(f"[delta] sentinel skipped: {e!r}",
                          file=sys.stderr)
            reports.append(rep)
        return reports
    finally:
        obs.end_run(prev_run)


# ---------------------------------------------------------------------------
# CLI (python -m tsspark_tpu_torch.refit): one cycle as a killable process
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one delta-refit cycle (or the churn-sweep bench) as its own
    process (the unit a chaos run kills mid delta-publish).  Adopts the
    spawner's trace.  ``--device cpu`` asks for the CPU and forces the
    virtual host mesh, as the reference's CLI forces its virtual CPU
    mesh; with no ``--device`` the cycle (or the bench) runs on the card,
    on the default mesh (one card: the file-protocol fallback, named in
    ``fit_path``)."""
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
                    help="run the churn-fraction sweep at a scale "
                         "rung instead of one cycle")
    ap.add_argument("--churns", default=None,
                    help="comma-separated churn fractions for "
                         "--delta-bench")
    ap.add_argument("--reuse-cold", default=None, metavar="DIR",
                    help="reuse (or record) the cold fit+publish "
                         "reference under DIR so repeated sweeps "
                         "amortize the cold fit")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        from tsspark_tpu_torch.parallel.mesh import force_virtual_host_mesh

        force_virtual_host_mesh()
    obs.adopt_env()
    if args.delta_bench:
        reports = run_delta_bench(args.delta_bench,
                                  churns=parse_churns(args.churns),
                                  reuse_cold=args.reuse_cold,
                                  device=args.device)
        return 0 if sweep_ok(reports) else 1
    if not (args.data and args.registry and args.scratch):
        ap.error("--data, --registry and --scratch are required for a "
                 "refit cycle")
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
