"""Calibration eval: do the served intervals mean what they say?

The port of the JAX package's ``uncertainty/calibrate.py``.  An interval
product can regress without a single bitwise diff (a widened posterior, a
mis-scaled noise, a seasonality dropped from the draw path), so the gate
is the definition itself: **empirical coverage vs nominal** on held-out
data, per horizon bucket, of the plane's own served columns:

    coverage_abs_gap = max over buckets |empirical - nominal|

for the outer-quantile interval, per-quantile gaps beside it.

``run_calibration_smoke`` runs the whole ladder in one process: the demo
workload (``demo_weekly``, read off the data plane under ``data_root``)
with the last ``holdout`` days withheld,
the MAP fit, the ADVI advance, the quantile plane's publish, the coverage
eval, interval-read probes and a small HMC gold audit on the same
truncated data.  It runs on the card unless ``device="cpu"``.
``run_uncertainty_bench`` wraps it as the reference's bench does: the
``BENCH_uncertainty_*`` report, its ``calibration`` row in the run history
and the regression sentinel.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "DEFAULT_HOLDOUT",
    "coverage_eval",
    "evaluate_version",
    "run_calibration_smoke",
    "run_uncertainty_bench",
]

DEFAULT_HOLDOUT = 28


def coverage_eval(qcols: Dict[int, np.ndarray], y_true: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> Dict:
    """Score quantile columns ``{permille: (n, H)}`` against aligned truth
    ``y_true`` (n, H), over the ``valid`` (n, H) cells (all by default):
    per-quantile empirical rates and gaps, and the outer interval's
    coverage and ``coverage_abs_gap``."""
    y = np.asarray(y_true, np.float64)
    valid = (np.ones(y.shape, bool) if valid is None
             else np.asarray(valid, bool))
    n_valid = int(valid.sum())
    if n_valid == 0:
        raise ValueError("coverage_eval: no valid (series, step) cells")
    pms = sorted(qcols)
    per_q = {}
    for pm in pms:
        col = np.asarray(qcols[pm], np.float64)
        rate = float((y <= col)[valid].mean())
        per_q[pm] = {
            "nominal": pm / 1000.0,
            "empirical": round(rate, 6),
            "abs_gap": round(abs(rate - pm / 1000.0), 6),
        }
    lo, hi = pms[0], pms[-1]
    inside = ((y >= np.asarray(qcols[lo], np.float64))
              & (y <= np.asarray(qcols[hi], np.float64)))
    cov = float(inside[valid].mean())
    nominal = (hi - lo) / 1000.0
    return {
        "n_cells": n_valid,
        "interval": [lo, hi],
        "interval_nominal": round(nominal, 6),
        "interval_empirical": round(cov, 6),
        "coverage_abs_gap": round(abs(cov - nominal), 6),
        "quantile_gaps": per_q,
    }


def evaluate_version(registry, version: int, ds_future: np.ndarray,
                     y_future: np.ndarray, *,
                     mask_future: Optional[np.ndarray] = None
                     ) -> Optional[Dict]:
    """Score one version's PUBLISHED quantile plane against held-out truth
    per horizon bucket (the plane's own columns, ``qplane.attach`` +
    ``quantile_batch``).  Grid cells align to ``ds_future`` by value; a
    cell off the holdout drops out.  None when the version has no
    attachable plane."""
    from tsspark_tpu_torch.uncertainty import qplane

    snap = registry.load(int(version))
    try:
        view = qplane.attach(registry.version_dir(int(version)),
                             expected_n=len(snap.series_ids))
    except qplane.QuantilePlaneError:
        return None
    ds_future = np.asarray(ds_future, np.float64)
    y_future = np.asarray(y_future, np.float64)
    n = len(snap.series_ids)
    idx = np.arange(n, dtype=np.int64)
    buckets = {}
    gaps = []
    for hb in view.buckets:
        grid, cols = qplane.quantile_batch(view, snap, idx, int(hb))
        pos = np.clip(np.searchsorted(ds_future, grid), 0,
                      len(ds_future) - 1)
        matched = np.isclose(ds_future[pos], grid)
        y_t = y_future[np.arange(n)[:, None], pos]
        valid = matched
        if mask_future is not None:
            valid = valid & np.asarray(
                mask_future, bool)[np.arange(n)[:, None], pos]
        if not valid.any():
            continue
        rep = coverage_eval(cols, y_t, valid)
        buckets[str(int(hb))] = rep
        gaps.append(rep["coverage_abs_gap"])
    if not buckets:
        return None
    return {
        "mode": view.mode,
        "draws": view.draws,
        "seed": view.seed,
        "coverage_abs_gap": max(gaps),
        "buckets": buckets,
    }


def run_calibration_smoke(scratch: str, *, n_series: int = 24,
                          seed: int = 0, holdout: int = DEFAULT_HOLDOUT,
                          horizons: Sequence[int] = (7, 14, 28),
                          data_root: Optional[str] = None,
                          gold_audit: bool = True, read_probes: int = 200,
                          device=None) -> Dict:
    """The end-to-end uncertainty smoke: fit-minus-holdout, ADVI advance,
    quantile-plane publish, coverage eval, read-latency probes, gold
    audit.  ``data_root``: the data plane's root the demo dataset is
    ingested under and read from (``None``: ``plane.default_root()``).
    Returns the ``kind="calibration-eval"`` report dict."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        AdviConfig,
        McmcConfig,
        ProphetConfig,
        SeasonalityConfig,
        SolverConfig,
    )
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.device import resolve_device
    from tsspark_tpu_torch.models.prophet.design import (
        prepare_fit_data_blocks)
    from tsspark_tpu_torch.serve.registry import ParamRegistry
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import gold as gold_mod
    from tsspark_tpu_torch.uncertainty import qplane

    t_start = time.perf_counter()
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    config = ProphetConfig(
        seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3,
    )
    spec = plane.DatasetSpec(
        generator="demo_weekly", n_series=int(n_series),
        n_timesteps=180, seed=int(seed),
    )
    batch = plane.open_batch(plane.ensure(spec, root=data_root))
    ds = np.asarray(batch.ds, np.float64)
    y = np.asarray(batch.y)
    mask = None if batch.mask is None else np.asarray(batch.mask)
    cut = len(ds) - int(holdout)
    if cut < 8:
        raise ValueError(f"holdout {holdout} leaves only {cut} fit points")
    ds_fit, y_fit = ds[:cut], y[:, :cut]
    mask_fit = None if mask is None else mask[:, :cut]

    backend = get_backend("cuda", config, SolverConfig(max_iters=25),
                          device=dev)
    t0 = time.perf_counter()
    state = backend.fit(ds_fit, y_fit)
    fit_s = round(time.perf_counter() - t0, 3)

    registry = ParamRegistry(os.path.join(scratch, "registry"), config)
    v = registry.publish(state, np.asarray(batch.series_ids),
                         step=np.ones(int(n_series)))

    # ADVI advance over the SAME truncated design the MAP solve saw.
    data, _meta = prepare_fit_data_blocks(ds_fit, y_fit, config,
                                          mask=mask_fit)
    advi_cfg = AdviConfig()
    t0 = time.perf_counter()
    post = advi_mod.fit_advi(
        np.nan_to_num(qplane._host(state.theta)), data,
        torch.Generator(device=dev).manual_seed(int(seed)), config,
        advi_cfg, device=dev,
    )
    sync()
    advi_s = round(time.perf_counter() - t0, 3)
    advi_mod.save_posterior(registry.version_dir(int(v)), post,
                            seed=int(seed), num_steps=advi_cfg.num_steps)

    t0 = time.perf_counter()
    qpub = qplane.maybe_publish(registry, int(v), backend,
                                horizons=tuple(horizons))
    publish_s = round(time.perf_counter() - t0, 3)
    if qpub is None:
        raise RuntimeError("calibration smoke: qplane publish refused")

    calib = evaluate_version(registry, int(v), ds[cut:], y[:, cut:],
                             mask_future=None if mask is None
                             else mask[:, cut:])
    if calib is None:
        raise RuntimeError("calibration smoke: no scorable plane")

    # Interval-read latency: small random gathers, the hot read shape.
    snap = registry.load(int(v))
    view = qplane.attach(registry.version_dir(int(v)),
                         expected_n=int(n_series))
    rng = np.random.default_rng(int(seed))
    hbs = list(view.buckets)
    walls = []
    for _ in range(int(read_probes)):
        k = int(rng.integers(1, min(9, n_series + 1)))
        idx = rng.choice(n_series, size=k, replace=False)
        hb = int(hbs[int(rng.integers(len(hbs)))])
        t1 = time.perf_counter()
        qplane.quantile_batch(view, snap, np.sort(idx), hb)
        walls.append((time.perf_counter() - t1) * 1e3)
    qread = {k: round(float(np.percentile(walls, q)), 3)
             for k, q in (("p50", 50), ("p95", 95), ("p99", 99))}

    gold_rep = None
    if gold_audit:
        gold_rep = gold_mod.audit_version(
            registry, version=int(v),
            arrays=(ds_fit, y_fit, mask_fit, None),
            max_series=2, seed=int(seed),
            mcmc_config=McmcConfig(num_samples=60, num_warmup=60,
                                   num_leapfrog=8),
            device=dev,
        )

    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.serve.__main__ import _report_identity

    report = {
        **_report_identity(registry, dev),
        "kind": "calibration-eval",
        "n_series": int(n_series),
        "holdout": int(holdout),
        "seed": int(seed),
        "wall_s": round(time.perf_counter() - t_start, 3),
        "calibration": {
            "mode": calib["mode"],
            "coverage_abs_gap": calib["coverage_abs_gap"],
            "buckets": calib["buckets"],
            "draws": calib["draws"],
            "fit_s": fit_s,
            "advi_fit_s": advi_s,
            "advi_series_per_s": (round(n_series / advi_s, 1)
                                  if advi_s > 0 else None),
            "publish_s": publish_s,
            "nbytes": qpub.get("nbytes"),
            "qread_ms": qread,
            "qread_p99_ms": qread["p99"],
            "gold": None if gold_rep is None else {
                "qdiv_max": gold_rep["qdiv_max"],
                "qdiv_mean": gold_rep["qdiv_mean"],
                "rhat_max": gold_rep["rhat_max"],
                "ess_min": gold_rep["ess_min"],
                "hmc_divergences": gold_rep["hmc_divergences"],
                "rows": gold_rep["rows"],
            },
        },
    }
    obs.event("calibration.smoke",
              coverage_abs_gap=calib["coverage_abs_gap"],
              mode=calib["mode"], qread_p99_ms=qread["p99"])
    return report


def run_uncertainty_bench(args) -> int:
    """The calibration bench (an argparse-style namespace, as the JAX
    package's ``bench.py --uncertainty`` passes: series / seed / dir /
    report / data_root, and ``device``: None is the card).  Persists the
    ``kind="calibration-eval"`` report as ``BENCH_uncertainty_*`` (in the
    working directory unless ``args.report``), joins it to RUNHISTORY as
    the ``calibration`` row family, and gates under
    ``[tool.tsspark.slo.calibration]``.  Returns the exit code; the run's
    trace binding is restored when it ends."""
    import json

    from tsspark_tpu_torch.io import atomic_write
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.serve.__main__ import _sentinel_gate

    scratch = os.path.join(args.dir or ".", "uncertainty_scratch")
    prev = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    try:
        report = run_calibration_smoke(
            scratch, n_series=int(args.series), seed=int(args.seed),
            data_root=args.data_root, device=getattr(args, "device", None),
        )
        out = args.report or f"BENCH_uncertainty_{int(time.time())}.json"
        atomic_write(out, lambda fh: json.dump(report, fh, indent=1),
                     mode="w")
        cal = report["calibration"]
        gold = cal.get("gold") or {}
        print(
            f"uncertainty: mode {cal['mode']} | coverage gap "
            f"{cal['coverage_abs_gap']} (nominal-vs-empirical, worst "
            f"bucket) | advi {cal['advi_series_per_s']} series/s "
            f"({cal['advi_fit_s']}s) | qplane publish {cal['publish_s']}s "
            f"({cal['nbytes']} B) | qread p50={cal['qread_ms']['p50']} "
            f"p99={cal['qread_p99_ms']} ms | gold qdiv_max "
            f"{gold.get('qdiv_max')} rhat_max {gold.get('rhat_max')} | "
            f"report -> {out}"
        )
        return _sentinel_gate(report, out)
    finally:
        obs.end_run(prev)
