"""NUTS gold tier: a sampled full-posterior audit of the ADVI intervals.

The port of the JAX package's ``uncertainty/gold.py``.  Full HMC chains
over a whole fleet are not a serving cost, so the gold tier samples a
**deterministic audit subset** per version (``SeedSequence((seed,
version))``: every re-run of the audit for a version lands on the same
rows) and records the parameter-space quantile divergence between the two
posteriors, in units of the wider posterior sd:

    |Q_nuts(q) - (mu + exp(rho) * z_q)| / max(sd_nuts, sd_advi)

maximized over parameters and quantiles.  The chains are the port's
sampler (``models/prophet/model.mcmc_core`` over K3 on the card), from
the version's MAP theta; the report lands as ``gold_audit.json`` in the
version dir, in the reference's layout.

NUTS's log density includes the ``log_sigma`` change-of-variables
Jacobian while the ADVI objective is the MAP parameterization without it:
a known modeling difference that shows as a small constant offset in the
sigma quantiles, as in the reference.  The audit reads its rows' data
from ``arrays=(ds, y, mask, cap)``; the reference's data-plane route
(``data_dir``) waits for the port's data plane.
"""

from __future__ import annotations

import json
import os
from statistics import NormalDist
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import NUMERICS_REV, McmcConfig
from tsspark_tpu_torch.utils.atomic import atomic_write

__all__ = [
    "GOLD_FILE",
    "GOLD_FORMAT",
    "DEFAULT_MAX_SERIES",
    "select_rows",
    "quantile_divergence",
    "run_gold",
    "audit_version",
    "load_audit",
]

GOLD_FORMAT = 1
GOLD_FILE = "gold_audit.json"

#: Audit subset size: eight full chains a version.
DEFAULT_MAX_SERIES = 8
DEFAULT_QUANTILES = (0.1, 0.5, 0.9)


def select_rows(n_series: int, version: int, *,
                max_series: int = DEFAULT_MAX_SERIES,
                seed: int = 0) -> np.ndarray:
    """The version's deterministic audit subset (sorted row indices),
    keyed by ``SeedSequence((seed, version))``."""
    if n_series <= max_series:
        return np.arange(n_series, dtype=np.int64)
    rng = np.random.default_rng(
        np.random.SeedSequence((int(seed), int(version)))
    )
    rows = rng.choice(n_series, size=int(max_series), replace=False)
    return np.sort(rows).astype(np.int64)


def quantile_divergence(samples, mu, rho,
                        quantiles: Sequence[float] = DEFAULT_QUANTILES
                        ) -> np.ndarray:
    """ADVI-vs-NUTS quantile divergence per series, (B,), in float64: for
    each quantile the NUTS empirical quantile of the (S, B, P) draws
    against the ADVI Gaussian quantile ``mu + exp(rho) * z_q``, over the
    wider of the two posterior sds, maximized over parameters and
    quantiles."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    s = np.asarray(samples, np.float64)
    mu = np.asarray(mu, np.float64)
    sd = np.exp(np.asarray(rho, np.float64))
    scale = np.maximum(np.maximum(s.std(axis=0, ddof=1), sd), 1e-12)
    div = np.zeros(mu.shape[0], np.float64)
    for q in quantiles:
        z = NormalDist().inv_cdf(float(q))
        gap = np.abs(np.quantile(s, float(q), axis=0) - (mu + sd * z))
        div = np.maximum(div, (gap / scale).max(axis=-1))
    return div


def run_gold(data, theta0, config, generator: torch.Generator,
             mcmc_config: Optional[McmcConfig] = None) -> Tuple:
    """One batched HMC run + split diagnostics over the audit subset:
    the port's sampler (``mcmc_core``) on ``data`` (tensors on the
    generator's device) from ``theta0``.  Returns ``(HmcResult, rhat
    (B, P), ess (B, P))``."""
    from tsspark_tpu_torch.models.prophet.model import mcmc_core
    from tsspark_tpu_torch.ops import hmc

    mcmc_config = McmcConfig() if mcmc_config is None else mcmc_config
    res = mcmc_core(data, torch.as_tensor(theta0), generator, config,
                    mcmc_config)
    rhat, ess = hmc.split_rhat_ess(res.samples)
    return res, rhat, ess


def _generator(seed: int, version: int, device) -> torch.Generator:
    """The audit's generator, seeded from ``(seed, version)``."""
    word = np.random.SeedSequence((int(seed), int(version))) \
        .generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def audit_version(registry, data_dir: Optional[str] = None,
                  version: Optional[int] = None, *,
                  arrays: Optional[Tuple] = None,
                  max_series: int = DEFAULT_MAX_SERIES,
                  seed: int = 0,
                  mcmc_config: Optional[McmcConfig] = None,
                  quantiles: Sequence[float] = DEFAULT_QUANTILES,
                  device=None) -> Optional[dict]:
    """Audit one registry version's ADVI posterior against HMC.

    Loads the version's posterior and snapshot, gathers the audit rows'
    data off the data plane (``data_dir``, a complete plane dataset; or
    ``arrays=(ds, y, mask, cap)`` directly, e.g. the holdout-truncated
    arrays the version was fitted on), runs the chains from the MAP
    theta on ``device`` (``None``: the card) and writes
    ``gold_audit.json`` into the version dir.  Returns the report, or
    None when the version has no usable ADVI posterior."""
    from tsspark_tpu_torch.device import resolve_device
    from tsspark_tpu_torch.models.prophet.design import (
        fitdata_to_device,
        prepare_fit_data,
    )
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty.qplane import _advi_eligible, _host

    version = (registry.active_version() if version is None
               else int(version))
    if version is None:
        return None
    vdir = registry.version_dir(int(version))
    loaded = advi_mod.load_posterior(vdir)
    if loaded is None or not _advi_eligible(registry.config):
        return None
    post, header = loaded
    snap = registry.load(int(version))
    n = len(snap.series_ids)
    if int(np.asarray(post.mu).shape[0]) != n:
        return None
    rows = select_rows(n, int(version), max_series=max_series, seed=seed)
    if arrays is None:
        from tsspark_tpu_torch.data import plane

        batch = plane.open_batch(data_dir)
        ds, y = np.asarray(batch.ds), batch.y
        mask, cap = batch.mask, batch.cap
    else:
        ds, y, mask, cap = arrays
    sub = lambda a: (None if a is None  # noqa: E731
                     else np.ascontiguousarray(np.asarray(a)[rows]))
    data, _meta = prepare_fit_data(
        np.asarray(ds, np.float64), sub(y), registry.config,
        mask=sub(mask), cap=sub(cap),
    )
    dev = resolve_device(device)
    state_sub, _step = snap.take(rows)
    theta0 = torch.from_numpy(np.nan_to_num(_host(state_sub.theta)))
    mcmc_config = McmcConfig() if mcmc_config is None else mcmc_config
    res, rhat, ess = run_gold(
        fitdata_to_device(data, dev), theta0.to(dev), registry.config,
        _generator(seed, int(version), dev), mcmc_config,
    )
    div = quantile_divergence(res.samples, np.asarray(post.mu)[rows],
                              np.asarray(post.rho)[rows], quantiles)
    report = {
        "format": GOLD_FORMAT,
        "numerics_rev": NUMERICS_REV,
        "version": int(version),
        "seed": int(seed),
        "posterior_seed": int(header.get("seed", 0)),
        "rows": [int(r) for r in rows],
        "quantiles": [float(q) for q in quantiles],
        "num_warmup": int(mcmc_config.num_warmup),
        "num_samples": int(mcmc_config.num_samples),
        "qdiv": [round(float(d), 6) for d in div],
        "qdiv_max": round(float(div.max()), 6),
        "qdiv_mean": round(float(div.mean()), 6),
        "rhat_max": round(float(np.max(rhat)), 6),
        "ess_min": round(float(np.min(ess)), 3),
        "accept_mean": round(float(res.accept_rate.mean()), 6),
        "hmc_divergences": int(res.divergences.sum()),
    }
    atomic_write(os.path.join(vdir, GOLD_FILE),
                 lambda fh: json.dump(report, fh, indent=1), mode="w")
    return report


def load_audit(version_dir: str) -> Optional[dict]:
    """The version's gold audit report, or None when absent/unreadable."""
    path = os.path.join(version_dir, GOLD_FILE)
    try:
        with open(path) as fh:
            report = json.load(fh)
    except (OSError, ValueError):
        return None
    if report.get("format") != GOLD_FORMAT:
        return None
    return report
