"""The MCMC route's mixing against the JAX package's, in distribution.

Both packages' ``fit_mcmc`` run config 3's model on the same 16 rows x
365 days of ``m5_like`` at the path's chain settings (``McmcConfig()``:
300 warmup, 300 samples, 24 leapfrog steps); the RNG streams differ, so
the per-(series, parameter) split-R-hat distributions are compared, not
the draws.  Slow: the port's plain sampler takes about a minute on the
CPU.  ``-s`` prints the readings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy import stats

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import model as jmodel
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.models.prophet import model as tmodel

torch.set_num_threads(2)


def _cfg(mod):
    return mod.ProphetConfig(
        seasonalities=(mod.SeasonalityConfig("yearly", 365.25, 8),
                       mod.SeasonalityConfig("weekly", 7.0, 3)),
        regressors=(mod.RegressorConfig("holiday", standardize=False),
                    mod.RegressorConfig("price"),
                    mod.RegressorConfig("promo", standardize=False)),
        n_changepoints=25,
    )


def _summary(rhat) -> dict:
    rh = np.asarray(rhat, np.float64)
    return {"frac_over_1.1": float((rh > 1.1).mean()),
            "rows_worst_over_1.1": int((rh.max(1) > 1.1).sum()),
            "median": float(np.median(rh)),
            "p90": float(np.quantile(rh, 0.9)), "max": float(rh.max())}


@pytest.mark.slow
def test_split_rhat_distribution_matches_the_reference():
    """Read once (16 rows, P = 53): the JAX package 34.3% of (series,
    parameter) pairs over 1.1, every row's worst; the port 37.3%, every
    row's worst; KS p = 0.27.  The same mixing: the poor R-hat at these
    settings is the reference's own.  Held: KS p above 0.01 and the two
    shares over 1.1 within three standard errors of their difference."""
    b = m5_like(16, 365, seed=2)
    ds, y = np.asarray(b.ds), np.nan_to_num(np.asarray(b.y))
    m, r = np.asarray(b.mask), np.asarray(b.regressors)
    want = jmodel.ProphetModel(
        _cfg(jcfg), jcfg.SolverConfig(max_iters=120)).fit_mcmc(
        jnp.asarray(ds), jnp.asarray(y), mask=jnp.asarray(m),
        regressors=jnp.asarray(r), mcmc_config=jcfg.McmcConfig(), seed=0)
    got = tmodel.ProphetModel(
        _cfg(tcfg), tcfg.SolverConfig(max_iters=120), device="cpu").fit_mcmc(
        ds, y, mask=m, regressors=r, mcmc_config=tcfg.McmcConfig(), seed=0)
    a, b_ = np.asarray(got.rhat).ravel(), np.asarray(want.rhat).ravel()
    ks = stats.ks_2samp(a, b_)
    pa, pb = (a > 1.1).mean(), (b_ > 1.1).mean()
    pooled = (pa + pb) / 2
    se = np.sqrt(2 * pooled * (1 - pooled) / a.size)
    print({"port": _summary(got.rhat), "jax": _summary(want.rhat),
           "ks_p": float(ks.pvalue), "share_gap_in_se": float(
               (pa - pb) / se)})
    assert ks.pvalue > 0.01
    assert abs(pa - pb) <= 3 * se
