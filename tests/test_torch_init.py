"""The solver's warm start against the JAX package: ``ridge_init``,
``curvature_diag`` and the heuristic ``init_theta``, for linear, flat and
logistic growth on a config-3-shaped batch (onset-masked, holiday, price
and promo regressors) plus an all-masked padding row.

Tolerances, with their reasons:
  * ridge_init: the batched Gram and Cholesky run in float32 in both
    packages with other summation orders, and the trend columns (t and
    the changepoint hinges) are nearly collinear, so the split between k
    and the deltas is ill-conditioned: on this batch both float32 solves
    lie ~8e-2 from a float64 solve of the same system, yet their losses
    agree to ~1e-6 relative.  Parameters are held to atol 1e-2 +
    rtol 1e-2, the loss at the init to rtol 1e-5;
  * curvature_diag and init_theta: rtol 1e-5 (sums over T in float32).
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import init as jinit
from tsspark_tpu.models.prophet import loss as jloss
from tsspark_tpu.models.prophet import params as jparams
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import init as tinit
from tsspark_tpu_torch.models.prophet import loss as tloss
from tsspark_tpu_torch.models.prophet import params as tparams

torch.set_num_threads(2)


def _cfgs(growth):
    out = []
    for mod in (jcfg, tcfg):
        out.append(mod.ProphetConfig(
            growth=growth,
            seasonalities=(mod.SeasonalityConfig("yearly", 365.25, 4),
                           mod.SeasonalityConfig("weekly", 7.0, 3)),
            regressors=(mod.RegressorConfig("holiday", standardize=False),
                        mod.RegressorConfig("price"),
                        mod.RegressorConfig("promo", standardize=False)),
            n_changepoints=10))
    return out


@pytest.fixture(scope="module", params=["linear", "flat", "logistic"])
def case(request):
    growth = request.param
    cj, ct = _cfgs(growth)
    batch = m5_like(12, 300, seed=5)
    y = np.nan_to_num(batch.y)
    mask = batch.mask.copy()
    mask[-1] = 0.0  # an all-masked chunk-padding row
    kw = dict(mask=mask, regressors=batch.regressors)
    if growth == "logistic":
        kw["cap"] = np.nanmax(batch.y, axis=1, keepdims=True) * 1.5 \
            * np.ones_like(y)
    dj, _ = jdesign.prepare_fit_data(batch.ds, y, cj, as_numpy=True, **kw)
    dt, _ = tdesign.prepare_fit_data(batch.ds, y, ct, **kw)
    return (cj, ct, jdesign.FitData(*map(jnp.asarray, dj)),
            tdesign.fitdata_to_device(dt, "cpu"))


def test_ridge_init_matches(case):
    cj, ct, dj, dt = case
    got = tinit.ridge_init(dt, ct)
    want = np.asarray(jinit.ridge_init(dj, cj))
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    npt.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    # The padding row is inert: zero parameters, floor sigma.
    assert float(got[-1, 3:].abs().max()) == 0.0
    npt.assert_allclose(
        tloss.value_batch(got, dt, ct).numpy(),
        np.asarray(jloss.value_batch(jnp.asarray(want), dj, cj)), rtol=1e-5)


def test_curvature_diag_matches(case):
    cj, ct, dj, dt = case
    theta0 = np.array(jinit.ridge_init(dj, cj))
    got = tinit.curvature_diag(dt, ct, torch.from_numpy(theta0))
    want = jinit.curvature_diag(dj, cj, jnp.asarray(theta0))
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_init_theta_and_dispatch_match(case):
    cj, ct, dj, dt = case
    got = tparams.init_theta(ct, dt.y, dt.mask, dt.t)
    want = jparams.init_theta(cj, dj.y, dj.mask, dj.t)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                        atol=1e-6)
    heur = tinit.initial_theta(dt, ct, tcfg.SolverConfig(init="heuristic"))
    assert torch.equal(heur, got)
    ridge = tinit.initial_theta(dt, ct, tcfg.SolverConfig())
    assert torch.equal(ridge, tinit.ridge_init(dt, ct))


def test_ridge_solve_gives_nan_rows_where_cholesky_fails():
    phi = torch.zeros((2, 4, 2))
    phi[0] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [2.0, 1.0]])
    y = torch.ones((2, 4))
    mask = torch.ones((2, 4))
    prec = torch.tensor([1.0, -1e9])  # row 1's Gram is not positive definite
    w = tinit._ridge_solve(phi, y, mask, prec, torch.tensor([1e-9, 1.0]))
    assert bool(torch.isfinite(w[0]).all())
    assert bool(torch.isnan(w[1]).all())
