"""The port's model math against the JAX package: trend functions,
``seasonal_split`` and ``model_yhat`` on random parameters for every
growth mode, seasonality mode and feature layout, plus the hand-derived
golden values of ``tests/test_golden.py`` re-run against the port.

Tolerance: rtol 1e-5, atol 1e-6 in scaled units — the JAX package adds
its changepoint and feature sums as einsums (another summation order
than the port's ordered loops), so the two agree to float32 rounding,
not bitwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import trend as jtrend
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import trend
from tsspark_tpu_torch.models.prophet.params import pack, unpack
from tsspark_tpu_torch.models.prophet.seasonality import fourier_features

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _trend_inputs(seed=0, b=6, t_len=50, ncp=7):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = np.sort(rng.uniform(-0.1, 1.3, (b, t_len)), axis=1).astype(f32)
    s = np.sort(rng.uniform(0.0, 0.9, (b, ncp)), axis=1).astype(f32)
    k = rng.normal(0.5, 0.5, b).astype(f32)
    m = rng.uniform(0.1, 0.6, b).astype(f32)
    delta = rng.normal(0.0, 0.3, (b, ncp)).astype(f32)
    cap = rng.uniform(1.5, 3.0, (b, t_len)).astype(f32)
    return t, s, k, m, delta, cap


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("ncp", [0, 1, 7])
def test_piecewise_linear_and_step_sum_match(ncp):
    t, s, k, m, delta, _ = _trend_inputs(ncp=ncp)
    _close(trend.piecewise_linear(T(t), T(k), T(m), T(delta), T(s)),
           jtrend.piecewise_linear(J(t), J(k), J(m), J(delta), J(s)))
    _close(trend.step_weighted_sum(T(delta), T(t), T(s)),
           jtrend.step_weighted_sum(J(delta), J(t), J(s)))


@pytest.mark.parametrize("ncp", [0, 1, 7])
def test_logistic_trend_and_gamma_match(ncp):
    t, s, k, m, delta, cap = _trend_inputs(seed=1, ncp=ncp)
    if ncp:
        _close(trend._logistic_gamma(T(k), T(m), T(delta), T(s)),
               jtrend._logistic_gamma(J(k), J(m), J(delta), J(s)))
    _close(trend.logistic(T(t), T(cap), T(k), T(m), T(delta), T(s)),
           jtrend.logistic(J(t), J(cap), J(k), J(m), J(delta), J(s)))


def test_flat_and_uniform_changepoints_match():
    t, s, k, m, delta, _ = _trend_inputs()
    _close(trend.flat(T(t), T(m)), jtrend.flat(J(t), J(m)))
    first = np.zeros(5, np.float32)
    last = np.ones(5, np.float32)
    got = trend.uniform_changepoints(first, last, 9, 0.8)
    want = jtrend.uniform_changepoints(first, last, 9, 0.8)
    npt.assert_array_equal(got, want)  # host numpy: bitwise
    assert trend.uniform_changepoints(first, last, 0, 0.8).shape == (5, 0)


def test_param_pack_roundtrip():
    cfg = tcfg.ProphetConfig()
    theta = torch.randn(4, cfg.num_params)
    p = unpack(theta, cfg)
    assert p.delta.shape == (4, 25) and p.beta.shape == (4, 26)
    assert torch.equal(pack(p), theta)
    with pytest.raises(ValueError):
        unpack(theta[:, :-1], cfg)


def _model_case(growth, mode, per_series, regressors, seed=0):
    """The same config, FitData and theta in both packages."""
    kw = dict(growth=growth, n_changepoints=6, seasonality_mode=mode)
    cfgs = []
    for mod in (jcfg, tcfg):
        seas = (dataclasses.replace(mod.YEARLY, fourier_order=3, mode=mode),
                dataclasses.replace(mod.WEEKLY, mode="additive"))
        regs = tuple(mod.RegressorConfig(f"r{i}",
                                         mode="multiplicative" if i else
                                         "additive")
                     for i in range(regressors))
        cfgs.append(mod.ProphetConfig(seasonalities=seas, regressors=regs,
                                      **kw))
    jc, tc = cfgs
    rng = np.random.default_rng(seed)
    b, t_len = 5, 60
    ds = 18000.0 + np.arange(t_len, dtype=np.float64)
    if per_series:
        ds = ds[None, :] + rng.integers(0, 200, (b, 1))
    y = 10 + np.sin(np.asarray(ds) / 7.0) + rng.normal(0, 0.3, (b, t_len))
    y = np.broadcast_to(y, (b, t_len)).copy()
    kwargs = {}
    if regressors:
        kwargs["regressors"] = rng.normal(0, 1, (b, t_len, regressors))
    if growth == "logistic":
        kwargs["cap"] = np.full((b, t_len), 20.0)
    data_t, _ = tdesign.prepare_fit_data(ds, y, tc, **kwargs)
    data_j, _ = jdesign.prepare_fit_data(ds, y, jc, as_numpy=True, **kwargs)
    theta = rng.normal(0, 0.2, (b, tc.num_params)).astype(np.float32)
    theta[:, 0] = rng.normal(0.5, 0.3, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    data_t = tdesign.FitData(*(T(np.ascontiguousarray(a)) for a in data_t))
    data_j = jdesign.FitData(*(J(a) for a in data_j))
    return jc, tc, data_j, data_t, theta


MODEL_CASES = [
    (g, mode, per_series, regs)
    for g in ("linear", "logistic", "flat")
    for mode in ("additive", "multiplicative")
    for per_series, regs in ((False, 0), (True, 2))
]


@pytest.mark.parametrize("growth,mode,per_series,regs", MODEL_CASES)
def test_seasonal_split_and_model_yhat_match(growth, mode, per_series, regs):
    jc, tc, data_j, data_t, theta = _model_case(growth, mode, per_series,
                                                regs)
    assert data_t.X_season.ndim == (3 if per_series else 2)
    add_t, mult_t = tdesign.seasonal_split(T(theta), data_t, tc)
    add_j, mult_j = jdesign.seasonal_split(J(theta), data_j, jc)
    _close(add_t, add_j)
    _close(mult_t, mult_j)
    yhat_t, g_t = tdesign.model_yhat(T(theta), data_t, tc)
    yhat_j, g_j = jdesign.model_yhat(J(theta), data_j, jc)
    _close(g_t, g_j)
    _close(yhat_t, yhat_j)


def test_model_yhat_rows_do_not_depend_on_the_batch():
    """Padding rows or a wider batch never change a row's bits (the
    serving engine's bitwise pin rests on this)."""
    _, tc, _, data_t, theta = _model_case("linear", "additive", True, 2)
    full, _ = tdesign.model_yhat(T(theta), data_t, tc)
    sub = tdesign.FitData(*(
        a if a.ndim == 1 else a[1:3] for a in data_t
    ))
    part, _ = tdesign.model_yhat(T(theta[1:3]), sub, tc)
    assert torch.equal(part, full[1:3])


# -- tests/test_golden.py's hand-derived values, against the port -----------


def test_piecewise_linear_golden():
    # k=0.5, m=1, delta=(0.2, -0.4), s=(0.3, 0.6) -> see tests/test_golden.py
    g = trend.piecewise_linear(
        torch.tensor([[0.0, 0.25, 0.5, 0.75, 1.0]]),
        k=torch.tensor([0.5]), m=torch.tensor([1.0]),
        delta=torch.tensor([[0.2, -0.4]]), s=torch.tensor([[0.3, 0.6]]),
    )
    npt.assert_allclose(g.numpy()[0], [1.0, 1.125, 1.29, 1.405, 1.48],
                        rtol=1e-6)


def test_step_weighted_sum_boundary_golden():
    # Active AT its own timestamp: t=0.29 -> 0; 0.30 -> 1; 0.59 -> 1; 0.60 -> 11
    out = trend.step_weighted_sum(torch.tensor([[1.0, 10.0]]),
                                  torch.tensor([[0.29, 0.30, 0.59, 0.60]]),
                                  torch.tensor([[0.3, 0.6]]))
    npt.assert_allclose(out.numpy()[0], [0.0, 1.0, 1.0, 11.0], atol=1e-6)


def test_fourier_features_golden():
    feats = fourier_features(np.array([0.0, 1.75, 3.5]), period=7.0, order=2)
    want = np.array([[0.0, 1.0, 0.0, 1.0],
                     [1.0, 0.0, 0.0, -1.0],
                     [0.0, -1.0, 0.0, 1.0]])
    npt.assert_allclose(feats, want, atol=2e-7)


def test_logistic_gamma_golden():
    # gamma_1 = (0.5 - 0.4) * (1 - 1/1.5) = 1/30
    gamma = trend._logistic_gamma(torch.tensor([1.0]), torch.tensor([0.4]),
                                  torch.tensor([[0.5]]),
                                  torch.tensor([[0.5]]))
    npt.assert_allclose(gamma.numpy()[0], [1.0 / 30.0], rtol=1e-6)


def test_logistic_trend_golden():
    g = trend.logistic(torch.tensor([[0.25, 0.5, 1.0]]),
                       cap=torch.full((1, 3), 2.0), k=torch.tensor([1.0]),
                       m=torch.tensor([0.4]), delta=torch.tensor([[0.5]]),
                       s=torch.tensor([[0.5]]))
    npt.assert_allclose(g.numpy()[0], [0.92514030, 1.04995837, 1.40113428],
                        rtol=1e-6)


def test_uniform_changepoints_golden():
    s = trend.uniform_changepoints(np.array([0.0]), np.array([1.0]), 4, 0.8)
    npt.assert_allclose(s[0], [0.2, 0.4, 0.6, 0.8], rtol=1e-6)
