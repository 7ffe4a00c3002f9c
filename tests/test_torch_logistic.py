"""Logistic growth in the port against the JAX package: eval config 4
(``wiki_logistic_like``, logistic growth with a known capacity, weekly
multiplicative seasonality, 15 changepoints) from its data to its fit and
its sampled bands, on the same inputs made from numpy seeds.

Tolerances, with their reasons:
  * data: bitwise (the same numpy generator);
  * the trend simulation's scan against the per-sample recompute it
    replaces: bitwise (the same sums in the same order, see
    ``predict._logistic_paths``);
  * bands fed the JAX package's draws: rtol 1e-5, atol 1e-6 * y_scale,
    as tests/test_torch_forecast.py (changepoint and feature sums in
    other orders);
  * a 10-iteration fit: per-series loss within 1e-4 relative — the two
    solvers' float32 sums part by ~3e-5 of the loss there;
  * the full fit (``-m slow``): ``chip_smoke.LIMITS4`` per series and on
    average, and mean train sMAPE within 0.05 (tests/test_backends.py's
    budget): at 1,080 days a series' loss is ~1e3 nats and two float32
    lockstep solvers stop at its noise floor at different points;
  * the logistic gradient at rates k_j near 0, both packages' float32
    against the plain version in float64: the port no further than
    ``F64_MEDIAN_FACTOR`` times the JAX package on the median row and
    ``F64_WORST_FACTOR`` times on the worst (see the test).
The CUDA kernels' logistic branches are held against their plain
versions by the card-only tests at the end (skipped without a card) and
by ``chip_smoke.py``.
"""

import dataclasses
import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.backends.registry import get_backend as jget
from tsspark_tpu.data import datasets as jdatasets
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import loss as jloss
from tsspark_tpu.models.prophet import predict as jpredict
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.data.datasets import wiki_logistic_like
from tsspark_tpu_torch.eval import configs
from tsspark_tpu_torch.kernels import bands as bk
from tsspark_tpu_torch.kernels import loss as lk
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import predict as tpredict
from tsspark_tpu_torch.models.prophet import trend
from tsspark_tpu_torch.models.prophet.params import unpack

torch.set_num_threads(2)

CPU = torch.device("cpu")
DAYS = 1200
SPLIT = configs.split_point(DAYS)  # 1,080 days fitted


def _jax_config4():
    return jcfg.ProphetConfig(
        growth="logistic",
        seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 3,
                                              mode="multiplicative"),),
        n_changepoints=15)


def _fit_args(batch):
    return (batch.ds[:SPLIT], batch.y[:, :SPLIT]), dict(
        mask=batch.mask[:, :SPLIT], cap=batch.cap[:, :SPLIT])


# -- (a) the data ------------------------------------------------------------

@pytest.mark.parametrize("n,days,seed", [(8, 1200, 3), (37, 300, 2)])
def test_wiki_logistic_like_is_the_jax_packages(n, days, seed):
    got = wiki_logistic_like(n, days, seed=seed)
    want = jdatasets.wiki_logistic_like(n, days, seed=seed)
    for field in ("ds", "y", "mask", "series_ids", "cap"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


# -- (b) the scan against the per-sample recompute it replaces ---------------

def _per_sample_recompute(theta, data, config, u, lap):
    """The trend simulation's logistic branch as the JAX package writes it
    (and the port did before its scan): ``trend.logistic`` over the
    history changepoints and one more changepoint at every grid step, per
    sample, with the same sampled deltas."""
    p = unpack(theta, config)
    new_delta = tpredict.sampled_deltas(p, data, config, u, lap)
    t_clamped = torch.clamp(data.t, min=1.0 + 1e-6)
    s_ext = torch.cat([data.s, t_clamped], dim=-1)
    return torch.stack([
        trend.logistic(data.t, data.cap, p.k, p.m,
                       torch.cat([p.delta, new_delta[i]], dim=-1), s_ext)
        for i in range(u.shape[0])])


@pytest.mark.parametrize("rates", ["near_zero", "clear_of_zero"])
def test_logistic_scan_is_the_per_sample_recompute(rates):
    """Bitwise, on a grid whose last 40 steps are future (one of them
    inside (1, 1 + 1e-6), where a step's changepoint is clamped past it),
    at rates far from 0 and at rates k_j near 0 where the offset
    recursion is ill-conditioned."""
    cfg = dataclasses.replace(configs.CONFIG4, n_changepoints=6)
    rng = np.random.default_rng(0 if rates == "near_zero" else 1)
    b, t_len, s = 9, 120, 11
    t = np.concatenate([np.linspace(0.0, 1.0, 80),
                        1.0 + np.arange(1, 41) / 80.0]).astype(np.float32)
    t[80] = np.float32(1.0000005)
    theta = rng.normal(0.0, 0.05, (b, cfg.num_params)).astype(np.float32)
    theta[:, 3:9] = rng.laplace(0.0, 0.05, (b, 6))
    if rates == "near_zero":
        theta[:, 0] = rng.normal(0.0, 0.05, b)
        theta[0, 0] = 0.0
        theta[0, 3:9] = 0.0
    else:
        theta[:, 0] = rng.uniform(2.0, 8.0, b)
    zeros = torch.zeros((b, t_len))
    data = tdesign.FitData(
        t=torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(t, (b, t_len)))),
        y=zeros, mask=zeros,
        s=torch.from_numpy(np.sort(rng.uniform(0.0, 0.8, (b, 6)), 1)
                           .astype(np.float32)),
        cap=torch.from_numpy((rng.uniform(1.5, 3.0, (b, 1))
                              * np.ones((1, t_len))).astype(np.float32)),
        X_season=torch.zeros((t_len, cfg.num_seasonal_features)),
        X_reg=torch.zeros((b, t_len, 0)),
        prior_scales=torch.ones(cfg.num_features),
        mult_mask=torch.ones(cfg.num_features))
    u = torch.from_numpy(rng.uniform(size=(s, b, t_len)).astype(np.float32))
    lap = torch.from_numpy(rng.laplace(size=(s, b, t_len)).astype(np.float32))
    th = torch.from_numpy(theta)
    got = tpredict._simulate_trends(th, data, cfg, u, lap)
    want = _per_sample_recompute(th, data, cfg, u, lap)
    assert got.shape == (s, b, t_len)
    assert torch.equal(got, want)
    # Simulated changepoints moved the future, not the history.
    assert not torch.equal(got[:, :, 81:], got[:1, :, 81:].expand(s, -1, -1))
    assert torch.equal(got[:, :, :80], got[:1, :, :80].expand(s, -1, -1))


# -- (c) bands fed the JAX package's draws ------------------------------------

def _jax_draws(key, shape):
    """The JAX package's variates, by its own key-split sequence
    (predict.forecast, then _simulate_trends)."""
    k_tr, k_noise = jax.random.split(key)
    k_bern, k_lap = jax.random.split(k_tr)
    f32 = jnp.float32
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k_bern, shape, dtype=f32),
        jax.random.laplace(k_lap, shape, dtype=f32),
        jax.random.normal(k_noise, shape, dtype=f32),
    ))


def test_config4_bands_fed_the_jax_draws_match_forecast_jit():
    """Config 4's shapes (weekly multiplicative order 3, 15 changepoints,
    1,200 days of which 120 are future, a capacity) at fitted-like
    parameters: rates k in [3, 8] (scaled units) with Laplace changepoint
    deltas, as config 4's fits end."""
    b, s = 12, 32
    batch = wiki_logistic_like(b, DAYS, seed=5)
    tc, jc = configs.CONFIG4, _jax_config4()
    _, meta = tdesign.prepare_fit_data(batch.ds[:SPLIT], batch.y[:, :SPLIT],
                                       tc, cap=batch.cap[:, :SPLIT])
    rng = np.random.default_rng(4)
    theta = rng.normal(0.0, 0.05, (b, tc.num_params)).astype(np.float32)
    theta[:, 0] = rng.uniform(3.0, 8.0, b)
    theta[:, 1] = rng.uniform(0.2, 0.5, b)
    theta[:, 2] = np.log(rng.uniform(0.02, 0.06, b))
    theta[:, 3:18] = rng.laplace(0.0, 0.1, (b, 15))
    data_t = tpredict.prepare_predict_data(batch.ds, meta, tc, CPU,
                                           cap=batch.cap)
    data_j = jpredict.prepare_predict_data(batch.ds, meta, jc, cap=batch.cap)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, (s,) + tuple(data_t.t.shape))
    got = tpredict.forecast(torch.from_numpy(theta), data_t, meta, tc,
                            draws=draws, return_samples=True)
    want = jpredict.forecast_jit(jnp.asarray(theta), data_j, meta, jc,
                                 key=key, num_samples=s,
                                 return_samples=True)
    scale = meta.y_scale[:, None]
    for k in ("yhat_lower", "yhat_upper", "trend_lower", "trend_upper",
              "yhat", "trend"):
        a, w = np.asarray(got[k]), np.asarray(want[k])
        assert (np.abs(a - w) <= 1e-6 * scale + 1e-5 * np.abs(w)).all(), k
    a, w = got["yhat_samples"].numpy(), np.asarray(want["yhat_samples"])
    assert (np.abs(a - w) <= 1e-6 * scale[None] + 1e-5 * np.abs(w)).all()
    # The future is sampled: bands open past the history.
    width = got["trend_upper"] - got["trend_lower"]
    assert float(width[:, -1].min()) > 0.0


# -- (d) the fit --------------------------------------------------------------

def test_config4_short_fit_matches_jax():
    """Config 4 on 8 series over its full 1,080 fitted days, 10 solver
    iterations and no rescue pass in both packages: the same trajectory
    up to float32 sums in other orders."""
    batch = wiki_logistic_like(8, DAYS, seed=3)
    args, kw = _fit_args(batch)
    solver = dataclasses.replace(configs.SOLVER4, max_iters=10)
    port = get_backend("cuda", configs.CONFIG4, solver, device="cpu",
                       rescue=False).fit(*args, **kw)
    ref = jget("tpu", _jax_config4(), jcfg.SolverConfig(max_iters=10),
               rescue=False).fit(*args, **kw)
    ref_loss = np.asarray(ref.loss)
    assert np.isfinite(port.loss).all()
    np.testing.assert_array_less(np.abs(port.loss - ref_loss),
                                 1e-4 * np.abs(ref_loss))
    np.testing.assert_array_equal(port.n_iters, np.asarray(ref.n_iters))


def test_config4_cli_runs_on_the_cpu(monkeypatch, capsys):
    """``python -m tsspark_tpu_torch.eval.configs 4`` fits and
    scores eval config 4 end to end (2 series at scale 0.25, the solver
    cut to 3 iterations here; the full fit is the slow test's)."""
    import json
    import sys

    assert configs.CONFIG4.num_params == 3 + 15 + 6
    assert configs.SOLVER4.max_iters == 200
    monkeypatch.setattr(configs, "SOLVER4",
                        dataclasses.replace(configs.SOLVER4, max_iters=3))
    monkeypatch.setattr(sys, "argv", ["configs", "4", "--scale",
                                      "0.25", "--device", "cpu"])
    configs.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = out["config4"]
    assert run["n_series"] == 2 and run["n_timesteps"] == SPLIT
    assert np.isfinite(run["smape_train"]) and np.isfinite(
        run["smape_holdout"])


@pytest.mark.slow
def test_config4_fit_matches_jax():
    """Config 4 at 16 series (``config4_wiki_logistic``'s batch at scale
    2), the full 1,200 days, through the path ``config4_wiki_logistic``
    runs (``fit_and_forecast``) in the port's plain version and in the JAX
    package, both on the CPU: per-series loss against the JAX fit within
    ``chip_smoke.LIMITS4``'s bounds for two fits, mean train sMAPE within
    0.05."""
    batch = wiki_logistic_like(16, DAYS)
    _, port, fc, _ = configs.fit_and_forecast(
        configs.CONFIG4, batch, "cuda", configs.SOLVER4, device="cpu")
    jbk = jget("tpu", _jax_config4(), jcfg.SolverConfig(max_iters=200))
    args, kw = _fit_args(batch)
    ref = jbk.fit(*args, **kw)
    jfc = jbk.predict(ref, batch.ds, cap=batch.cap, num_samples=0)
    gap = port.loss.astype(np.float64) - np.asarray(ref.loss, np.float64)
    plain_mean, plain_series = chip_smoke.LIMITS4[:2]
    assert abs(gap.mean()) <= plain_mean and np.all(
        np.abs(gap) <= plain_series), gap
    s_port = configs.score(batch, fc)["smape_train"]
    s_jax = configs.score(batch, {"yhat": np.asarray(jfc["yhat"])})[
        "smape_train"]
    assert abs(s_port.mean() - s_jax.mean()) < 0.05


@functools.lru_cache(maxsize=2)
def _parity_case(seed):
    """``chip_smoke.py``'s config-4 parity subset (64 of 8,192 series,
    fitted on 1,080 days) of ``wiki_logistic_like(8192, 1200, seed)``,
    with the port's plain fit and scipy-oracle fit of it."""
    b = wiki_logistic_like(chip_smoke.C4_SERIES, DAYS, seed=seed)
    idx = chip_smoke.fit4_subset()
    args = (b.ds[:SPLIT], b.y[idx, :SPLIT])
    kw = dict(mask=b.mask[idx, :SPLIT], cap=b.cap[idx, :SPLIT])
    plain = get_backend("cuda", configs.CONFIG4, configs.SOLVER4,
                        device="cpu").fit(*args, **kw)
    oracle = get_backend("cpu", configs.CONFIG4, configs.SOLVER4).fit(
        *args, **kw)
    return args, kw, plain.loss, oracle.loss


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3])
def test_config4_parity_subset_against_jax(capsys, seed):
    """The readings that ``chip_smoke.LIMITS4`` rests on: on the config-4
    parity subset, the port's plain fit and the JAX package's, each
    against the other and the scipy oracle, both held to those limits.
    Prints them:
    ``pytest -m slow tests/test_torch_logistic.py -k parity_subset -s``."""
    args, kw, port, oracle = _parity_case(seed)
    ref = np.asarray(jget("tpu", _jax_config4(),
                          jcfg.SolverConfig(max_iters=200)).fit(
        *args, **kw).loss)
    port_vs_jax, failed = chip_smoke.loss_parity(port, ref, oracle,
                                                 chip_smoke.LIMITS4)
    jax_vs_port, failed_j = chip_smoke.loss_parity(ref, port, oracle,
                                                   chip_smoke.LIMITS4)
    with capsys.disabled():
        print(f"\nseed {seed}: port vs jax {port_vs_jax}\n"
              f"seed {seed}: jax vs port {jax_vs_port}")
    assert not failed and not failed_j


def _grad_delta_off_by_2_percent(theta, data, config, grad):
    f, g = _LOSS_ROWS(theta, data, config, grad)
    if g is not None:
        g = g.clone()
        g[:, 3:3 + config.n_changepoints] *= 0.98
    return f, g


_LOSS_ROWS = lk._loss_rows


@pytest.mark.slow
@pytest.mark.parametrize("fault,caught", [
    ("stuck at its init", True),
    ("cut at 40 iterations", True),
    ("gradient's changepoint block x0.98", False),
])
def test_config4_loss_parity_fails_planted_faults(monkeypatch, capsys, fault,
                                                  caught):
    """Faults planted in the port's config-4 fit (at run time, in this
    process) against its correct plain fit and the oracle on the parity
    subset: ``chip_smoke.loss_parity`` at ``LIMITS4`` fails each gross
    one; a gradient off by 2% moves the fit less than float32 does (the
    kernel-vs-plain checks hold the gradient)."""
    args, kw, plain, oracle = _parity_case(3)
    solver = configs.SOLVER4
    if fault == "stuck at its init":
        solver = dataclasses.replace(solver, max_iters=0)
    elif fault == "cut at 40 iterations":
        solver = dataclasses.replace(solver, max_iters=40)
    else:
        monkeypatch.setattr(lk, "_loss_rows", _grad_delta_off_by_2_percent)
    loss = get_backend("cuda", configs.CONFIG4, solver, device="cpu").fit(
        *args, **kw).loss
    readings, failed = chip_smoke.loss_parity(loss, plain, oracle,
                                              chip_smoke.LIMITS4)
    with capsys.disabled():
        print(f"\n{fault}: {readings} failed {failed}")
    assert bool(failed) == caught


# -- (e) the gradient at rates near 0 against float64 ---------------------------
# Near k_j = 0 the offset recursion divides by k_j, so a float32 gradient
# of either package is as far from the float64 one as the recursion's
# condition number makes it, and on the worst-conditioned row which
# package lands nearer is the luck of its rounding (seeds 0-3: the port
# 0.2-4.3 times the JAX package there, 0.8-0.9 times on the median row).
F64_MEDIAN_FACTOR = 2.0
F64_WORST_FACTOR = 10.0


def f64_distances(theta, data_t, data_j, tc, jc):
    """Per row, max |g - g64| / (1 + max |g64|) of the port's plain
    float32 gradient and of the JAX package's, g64 the plain version in
    float64."""
    data64 = tdesign.FitData(*(a.double() for a in data_t))
    g64 = lk.loss_plain(torch.from_numpy(theta).double(), data64, tc)[1]
    g64 = g64.numpy()
    g_port = lk.loss_plain(torch.from_numpy(theta), data_t, tc)[1].numpy()
    g_jax = np.asarray(jloss.value_and_grad_batch(jnp.asarray(theta), data_j,
                                                  jc)[1])
    scale = 1.0 + np.abs(g64).max(-1, keepdims=True)
    return tuple((np.abs(g.astype(np.float64) - g64) / scale).max(-1)
                 for g in (g_port, g_jax))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_logistic_gradient_near_zero_rates_against_float64(seed):
    """``chip_smoke.rates_near_zero`` rows (k ~ N(0, 0.05), row 0 with k
    and every delta 0) on a small logistic config: the port's plain
    float32 gradient is no further from the float64 one than the JAX
    package's (``F64_*_FACTOR``); row 0, where no rate is near its
    division's clamp, within 1e-6 in both."""
    rng = np.random.default_rng(seed)
    b, t_len = 32, 200
    jc, tc = (mod.ProphetConfig(
        growth="logistic", n_changepoints=6,
        seasonalities=(mod.SeasonalityConfig("weekly", 7.0, 3,
                                             mode="multiplicative"),))
        for mod in (jcfg, tcfg))
    ds = 18000.0 + np.arange(t_len, dtype=np.float64)
    cap = rng.uniform(5.0, 30.0, (b, 1)) * np.ones((1, t_len))
    y = cap * (0.3 + 0.4 / (1.0 + np.exp(-(np.arange(t_len) - 100) / 30.0)))
    y = y + rng.normal(0.0, 0.3, (b, t_len))
    data_t, _ = tdesign.prepare_fit_data(ds, y, tc, cap=cap)
    data_j, _ = jdesign.prepare_fit_data(ds, y, jc, as_numpy=True, cap=cap)
    data_t = tdesign.FitData(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in data_t))
    data_j = jdesign.FitData(*(jnp.asarray(a) for a in data_j))
    theta = chip_smoke.rates_near_zero(rng, b, tc)
    port, ref = f64_distances(theta, data_t, data_j, tc, jc)
    print(f"\nseed {seed}: row distance from float64, port / JAX: median "
          f"{np.median(port):.3g} / {np.median(ref):.3g}, worst "
          f"{port.max():.3g} / {ref.max():.3g}")
    assert np.median(port) <= F64_MEDIAN_FACTOR * np.median(ref)
    assert port.max() <= F64_WORST_FACTOR * ref.max()
    assert max(port[0], ref[0]) <= 1e-6


# -- the CUDA kernels' logistic branches against their plain versions ---------
# (card only)

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


_THETA = {"clear_of_zero": chip_smoke.logistic_theta,
          "near_zero": chip_smoke.rates_near_zero}


@pytest.mark.parametrize("rates", ["clear_of_zero", "near_zero"])
@pytest.mark.parametrize("per_series", [False, True])
def test_logistic_loss_kernel_matches_plain_on_the_card(card, per_series,
                                                        rates):
    """K3's logistic branch, value and gradient modes and a trial stack,
    within ``chip_smoke.GAP_RULE`` of its plain version, at rates far from
    0 and near it; a 21-trial stack (the trial-stack layout) gives each
    trial the row layout's bits."""
    rng = np.random.default_rng(0)
    cfg = configs.CONFIG4
    b, t_len = 64, SPLIT
    data = chip_smoke.synthetic_fit_data(rng, cfg, b, t_len, per_series,
                                         card)
    theta = torch.from_numpy(_THETA[rates](rng, b, cfg)).to(card)
    f_scale, g_scale = chip_smoke.loss_scales(theta, data, cfg)
    f_k, g_k = lk.loss(theta, data, cfg)
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    stack = torch.cat([theta, theta * 1.01]).contiguous()
    s_k, _ = lk.loss(stack, data, cfg, grad=False)
    s_p, _ = lk.loss_plain(stack, data, cfg, grad=False)
    assert chip_smoke._gap(f_k, f_p, f_scale, t_len) <= chip_smoke.GAP_TOL
    assert chip_smoke._gap(g_k, g_p, g_scale, t_len) <= chip_smoke.GAP_TOL
    assert chip_smoke._gap(s_k, s_p, f_scale.repeat(2), t_len) \
        <= chip_smoke.GAP_TOL
    trials = [theta * (1.0 + 0.01 * n) for n in range(21)]
    s21, _ = lk.loss(torch.cat(trials).contiguous(), data, cfg, grad=False)
    for n, part in enumerate(trials):
        row, _ = lk.loss(part.contiguous(), data, cfg, grad=False)
        assert torch.equal(s21[n * b:(n + 1) * b], row)


@pytest.mark.parametrize("rates", ["clear_of_zero", "near_zero"])
def test_logistic_bands_kernel_matches_plain_on_the_card(card, rates):
    """K2's logistic branch on given draws within 1e-5 of the plain scan,
    in the fused (S = 256) and the scratch (S = 3,000) designs, at rates
    far from 0 and near it."""
    rng = np.random.default_rng(1)
    cfg = configs.CONFIG4
    from tsspark_tpu_torch.kernels import forward as fk

    t = np.concatenate([np.linspace(0.0, 1.0, 100),
                        1.0 + np.arange(1, 21) / 99.0]).astype(np.float32)
    for b, s in ((32, 256), (4, 3000)):
        data = chip_smoke.synthetic_data(rng, cfg, b, t.size, False, card)
        data = data._replace(t=torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(t, (b, t.size)))).to(card))
        theta = torch.from_numpy(_THETA[rates](rng, b, cfg)).to(card)
        scale = torch.ones(b, device=card)
        floor = torch.zeros(b, device=card)
        _, det, add, mult = fk.forward(theta, data, cfg)
        gen = torch.Generator(device=card).manual_seed(3)
        draws = bk.sample_draws((s, b, t.size), gen, card)
        args = (theta, data, det, add, mult, scale, floor, cfg)
        got = bk.bands(*args, s, draws=draws)
        want = bk.bands_plain(*args, draws)
        assert chip_smoke._band_err(got, want, scale) <= 1e-5
