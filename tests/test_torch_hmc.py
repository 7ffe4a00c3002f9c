"""The port's batched HMC sampler against the JAX package's (``ops/hmc.py``
and ``mcmc_core``), on the CPU.

Held step by step on the same inputs made from numpy seeds, and on the
JAX package's own variates (reproduced from its key splits: a
transition's ``k_mom, k_jit, k_acc``, a run's ``split(key, warmup +
samples + 1)``): the leapfrog, one transition, dual averaging, the
Welford metric and the warmup's phase switch, a whole short run.  Float32
tolerance (rtol 2e-5, atol 1e-6): the same float32 arithmetic, where XLA
may fuse a multiply-add or sum in another order; a whole run rtol 1e-4,
atol 1e-5, the rounding of 13 transitions compounding.  The log density and its
gradient: the loss tests' rule (loss rtol 2e-5; gradient within 2e-4 of
1 + the row's largest entry).  ``split_rhat_ess``: blocked against
unblocked bitwise, against the JAX package's within 1e-12.  Then in
distribution: the Gaussian-moments target of ``tests/test_hmc.py``, and a
short Prophet posterior against the JAX package's sampler by the z rule
(per (series, parameter) z = |mean1 - mean2| / sqrt(var1/ESS1 +
var2/ESS2); at most 1% of z above 4, median z below 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import loss as jloss
from tsspark_tpu.models.prophet import model as jmodel
from tsspark_tpu.ops import hmc as jhmc
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import model as tmodel
from tsspark_tpu_torch.ops import hmc as thmc

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6
T = torch.from_numpy
J = jnp.asarray


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _gaussian(b=4, p=6, seed=0):
    """B independent anisotropic Gaussians in both packages."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 3.0, (b, p)).astype(np.float32)
    sd = (10.0 ** rng.uniform(-1, 1, (b, p))).astype(np.float32)

    def jax_fn(th):
        z = (th - J(mu)) / J(sd)
        return -0.5 * jnp.sum(z * z, axis=-1), -(th - J(mu)) / J(sd * sd)

    def torch_fn(th):
        z = (th - T(mu)) / T(sd)
        return -0.5 * torch.sum(z * z, dim=-1), -(th - T(mu)) / T(sd * sd)

    return mu, sd, jax_fn, torch_fn


def _states(b, p, seed=1):
    """The same mid-warmup chain state in both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    leaves = dict(
        theta=f(b, p), logp=f(b), grad=f(b, p),
        inv_mass=np.exp(f(b, p)).astype(np.float32),
        log_step=(f(b) * 0.3 - 2.0).astype(np.float32),
        log_step_avg=(f(b) * 0.3 - 2.0).astype(np.float32),
        da_stat=(0.1 * f(b)).astype(np.float32),
        da_mu=f(b), w_mean=f(b, p),
        w_m2=np.abs(f(b, p)).astype(np.float32) * 5,
    )
    count = np.float32(7.0)
    js = jhmc._ChainState(w_count=J(count),
                          **{k: J(v) for k, v in leaves.items()})
    ts = thmc.ChainState(w_count=count, **{k: T(v) for k, v in leaves.items()})
    return js, ts


def _jax_draws(key, b, p):
    k_mom, k_jit, k_acc = jax.random.split(key, 3)
    f32 = jnp.float32
    return tuple(T(np.array(a)) for a in (
        jax.random.normal(k_mom, (b, p), f32),
        jax.random.uniform(k_jit, (b,), f32),
        jax.random.uniform(k_acc, (b,), f32)))


def _assert_state(ts, js, fields=None):
    for f in fields or thmc.ChainState._fields:
        _close(getattr(ts, f), getattr(js, f))


def test_leapfrog_matches_jax():
    b, p = 4, 6
    _, _, jfn, tfn = _gaussian(b, p)
    js, ts = _states(b, p)
    rng = np.random.default_rng(3)
    r = rng.normal(0, 1, (b, p)).astype(np.float32)
    eps = np.exp(rng.normal(-2, 0.3, (b, 1))).astype(np.float32)
    got = thmc._leapfrog(tfn, ts.theta, T(r), ts.grad, T(eps), ts.inv_mass, 5)
    want = jhmc._leapfrog(jfn, js.theta, J(r), js.grad, J(eps), js.inv_mass, 5)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("jitter", [0.2, 0.0])
def test_transition_fed_the_jax_draws_matches(jitter):
    b, p = 8, 6
    mu, sd, jfn, tfn = _gaussian(b, p, seed=4)
    js, ts = _states(b, p, seed=5)
    # Chains near the target's mode with a metric near its variance and
    # step sizes from small to far too large: accepted, rejected and
    # divergent (energy error past 5) proposals side by side.
    rng = np.random.default_rng(6)
    theta = (mu + sd * rng.normal(0, 1, (b, p))).astype(np.float32)
    log_step = np.linspace(-3.0, 1.5, b).astype(np.float32)
    inv_mass = (sd * sd * np.exp(rng.normal(0, 0.3, (b, p)))).astype(
        np.float32)
    jlp, jg = jfn(J(theta))
    tlp, tg = tfn(T(theta))
    js = js._replace(theta=J(theta), logp=jlp, grad=jg,
                     inv_mass=J(inv_mass), log_step=J(log_step))
    ts = ts._replace(theta=T(theta), logp=tlp, grad=tg,
                     inv_mass=T(inv_mass), log_step=T(log_step))
    cfg_kw = dict(num_leapfrog=6, step_jitter=jitter,
                  divergence_threshold=5.0)
    jc, tc = jcfg.McmcConfig(**cfg_kw), tcfg.McmcConfig(**cfg_kw)
    key = jax.random.PRNGKey(7)
    js2, jacc, jdiv = jhmc._hmc_transition(key, js, jfn, jc)
    ts2, tacc, tdiv = thmc._hmc_transition(ts, tfn, tc,
                                           *_jax_draws(key, b, p))
    moved = np.any(np.asarray(js2.theta) != theta, axis=1)
    jdiv = np.asarray(jdiv)
    assert moved.any() and (~moved & ~jdiv).any() and jdiv.any()
    _assert_state(ts2, js2, ("theta", "logp", "grad"))
    _close(tacc, jacc)
    assert np.array_equal(tdiv.numpy(), jdiv)


def test_dual_averaging_and_welford_match_jax():
    b, p = 6, 5
    js, ts = _states(b, p, seed=8)
    acc = np.random.default_rng(9).uniform(0, 1, b).astype(np.float32)
    jc, tc = jcfg.McmcConfig(), tcfg.McmcConfig()
    for i in (1.0, 2.0, 37.0):
        _assert_state(thmc._da_update(ts, T(acc), np.float32(i), tc),
                      jhmc._da_update(js, J(acc), jnp.float32(i), jc),
                      ("da_stat", "log_step", "log_step_avg"))
    theta = np.random.default_rng(10).normal(0, 2, (b, p)).astype(np.float32)
    tw = thmc._welford_update(ts, T(theta))
    jw = jhmc._welford_update(js, J(theta))
    _assert_state(tw, jw, ("w_mean", "w_m2"))
    assert tw.w_count == float(jw.w_count)
    for reg in (True, False):
        _close(thmc._welford_var(tw, reg), jhmc._welford_var(jw, reg))


def test_warmup_switch_matches_jax():
    """The phase switch (the JAX package's ``switch`` inside ``sample``,
    written out here from its own helpers): the metric from the Welford
    window, the averaged step as the new start, adaptation restarted."""
    b, p = 5, 4
    js, ts = _states(b, p, seed=14)
    var = jhmc._welford_var(js)
    ls = js.log_step_avg
    want = js._replace(
        inv_mass=var, log_step=ls, log_step_avg=ls,
        da_stat=jnp.zeros_like(js.da_stat), da_mu=jnp.log(10.0) + ls,
        w_count=jnp.zeros_like(js.w_count),
        w_mean=jnp.zeros_like(js.w_mean), w_m2=jnp.zeros_like(js.w_m2))
    got = thmc._switch(ts)
    _assert_state(got, want, [f for f in thmc.ChainState._fields
                              if f != "w_count"])
    assert got.w_count == 0.0


def test_whole_run_fed_the_jax_draws_matches():
    """Warmup (both phases, the switch, the freeze) and sampling, on the
    JAX package's key sequence: draws, acceptance, step size, metric and
    divergences."""
    b, p = 4, 6
    _, _, jfn, tfn = _gaussian(b, p, seed=11)
    kw = dict(num_samples=5, num_warmup=8, num_leapfrog=4)
    jc, tc = jcfg.McmcConfig(**kw), tcfg.McmcConfig(**kw)
    theta0 = np.random.default_rng(12).normal(0, 1, (b, p)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = jhmc.sample(jfn, J(theta0), key, jc)
    keys = jax.random.split(key, kw["num_warmup"] + kw["num_samples"] + 1)
    got = thmc.sample(tfn, T(theta0), None, tc,
                      draws=lambda i: _jax_draws(keys[i], b, p))
    for f in thmc.HmcResult._fields:
        _close(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-5)


def _prophet_case(b=3, n=160, seed=0, t_len=None):
    cfgs = [mod.ProphetConfig(
        seasonalities=(mod.SeasonalityConfig("weekly", 7.0, 3),),
        n_changepoints=5) for mod in (jcfg, tcfg)]
    rng = np.random.default_rng(seed)
    ds = np.arange(n, dtype=np.float64)
    season = 1.5 * np.sin(2 * np.pi * ds / 7.0)
    y = 10.0 + 0.02 * ds + season + rng.normal(0, 0.4, (b, n))
    return cfgs, ds, y


def test_logdensity_and_gradient_match_jax():
    (jc, tc), ds, y = _prophet_case(b=4)
    jdata, _ = jdesign.prepare_fit_data(J(ds), J(y), jc)
    tdata, _ = tdesign.prepare_fit_data(ds, y, tc)
    tdata = tdesign.fitdata_to_device(tdata, "cpu")
    # K3's prerequisites: t rising along each row, changepoints ascending.
    assert bool((tdata.t[:, 1:] > tdata.t[:, :-1]).all())
    assert bool((tdata.s[:, 1:] >= tdata.s[:, :-1]).all())
    rng = np.random.default_rng(2)
    theta = rng.normal(0, 0.3, (4, tc.num_params)).astype(np.float32)
    theta[:, 2] = np.log(rng.uniform(0.05, 0.5, 4))

    f, g = jloss.value_and_grad_batch(J(theta), jdata, jc)
    lp_want = -f + J(theta)[:, 2]
    g_want = np.asarray((-g).at[:, 2].add(1.0))
    lp, grad = tmodel.mcmc_logdensity(tdata, tc)(T(theta))
    _close(lp, lp_want, rtol=2e-5, atol=0)
    scale = 1.0 + np.abs(g_want).max(axis=1, keepdims=True)
    assert (np.abs(grad.numpy() - g_want) <= 2e-4 * scale).all()


@pytest.mark.parametrize("block,threads", [(1, 1), (3, 2), (7, 3)])
def test_split_rhat_ess_blocked_is_unblocked_and_jax(block, threads):
    rng = np.random.default_rng(block)
    s, b, p = 60, 11, 5
    x = np.cumsum(rng.normal(0, 1, (s, b, p)), axis=0).astype(np.float32)
    x[:, 2, 1] = 3.0  # a constant marginal: converged by convention
    whole = thmc.split_rhat_ess(T(x), block=b, threads=1)
    part = thmc.split_rhat_ess(T(x), block=block, threads=threads)
    for w, q in zip(whole, part):
        assert np.array_equal(w, q)
    for got, want in zip(whole, jhmc.split_rhat_ess(x)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        thmc.split_rhat_ess(x[:3])


@pytest.mark.parametrize("s", [60, 301])
def test_split_rhat_ess_card_arithmetic_is_numpys_at_float64(s):
    """The card's path (``_split_rhat_ess_block_torch``, here run on CPU
    tensors) against the host's numpy block and the JAX package's
    ``split_rhat_ess``: float64 tolerance (the FFT's and the sums'
    order are the device's), every stopping decision of the ESS the
    same; a constant marginal and a chain whose halves part."""
    rng = np.random.default_rng(s)
    b, p = 13, 6
    phi = rng.uniform(0.0, 0.99, (b, p))
    x = np.zeros((s, b, p))
    e = rng.normal(0, 1, (s, b, p))
    for t in range(1, s):
        x[t] = phi * x[t - 1] + e[t]
    x[:, 4, 2] = 3.0
    x[: s // 2, 7] += 4.0
    got = thmc._split_rhat_ess_block_torch(torch.from_numpy(x))
    want = thmc._split_rhat_ess_block(x)
    for g, w, j in zip(got, want, jhmc.split_rhat_ess(x)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-12, atol=1e-12)
    assert got[0][4, 2] == 1.0 and got[1][4, 2] == 2 * (s // 2)


def test_hmc_recovers_gaussian_moments():
    """tests/test_hmc.py's target on the port's sampler and generator."""
    b, p = 4, 6
    mu, sd, _, tfn = _gaussian(b, p)
    cfg = tcfg.McmcConfig(num_samples=600, num_warmup=400, num_leapfrog=16)
    res = thmc.sample(tfn, torch.zeros((b, p)),
                      torch.Generator().manual_seed(1), cfg)
    samples = res.samples.numpy()
    assert samples.shape == (600, b, p)
    assert int(res.divergences.sum()) == 0
    assert np.all(res.accept_rate.numpy() > 0.55)
    mean_err = np.abs(samples.mean(0) - mu) / sd
    assert mean_err.max() < 0.35
    sd_ratio = samples.std(0) / sd
    assert sd_ratio.min() > 0.6 and sd_ratio.max() < 1.5
    mass_ratio = res.inv_mass.numpy() / (sd * sd)
    assert np.median(mass_ratio) == pytest.approx(1.0, rel=0.6)


def z_scores(a, b):
    """Per (series, parameter) |mean_a - mean_b| over the two chains'
    Monte-Carlo standard errors (variance over ESS, from
    ``split_rhat_ess``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ess_a = thmc.split_rhat_ess(a)[1]
    ess_b = thmc.split_rhat_ess(b)[1]
    se2 = a.var(0, ddof=1) / ess_a + b.var(0, ddof=1) / ess_b
    return np.abs(a.mean(0) - b.mean(0)) / np.sqrt(np.maximum(se2, 1e-30))


def test_prophet_posterior_matches_jax_in_distribution():
    (jc, tc), ds, y = _prophet_case()
    kw = dict(num_samples=120, num_warmup=150, num_leapfrog=8)
    want = jmodel.ProphetModel(jc).fit_mcmc(
        J(ds), J(y), mcmc_config=jcfg.McmcConfig(**kw), seed=0)
    got = tmodel.ProphetModel(tc, device="cpu").fit_mcmc(
        ds, y, mcmc_config=tcfg.McmcConfig(**kw), seed=0)
    assert tuple(got.samples.shape) == tuple(want.samples.shape)
    assert got.rhat.shape == got.ess.shape == (3, tc.num_params)
    z = z_scores(got.samples.numpy(), np.asarray(want.samples))
    assert (z > 4).mean() <= 0.01, np.sort(z.ravel())[-5:]
    assert np.median(z) < 1.0, np.median(z)


def test_mcmc_rejects_bad_configs():
    with pytest.raises(ValueError):
        tcfg.McmcConfig(num_warmup=1)
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg.McmcConfig(), target_accept=1.0)
