"""The port's batched ADVI (``uncertainty/advi.py``: K3's gradient on the
(K B, P) draw stack and K7's ELBO reduction and Adam step, their plain
versions on the CPU) against the JAX package's, at the calibration
smoke's small shape: 16 series x 120 days of ``demo_weekly_rows``,
weekly order 2, 3 changepoints (P = 10), from a MAP fit.

Tolerances, from readings on this shape (set at about 10x the largest):

* one ELBO step on the same numpy draws: losses rtol 1e-5 (read 2e-7);
  the (mu, rho) gradient rtol 1e-5 with an atol of 1e-5 x the row's
  largest |component| (read: 2e-6 of the row's largest on a component
  near 0, where the K3 and XLA sums of the loss's terms part in the last
  bits and the draws' cancellation leaves a few of them);
* 20 steps on the JAX package's own draws
  (``normal(fold_in(key, i), (K, B, P))``): mu and rho within 1e-5 +
  1e-4 |ref|, the ELBO within 1e-4 of |ref| (read: 1.2e-7 / 4.8e-7
  absolute, 1.1e-5 relative: 20 steps of Adam carry the last bits);
* 200 steps, each package on its own generator, in distribution: per
  series the max over parameters of |d mu| / sd (sd the JAX package's
  posterior sd) and of |log sd ratio| (``DIST_LIMITS``, with the planted
  faults that must fail them).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.uncertainty import advi as jadvi
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.data.datasets import demo_weekly_rows
from tsspark_tpu_torch.kernels import advi as advi_k
from tsspark_tpu_torch.kernels import loss as loss_k
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.uncertainty import advi as tadvi

torch.set_num_threads(2)

B, DAYS, K = 16, 120, 4
JCFG = jcfg.ProphetConfig(
    seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 2),),
    n_changepoints=3)
TCFG = tcfg.ProphetConfig(
    seasonalities=(tcfg.SeasonalityConfig("weekly", 7.0, 2),),
    n_changepoints=3)
P = TCFG.num_params

# In distribution over 200 steps, each package on its own draws.  Two
# statistics of the port's posterior against the JAX package's (key 0):
# the median over (series, parameter) of |d mu| / sd_ref, and the largest
# over series of |mean over parameters of d rho| (d log sd).  Readings on
# this shape: the JAX package against itself (keys 1, 2 against 0, and 2
# against 1) 0.191-0.229 and 0.149-0.178; the port (generator seeds 0-2)
# 0.192-0.265 and 0.119-0.182.  The planted fault of eps left out of the
# rho gradient reads 2.325 and 1.375.  (200 Adam steps at lr 0.05 leave
# each posterior a noisy iterate: two sound runs part by up to 5 sd on a
# single parameter, so the statistics are medians and means.  Dropping
# the entropy's -1 moves mean d rho by only -0.04 here, inside the sound
# spread: the one-step test catches that fault, see
# ``test_one_step_fails_a_dropped_entropy_term``.)
DIST_LIMITS = {"dmu_sd_median": 0.6, "drho_series_mean": 0.4}


@pytest.fixture(scope="module")
def setup():
    batch = demo_weekly_rows(0, B, n_steps=DAYS, seed=0)
    y = batch.y.astype(np.float32)
    tdata, _ = tdesign.prepare_fit_data(batch.ds, y, TCFG)
    jdata, _ = jdesign.prepare_fit_data(batch.ds, y, JCFG)
    fit = get_backend("cuda", TCFG, tcfg.SolverConfig(max_iters=25),
                      device="cpu").fit(batch.ds, y)
    theta = np.nan_to_num(fit.theta.numpy().astype(np.float32))
    return batch, y, tdata, jdata, theta


def _draws(seed, shape=(K, B, P)):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close_rows(got, want, rtol, row_frac):
    """|got - want| <= rtol |want| + row_frac x the row's largest |want|."""
    want = np.asarray(want)
    atol = row_frac * np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want) - rtol * np.abs(want)
    assert (err <= atol).all(), float((err / atol).max())


def _value_and_grad(mu, rho, data, config, eps):
    """(losses (B,), (g_mu, g_rho)): the counterpart of the reference's
    ``jax.value_and_grad`` of the summed ELBO, from the step's pieces: K3
    in gradient mode on the draw stack, then K7's formulas (their plain
    version)."""
    sd, stack = tadvi._stack(mu, rho, eps)
    f, g = loss_k.loss(stack, data, config, grad=True)
    inv_k = float(np.float32(1.0) / np.float32(eps.shape[0]))
    return (advi_k.elbo_losses(f, rho, eps.shape[0]),
            advi_k.elbo_grads(g, eps, sd, inv_k))


def _one_step_parity(setup) -> None:
    _, _, tdata, jdata, theta = setup
    rho = np.full((B, P), -3.0, np.float32) \
        + 0.2 * _draws(1, (B, P))
    for eps in (_draws(2), 3.0 * _draws(3)):
        def total(params, e):
            losses = jadvi._elbo_losses(params[0], params[1], jdata, JCFG, e)
            return losses.sum(), losses

        (_, jl), (jgm, jgr) = jax.value_and_grad(total, has_aux=True)(
            (jnp.asarray(theta), jnp.asarray(rho)), jnp.asarray(eps))
        dd = tdesign.fitdata_to_device(tdata, "cpu")
        args = (torch.from_numpy(theta), torch.from_numpy(rho), dd, TCFG,
                torch.from_numpy(eps))
        tl, (tgm, tgr) = _value_and_grad(*args)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(tadvi._elbo_losses(*args).numpy(),
                                   np.asarray(jl), rtol=1e-5)
        for got, want in ((tgm, jgm), (tgr, jgr)):
            _close_rows(got.numpy(), np.asarray(want), 1e-5, 1e-5)


def test_one_elbo_step_matches_the_jax_package(setup):
    _one_step_parity(setup)


def test_one_step_fails_a_dropped_entropy_term(setup, monkeypatch):
    monkeypatch.setattr(advi_k, "elbo_grads", _faulty("no_entropy"))
    with pytest.raises(AssertionError):
        _one_step_parity(setup)


def _jax_draws(key, shape):
    return lambda i: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)))


def test_twenty_steps_on_the_jax_packages_draws(setup):
    _, _, tdata, jdata, theta = setup
    key = jax.random.PRNGKey(3)
    want = jadvi.fit_advi(jnp.asarray(theta), jdata, key, JCFG,
                          jcfg.AdviConfig(num_steps=20))
    got = tadvi.fit_advi(theta, tdata, None, TCFG,
                         tcfg.AdviConfig(num_steps=20), device="cpu",
                         draws=_jax_draws(key, (K, B, P)))
    for name in ("mu", "rho"):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), ref,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo),
                               rtol=1e-4)


def _distance(mu, rho, ref_mu, ref_rho):
    """(median of |d mu| / sd_ref, max over series of |mean d rho|)."""
    return (float(np.median(np.abs(mu - ref_mu) / np.exp(ref_rho))),
            float(np.abs((rho - ref_rho).mean(-1)).max()))


def _within(dmu, drho) -> bool:
    return (dmu <= DIST_LIMITS["dmu_sd_median"]
            and drho <= DIST_LIMITS["drho_series_mean"])


def _faulty(kind):
    real = advi_k.elbo_grads

    def grads(g, eps, sd, inv_k):
        g_mu, g_rho = real(g, eps, sd, inv_k)
        if kind == "no_entropy":
            return g_mu, g_rho + 1.0
        return g_mu, real(g, torch.ones_like(eps), sd, inv_k)[1]
    return grads


@pytest.fixture(scope="module")
def whole_fits(setup):
    _, _, tdata, jdata, theta = setup
    want = jadvi.fit_advi(jnp.asarray(theta), jdata, jax.random.PRNGKey(0),
                          JCFG)
    got = tadvi.fit_advi(theta, tdata,
                         torch.Generator().manual_seed(0), TCFG,
                         device="cpu")
    return (np.asarray(want.mu), np.asarray(want.rho),
            got.mu.numpy(), got.rho.numpy())


def test_whole_fit_matches_the_jax_package_in_distribution(whole_fits):
    ref_mu, ref_rho, mu, rho = whole_fits
    assert np.isfinite(mu).all() and np.isfinite(rho).all()
    dmu, drho = _distance(mu, rho, ref_mu, ref_rho)
    assert _within(dmu, drho), (dmu, drho)


def test_planted_fault_fails_the_distribution_limits(setup, whole_fits,
                                                     monkeypatch):
    _, _, tdata, _, theta = setup
    ref_mu, ref_rho = whole_fits[:2]
    monkeypatch.setattr(advi_k, "elbo_grads", _faulty("no_eps_in_rho_grad"))
    bad = tadvi.fit_advi(theta, tdata, torch.Generator().manual_seed(0),
                         TCFG, device="cpu")
    dmu, drho = _distance(bad.mu.numpy(), bad.rho.numpy(), ref_mu, ref_rho)
    assert not _within(dmu, drho), (dmu, drho)


def _state(seed, b=5, p=7):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "g": 50 * f32(K * b, p), "f": 100 * f32(K * b), "eps": f32(K, b, p),
        "rho": -3 + 0.3 * f32(b, p), "mu": f32(b, p),
        "m_mu": 0.1 * f32(b, p), "v_mu": np.abs(f32(b, p)),
        "m_rho": 0.1 * f32(b, p), "v_rho": np.abs(f32(b, p)),
    }


@pytest.mark.parametrize("step", [0, 7, 199])
def test_plain_k7_is_the_formula(step):
    """advi_plain against the step's formula written out in numpy float32,
    each operation in the same order: the same bits; and against the
    reference's own update (its jnp expressions on the same gradient)
    to float32 rounding."""
    s = _state(step)
    advi = tcfg.AdviConfig()
    sc = advi_k.adam_scalars(advi, step)
    sd = np.exp(s["rho"])
    t = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    loss = advi_k.advi_plain(t["g"], t["f"], t["eps"], torch.from_numpy(sd),
                             t["mu"], t["rho"], t["m_mu"], t["v_mu"],
                             t["m_rho"], t["v_rho"], sc)
    f32 = np.float32
    b, p = s["mu"].shape
    g = s["g"].reshape(K, b, p)
    gs = [g[k] * f32(sc.inv_k) for k in range(K)]
    g_mu, g_e = gs[0], gs[0] * s["eps"][0]
    for k in range(1, K):
        g_mu = g_mu + gs[k]
        g_e = g_e + gs[k] * s["eps"][k]
    g_rho = g_e * sd - f32(1)
    fk = s["f"].reshape(K, b)
    lw = fk[0]
    for k in range(1, K):
        lw = lw + fk[k]
    rs = s["rho"][:, 0]
    for j in range(1, p):
        rs = rs + s["rho"][:, j]
    want_loss = lw / f32(K) - rs
    np.testing.assert_array_equal(loss.numpy(), want_loss)
    b1, b2 = f32(sc.b1), f32(sc.b2)
    for name, grad in (("mu", g_mu), ("rho", g_rho)):
        m = b1 * s[f"m_{name}"] + f32(sc.omb1) * grad
        v = b2 * s[f"v_{name}"] + (f32(sc.omb2) * grad) * grad
        new = s[name] - (f32(sc.lr) * (m / f32(sc.c1))) \
            / (np.sqrt(v / f32(sc.c2)) + f32(sc.eps))
        np.testing.assert_array_equal(t[f"m_{name}"].numpy(), m)
        np.testing.assert_array_equal(t[f"v_{name}"].numpy(), v)
        np.testing.assert_array_equal(t[name].numpy(), new)
        # The reference's update (advi.py:93-103) on the same gradient.
        jb1 = jnp.asarray(advi.adam_b1, jnp.float32)
        jb2 = jnp.asarray(advi.adam_b2, jnp.float32)
        tt = jnp.asarray(step + 1, jnp.float32)
        jm = jb1 * s[f"m_{name}"] + (1.0 - jb1) * grad
        jv = jb2 * s[f"v_{name}"] + (1.0 - jb2) * grad * grad
        jp = s[name] - advi.learning_rate * (jm / (1.0 - jb1 ** tt)) \
            / (jnp.sqrt(jv / (1.0 - jb2 ** tt)) + advi.adam_eps)
        np.testing.assert_allclose(t[name].numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_nonfinite_draws_propagate_as_in_the_reference():
    s = _state(3)
    s["g"][2, 1] = np.nan
    t = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    sc = advi_k.adam_scalars(tcfg.AdviConfig(), 0)
    advi_k.advi_plain(t["g"], t["f"], t["eps"], t["rho"].exp(), t["mu"],
                      t["rho"], t["m_mu"], t["v_mu"], t["m_rho"],
                      t["v_rho"], sc)
    assert np.isnan(t["mu"].numpy()[2, 1]) and np.isnan(t["rho"].numpy()[2, 1])
    assert np.isfinite(np.delete(t["mu"].numpy(), 2, axis=0)).all()


def _post(seed):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((4, P)).astype(np.float32)
    return mu, (mu - 3).astype(np.float32), rng.standard_normal(4) \
        .astype(np.float32)


def test_posterior_files_load_in_either_package(tmp_path):
    mu, rho, elbo = _post(0)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    tadvi.save_posterior(str(port_dir), tadvi.AdviPosterior(
        torch.from_numpy(mu), torch.from_numpy(rho),
        torch.from_numpy(elbo)), seed=4, num_steps=200)
    jadvi.save_posterior(str(jax_dir), jadvi.AdviPosterior(
        jnp.asarray(mu), jnp.asarray(rho), jnp.asarray(elbo)),
        seed=4, num_steps=200)
    for load in (tadvi.load_posterior, jadvi.load_posterior):
        for d in (port_dir, jax_dir):
            post, header = load(str(d))
            np.testing.assert_array_equal(np.asarray(post.mu), mu)
            np.testing.assert_array_equal(np.asarray(post.rho), rho)
            np.testing.assert_array_equal(np.asarray(post.elbo), elbo)
            assert header["seed"] == 4 and header["num_steps"] == 200
    with np.load(str(port_dir / tadvi.POSTERIOR_FILE)) as a, \
            np.load(str(jax_dir / jadvi.POSTERIOR_FILE)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert tadvi.load_posterior(str(tmp_path / "nowhere")) is None


@pytest.mark.parametrize("field,value", [
    ("numerics_rev", tcfg.NUMERICS_REV + 1), ("format", 2)])
def test_a_mismatched_posterior_loads_as_none(tmp_path, field, value):
    mu, rho, elbo = _post(1)
    header = {"format": tadvi.POSTERIOR_FORMAT,
              "numerics_rev": tcfg.NUMERICS_REV, "n_series": 4,
              "num_params": P, "seed": 0, "num_steps": 1, field: value}
    buf = io.BytesIO()
    np.savez(buf, header=np.frombuffer(json.dumps(header).encode(),
                                       np.uint8), mu=mu, rho=rho, elbo=elbo)
    with open(os.path.join(tmp_path, tadvi.POSTERIOR_FILE), "wb") as fh:
        fh.write(buf.getvalue())
    assert tadvi.load_posterior(str(tmp_path)) is None
    assert jadvi.load_posterior(str(tmp_path)) is None


# -- the CUDA kernels (card only) ---------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 64, 10), (4, 1000, 54), (3, 7, 70)])
def test_k7_matches_its_plain_version_bitwise_on_the_card(card, shape):
    k_draws, b, p = shape
    gen = torch.Generator(device=card).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=card)  # noqa: E731
    g, f, eps = 50 * r(k_draws * b, p), 100 * r(k_draws * b), r(k_draws, b, p)
    state = [r(b, p), -3 + 0.3 * r(b, p), 0.1 * r(b, p), r(b, p).abs(),
             0.1 * r(b, p), r(b, p).abs()]
    sd = state[1].exp()
    advi = tcfg.AdviConfig(num_elbo_samples=k_draws)
    for step in (0, 150):
        sc = advi_k.adam_scalars(advi, step)
        mine = [x.clone() for x in state]
        plain = [x.clone() for x in state]
        before = advi_k.launches
        got = advi_k.advi_step(g, f, eps, sd, *mine, sc)
        assert advi_k.launches == before + 1
        want = advi_k.advi_plain(g, f, eps, sd, *plain, sc)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for a, c in zip(mine, plain):
            assert torch.equal(a, c)


def test_fit_advi_on_the_card_runs_k3_and_k7(card, setup):
    """64 series: K3 (gradient, one launch a step on the draw stack) and K7
    (one a step); the card's fit against the plain CPU fit on the same
    draws, to the 20-step rule."""
    batch = demo_weekly_rows(0, 64, n_steps=DAYS, seed=0)
    y = batch.y.astype(np.float32)
    data, _ = tdesign.prepare_fit_data(batch.ds, y, TCFG)
    theta = np.nan_to_num(get_backend(
        "cuda", TCFG, tcfg.SolverConfig(max_iters=25), device="cpu")
        .fit(batch.ds, y).theta.numpy())
    advi = tcfg.AdviConfig(num_steps=20)
    eps = [torch.from_numpy(_draws(100 + i, (K, 64, P))) for i in range(20)]
    loss_k.grad_launches = advi_k.launches = 0
    got = tadvi.fit_advi(theta, data, None, TCFG, advi,
                         draws=lambda i: eps[i].to(card))
    assert loss_k.grad_launches == 20 and advi_k.launches == 20
    want = tadvi.fit_advi(theta, data, None, TCFG, advi, device="cpu",
                          draws=lambda i: eps[i])
    for name in ("mu", "rho"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
