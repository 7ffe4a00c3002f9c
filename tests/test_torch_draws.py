"""The port's posterior-predictive forecast (``forecast_from_draws``, the
K6 kernel's plain version on the CPU) against the JAX package's, fed the
JAX package's own per-draw variates: ``keys = split(key, S + 1)``, then
``k_tr, k_noise = split(keys[s])`` and ``k_bern, k_lap = split(k_tr)`` for
draw s.  Also ``predict_mcmc``'s thinning indices, and an ``McmcState``
carried from the JAX package and back.  The CUDA kernel itself is held
against its plain version by the card-only tests at the end (a fixture
skips them without a card) and by ``chip_smoke.py``.

Tolerance: rtol 1e-5 with atol 1e-6 in scaled units (times y_scale in
data units), as the MAP forecast's tests: the two packages sum
changepoint and feature terms, cumulative sums and the means over draws
in different orders."""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import model as jmodel
from tsspark_tpu.models.prophet import predict as jpredict
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.carry import (
    mcmcstate_from_numpy,
    mcmcstate_to_numpy,
)
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.kernels import draws as dk
from tsspark_tpu_torch.models.prophet import predict as tpredict
from tsspark_tpu_torch.models.prophet.model import ProphetModel, thin_indices

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEYS = dk.OUTPUTS


def _configs(growth):
    kw = dict(growth=growth, n_changepoints=6,
              seasonalities=None, regressors=None)
    out = []
    for mod in (jcfg, tcfg):
        seas = (dataclasses.replace(mod.YEARLY, fourier_order=3),
                dataclasses.replace(mod.WEEKLY, mode="multiplicative"))
        regs = (mod.RegressorConfig("price"),
                mod.RegressorConfig("promo", mode="multiplicative"))
        out.append(mod.ProphetConfig(**{**kw, "seasonalities": seas,
                                        "regressors": regs}))
    return out


def _jax_state(growth, b=10, days=200, n_s=24, seed=0):
    """A JAX-package McmcState: the batch's MAP-shaped draws around a
    random point (k clear of 0 under logistic growth, where the offset
    recursion is ill-conditioned), its ScalingMeta and MAP FitState."""
    jc, tc = _configs(growth)
    batch = m5_like(b, days, seed=2)
    regs = batch.regressors[:, :, 1:]
    cap = None
    if growth == "logistic":
        cap = np.nanmax(batch.y, axis=1, keepdims=True) * 2.0 \
            + np.zeros((b, days))
    _, meta = jdesign.prepare_fit_data(
        jnp.asarray(batch.ds), jnp.asarray(np.nan_to_num(batch.y)), jc,
        mask=jnp.asarray(batch.mask), cap=None if cap is None else
        jnp.asarray(cap), regressors=jnp.asarray(regs))
    rng = np.random.default_rng(seed)
    p = tc.num_params
    base = rng.normal(0, 0.05, (b, p))
    base[:, 0] = rng.normal(0.3, 0.3, b)
    base[:, 1] = rng.uniform(0.2, 0.6, b)
    base[:, 2] = np.log(rng.uniform(0.03, 0.1, b))
    base[:, 3:3 + 6] = rng.laplace(0, 0.05, (b, 6))
    if growth == "logistic":
        base[:, 0] = np.abs(base[:, 0]) + 1.0
    samples = (base[None] + 0.02 * rng.normal(0, 1, (n_s, b, p))).astype(
        np.float32)
    map_state = jmodel.FitState(
        theta=jnp.asarray(base.astype(np.float32)), meta=meta,
        loss=jnp.zeros(b), grad_norm=jnp.zeros(b),
        converged=jnp.ones(b, bool), n_iters=jnp.full(b, 7, jnp.int32),
        status=jnp.ones(b, jnp.int32))
    state = jmodel.McmcState(
        samples=jnp.asarray(samples), meta=meta,
        accept_rate=jnp.full(b, 0.9), step_size=jnp.full(b, 0.05),
        divergences=jnp.zeros(b, jnp.int32), map_state=map_state,
        rhat=np.ones((b, p)), ess=np.full((b, p), 100.0))
    ds = np.concatenate([batch.ds, batch.ds[-1] + np.arange(1, 29)])
    pregs = np.concatenate([regs, regs[:, -28:]], axis=1)
    pcap = None if cap is None else np.concatenate([cap, cap[:, -28:]], 1)
    return jc, tc, state, ds, pregs, pcap


def _leaves(state):
    """An McmcState of the JAX package as the flat numpy mapping
    ``carry.mcmcstate_from_numpy`` takes."""
    out = {f: np.asarray(getattr(state, f))
           for f in ("samples", "accept_rate", "step_size", "divergences",
                     "rhat", "ess")}
    out.update({k: np.asarray(v) for k, v in state.meta._asdict().items()})
    ms = state.map_state
    out.update({"map_" + f: np.asarray(getattr(ms, f))
                for f in ("theta", "loss", "grad_norm", "converged",
                          "n_iters", "status")})
    return out


def _jax_variates(key, n_s, shape):
    """The (S, B, T) variates ``forecast_from_draws`` draws per draw."""
    keys = jax.random.split(key, n_s + 1)
    u, lap, z = [], [], []
    f32 = jnp.float32
    for s in range(n_s):
        k_tr, k_noise = jax.random.split(keys[s])
        k_bern, k_lap = jax.random.split(k_tr)
        u.append(jax.random.uniform(k_bern, (1,) + shape, dtype=f32)[0])
        lap.append(jax.random.laplace(k_lap, (1,) + shape, dtype=f32)[0])
        z.append(jax.random.normal(k_noise, shape))
    return tuple(torch.from_numpy(np.stack([np.asarray(a) for a in v]))
                 for v in (u, lap, z))


def _assert_close(got, want, meta, keys):
    scale = np.asarray(meta.y_scale)[:, None]
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        unit = scale if k != "yhat_samples" else scale[None]
        atol = 1e-6 * (1.0 if k == "multiplicative" else unit)
        assert a.shape == b.shape, k
        ok = np.abs(a - b) <= atol + 1e-5 * np.abs(b)
        assert ok.all(), (k, float(np.max(np.abs(a - b) / (atol + 1e-30))))


@pytest.mark.parametrize("growth,width", [
    ("linear", 0.8), ("linear", 0.95), ("flat", 0.8), ("logistic", 0.8),
])
def test_forecast_from_carried_draws_matches_jax(growth, width):
    jc, tc, jstate, ds, regs, cap = _jax_state(growth)
    jc = dataclasses.replace(jc, interval_width=width)
    tc = dataclasses.replace(tc, interval_width=width)
    tstate = mcmcstate_from_numpy(_leaves(jstate))
    data_t = tpredict.prepare_predict_data(ds, tstate.meta, tc, CPU,
                                           cap=cap, regressors=regs)
    data_j = jpredict.prepare_predict_data(ds, jstate.meta, jc, cap=cap,
                                           regressors=regs)
    key = jax.random.PRNGKey(5)
    n_s = jstate.samples.shape[0]
    variates = _jax_variates(key, n_s, tuple(data_t.t.shape))
    got = tpredict.forecast_from_draws(tstate.samples, data_t, tstate.meta,
                                       tc, variates=variates,
                                       return_samples=True)
    want = jpredict.forecast_from_draws(jstate.samples, data_j, jstate.meta,
                                        jc, key, return_samples=True)
    assert sorted(got) == sorted(want)
    _assert_close(got, want, tstate.meta, want)


@pytest.mark.parametrize("n_draws,max_draws", [
    (300, 100), (300, 7), (300, 299), (1000, 333), (7, 3), (2, 2), (5, 1),
    (10007, 997), (65536, 4097),
    # float64 linspace truncates an index of these to one less
    (31, 23), (46, 34), (53, 47),
])
def test_thinning_indices_match_jax(n_draws, max_draws):
    want = np.asarray(jnp.linspace(0, n_draws - 1, max_draws).astype(int))
    assert np.array_equal(thin_indices(n_draws, max_draws), want)


def test_predict_mcmc_thins_then_forecasts():
    _, tc, jstate, ds, regs, _ = _jax_state("linear", n_s=40)
    state = mcmcstate_from_numpy(_leaves(jstate))
    model = ProphetModel(tc, device="cpu")
    got = model.predict_mcmc(state, ds, regressors=regs, seed=3,
                             max_draws=9)
    data = tpredict.prepare_predict_data(ds, state.meta, tc, CPU,
                                         regressors=regs)
    idx = torch.from_numpy(thin_indices(40, 9))
    want = tpredict.forecast_from_draws(state.samples[idx], data, state.meta,
                                        tc, seed=3)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert set(model.stages.seconds) == {"prep", "forecast"}


def test_mcmc_state_carries_both_ways():
    _, _, jstate, _, _, _ = _jax_state("logistic", n_s=6)
    leaves = _leaves(jstate)
    state = mcmcstate_from_numpy(leaves)
    assert state.samples.dtype == torch.float32
    assert tuple(state.samples.shape) == leaves["samples"].shape
    np.testing.assert_array_equal(state.map_state.theta.numpy(),
                                  leaves["map_theta"])
    back = mcmcstate_to_numpy(state)
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# -- the CUDA kernel against its plain version (card only) --------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


def _on(card, growth, n_s=24):
    _, tc, jstate, ds, regs, cap = _jax_state(growth, n_s=n_s)
    state = mcmcstate_from_numpy(_leaves(jstate), device=card)
    data = tpredict.prepare_predict_data(ds, state.meta, tc, card, cap=cap,
                                         regressors=regs)
    sc = torch.as_tensor(state.meta.y_scale, dtype=torch.float32,
                         device=card)
    fl = torch.as_tensor(state.meta.floor, dtype=torch.float32, device=card)
    return tc, state.samples, data, sc, fl


@pytest.mark.parametrize("growth", ["linear", "logistic", "flat"])
def test_draws_kernel_matches_plain_on_given_draws(card, growth,
                                                   monkeypatch):
    tc, samples, data, sc, fl = _on(card, growth)
    gen = torch.Generator(device=card).manual_seed(0)
    shape = (samples.shape[0],) + tuple(data.t.shape)
    variates = dk.sample_draws(shape, gen, card)
    monkeypatch.setattr(dk, "CHUNK_ROWS", 4)
    before = dk.launches
    got = dk.draws(samples, data, sc, fl, tc, variates=variates,
                   return_samples=True)
    assert dk.launches == before + 3  # 10 rows in chunks of 4
    want = dk.draws_plain(samples, data, sc, fl, tc, variates, True)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(sc.max()))


def test_draws_kernel_rows_are_invariant_on_the_card(card):
    """A row's outputs are the same bits alone and permuted, its Philox
    row coordinate kept."""
    tc, samples, data, sc, fl = _on(card, "linear")
    b = samples.shape[1]
    full = dk.draws(samples, data, sc, fl, tc, seed=4)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    for idx in (slice(3, 8), perm.to(card)):
        rows = torch.arange(b, dtype=torch.int32, device=card)[idx]
        sub = data._replace(**{f: getattr(data, f)[idx].contiguous()
                               for f in ("t", "y", "mask", "s", "cap",
                                         "X_reg")})
        got = dk.draws(samples[:, idx].contiguous(), sub,
                       sc[idx].contiguous(), fl[idx].contiguous(), tc,
                       seed=4, rows=rows.contiguous())
        for k in KEYS:
            assert torch.equal(got[k], full[k][idx]), k


@pytest.mark.parametrize("growth,n_s,per_series,features", [
    ("linear", 300, False, "mixed"), ("logistic", 300, True, "mixed"),
    ("linear", 1024, False, "mixed"), ("flat", 1, False, "mixed"),
    ("linear", 1, True, "mixed"), ("linear", 128, False, "none"),
    ("logistic", 300, False, "wide"), ("linear", 1024, False, "wide"),
])
def test_draws_kernel_thread_caps_and_feature_counts(card, growth, n_s,
                                                     per_series, features):
    """Both thread caps (S = 300 under 384, S = 1,024), one draw, no
    feature and more than 32 (at S = 1,024 the coefficient table outgrows
    shared memory and its last features are split at each cell): within
    ``chip_smoke.DRAWS_TOL`` of the plain version on given draws, and each
    row the same bits alone and permuted on the kernel's own draws."""
    rng = np.random.default_rng(5)
    cfg, samples, data, sc, fl, variates = chip_smoke._draw_case(
        rng, growth, 24, 96, n_s, per_series, card, features)
    err, _, _ = chip_smoke._draws_vs_plain(cfg, samples, data, sc, fl,
                                           variates)
    assert err <= chip_smoke.DRAWS_TOL
    assert chip_smoke.draws_row_invariance(samples, data, sc, fl, cfg,
                                           card)["bitwise"]


def test_draws_kernel_refuses_past_its_sample_limit(card):
    tc, samples, data, sc, fl = _on(card, "linear", n_s=2)
    many = samples[:1].expand(dk.MAX_SAMPLES + 1, -1, -1).contiguous()
    with pytest.raises(ValueError, match="MAX_SAMPLES"):
        dk.draws(many, data, sc, fl, tc)
