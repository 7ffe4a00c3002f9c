"""The port's forecast against the JAX package's: deterministic keys,
predictive bands when both are fed the JAX package's own draws, the
component breakdown, and the backend's chunking.  The kernels' plain
versions run here (CPU tensors); the CUDA kernels themselves are held
against them on the card by ``chip_smoke.py`` and by the card-only
tests at the end of this file.

Tolerance: rtol 1e-5 with atol 1e-6 in scaled units (times y_scale in
data units): the two packages sum changepoint and feature terms, and
cumulative sums, in different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import predict as jpredict
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.backends.registry import get_backend, list_backends
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.kernels import bands as bk
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import predict as tpredict
from tsspark_tpu_torch.models.prophet.model import ProphetModel

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _configs(growth="linear", **kw):
    return (jcfg.ProphetConfig(growth=growth, n_changepoints=10, **kw),
            tcfg.ProphetConfig(growth=growth, n_changepoints=10, **kw))


def _setup(growth="linear", b=24, horizon=28, seed=0, **kw):
    jc, tc = _configs(growth, **kw)
    batch = m5_like(b, 300, seed=2, with_regressors=False)
    cap = None
    if growth == "logistic":
        cap = np.nanmax(batch.y, axis=1, keepdims=True) * 2.0 \
            + np.zeros((b, 300))
    _, meta = tdesign.prepare_fit_data(batch.ds, batch.y, tc, cap=cap)
    rng = np.random.default_rng(seed)
    theta = rng.normal(0, 0.05, (b, tc.num_params)).astype(np.float32)
    theta[:, 0] = rng.normal(0.3, 0.3, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    theta[:, 2] = np.log(rng.uniform(0.03, 0.1, b))
    theta[:, 3:13] = rng.laplace(0, 0.05, (b, 10))
    if growth == "logistic":
        # Keep every rate k_j clear of 0, where the offset recursion is
        # ill-conditioned in float32 and the two packages' summation
        # orders part by more than the stated tolerance.
        theta[:, 0] = np.abs(theta[:, 0]) + 1.0
    ds = np.concatenate([batch.ds, batch.ds[-1] + np.arange(1, horizon + 1)])
    pcap = None if cap is None else \
        np.concatenate([cap, cap[:, -horizon:]], axis=1)
    data_t = tpredict.prepare_predict_data(ds, meta, tc, CPU, cap=pcap)
    data_j = jpredict.prepare_predict_data(ds, meta, jc, cap=pcap)
    return jc, tc, meta, theta, data_t, data_j


def _assert_close(got, want, meta, keys):
    scale = meta.y_scale[:, None]
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        atol = 1e-6 * (1.0 if k == "multiplicative" else scale)
        assert a.shape == b.shape, k
        ok = np.abs(a - b) <= atol + 1e-5 * np.abs(b)
        assert ok.all(), (k, float(np.max(np.abs(a - b) / (atol + 1e-30))))


@pytest.mark.parametrize("growth", ["linear", "logistic", "flat"])
def test_deterministic_forecast_matches_forecast_jit(growth):
    jc, tc, meta, theta, data_t, data_j = _setup(growth)
    got = tpredict.forecast(torch.from_numpy(theta), data_t, meta, tc)
    want = jpredict.forecast_jit(jnp.asarray(theta), data_j, meta, jc,
                                 key=None, num_samples=0)
    assert sorted(got) == sorted(want)
    _assert_close(got, want, meta, want)


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


@pytest.mark.parametrize("growth,width", [
    ("linear", 0.8), ("linear", 0.95), ("flat", 0.8), ("logistic", 0.8),
])
def test_bands_fed_the_jax_draws_match(growth, width):
    jc, tc, meta, theta, data_t, data_j = _setup(growth,
                                                 interval_width=width)
    s = 64
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, (s,) + tuple(data_t.t.shape))
    got = tpredict.forecast(torch.from_numpy(theta), data_t, meta, tc,
                            draws=draws, return_samples=True)
    want = jpredict.forecast_jit(jnp.asarray(theta), data_j, meta, jc,
                                 key=key, num_samples=s,
                                 return_samples=True)
    assert sorted(got) == sorted(want)
    _assert_close(got, want, meta, ("yhat_lower", "yhat_upper",
                                    "trend_lower", "trend_upper", "yhat"))
    scale = meta.y_scale[None, :, None]
    a, b = got["yhat_samples"].numpy(), np.asarray(want["yhat_samples"])
    assert (np.abs(a - b) <= 1e-6 * scale + 1e-5 * np.abs(b)).all()


@pytest.mark.parametrize("s", [1, 2, 7, 256])
def test_quantile_linear_is_jnp_quantile(s):
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (s, 5, 9)).astype(np.float32)
    qs = bk.quantile_points(0.8)
    got = bk.quantile_linear(torch.from_numpy(x), qs)
    want = jnp.quantile(jnp.asarray(x), jnp.asarray(qs, jnp.float32), axis=0)
    for i in range(2):
        # The same sort and weights; the JAX package may fuse the final
        # multiply-add, so the two agree to an ulp, not bitwise.
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=2e-7, atol=1e-7)


@pytest.mark.parametrize("column", ["nan", "inf", "-inf", "both-inf",
                                    "ties"])
def test_quantile_linear_is_jnp_quantile_on_non_finite_columns(column):
    """A column holding a NaN gives NaN at every q, as jnp.quantile's
    does; +-inf sort as values (inf * 0 weights give NaN in both)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (40, 6)).astype(np.float32)
    if column == "nan":
        x[[3, 17], 2] = np.nan
    elif column == "inf":
        x[:6, 1] = np.inf
    elif column == "-inf":
        x[:5, 4] = -np.inf
    elif column == "both-inf":
        x[:4, 0], x[4:8, 0] = np.inf, -np.inf
    else:
        x[:, 5] = 1.5
    qs = [np.float32(q) for q in (0.0, 0.1, 0.5, 0.9, 1.0)]
    got = bk.quantile_linear(torch.from_numpy(x), qs)
    want = jnp.quantile(jnp.asarray(x), jnp.asarray(qs, jnp.float32), axis=0)
    for i in range(len(qs)):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=2e-7, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("s,t_len,b,expect", [
    (256, 32, 8192, 0),                     # fused: no scratch
    (1024, 1969, 64, 0),
    (1025, 8, 16, 16 * (2 * 1025 * 8 + 2 * 1025)),
    (65536, 32, 1024, bk.SCRATCH_BYTES // 4),   # capped: rows in chunks
    (65536, 4096, 1, bk.SCRATCH_BYTES // 4),    # one row's steps in chunks
])
def test_band_scratch_stays_within_its_budget(s, t_len, b, expect):
    assert bk.scratch_floats(b, t_len, s) == expect
    assert 4 * bk.scratch_floats(b, t_len, s) <= bk.SCRATCH_BYTES


def test_band_scratch_refuses_a_step_that_cannot_fit():
    with pytest.raises(ValueError):
        bk.scratch_floats(1, 1, bk.SCRATCH_BYTES // 16 + 1)


def test_component_breakdown_matches():
    jc, tc, meta, theta, data_t, data_j = _setup(
        "linear", regressors=())
    got = tpredict.component_breakdown(torch.from_numpy(theta), data_t,
                                       meta, tc)
    want = jpredict.component_breakdown(jnp.asarray(theta), data_j, meta, jc)
    assert sorted(got) == sorted(want) == ["trend", "weekly", "yearly"]
    _assert_close(got, want, meta, want)


def _state(meta, theta):
    b = theta.shape[0]
    return fitstate_from_numpy({
        "theta": theta, "loss": np.zeros(b, np.float32),
        "grad_norm": np.zeros(b, np.float32),
        "converged": np.ones(b, bool), "n_iters": np.zeros(b, np.int32),
        **meta._asdict(),
    })


def test_model_predict_and_components_on_cpu():
    jc, tc, meta, theta, data_t, data_j = _setup("linear")
    model = ProphetModel(tc, device="cpu")
    ds = np.concatenate([m5_like(2, 300, seed=2).ds,
                         m5_like(2, 300, seed=2).ds[-1] + np.arange(1, 29)])
    out = model.predict(_state(meta, theta), ds, num_samples=0)
    want = jpredict.forecast_jit(jnp.asarray(theta), data_j, meta, jc,
                                 key=None, num_samples=0)
    _assert_close(out, want, meta, want)
    comps = model.components(_state(meta, theta), ds)
    assert torch.equal(comps["trend"], out["trend"])
    # The fit is ported too: a flat batch fits to finite parameters.
    fitted = model.fit(ds, np.zeros((2, ds.size)))
    assert np.isfinite(fitted.loss).all()
    assert fitted.theta.shape == (2, tc.num_params)


def test_sampled_forecast_is_seeded():
    _, tc, meta, theta, data_t, _ = _setup("linear", b=6)
    th = torch.from_numpy(theta)
    a = tpredict.forecast(th, data_t, meta, tc, seed=3, num_samples=32)
    b = tpredict.forecast(th, data_t, meta, tc, seed=3, num_samples=32)
    c = tpredict.forecast(th, data_t, meta, tc, seed=4, num_samples=32)
    assert torch.equal(a["yhat_lower"], b["yhat_lower"])
    assert not torch.equal(a["yhat_lower"], c["yhat_lower"])
    assert (a["yhat_lower"] <= a["yhat_upper"]).all()


def test_backend_chunking_is_invisible_on_the_deterministic_path():
    _, tc, meta, theta, _, _ = _setup("linear", b=20)
    assert list_backends() == ["cpu", "cuda"]
    whole = get_backend("cuda", tc, device="cpu")
    chunked = get_backend("cuda", tc, device="cpu", chunk_size=8)
    state = _state(meta, theta)
    last = meta.ds_start + meta.ds_span
    grid = last[:, None] + np.arange(1, 11)[None, :]
    a = whole.predict(state, grid, num_samples=0)
    b = chunked.predict(state, grid, num_samples=0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ca = whole.components(state, grid)
    cb = chunked.components(state, grid)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    sampled = chunked.predict(state, grid, num_samples=16, seed=5)
    assert sampled["yhat_lower"].shape == (20, 10)
    assert (sampled["yhat_lower"] <= sampled["yhat_upper"]).all()
    fitted = whole.fit(grid, np.zeros(grid.shape))
    assert np.isfinite(fitted.loss).all()
    assert fitted.theta.shape == (20, tc.num_params)


# -- the CUDA kernels against their plain versions (card only) ---------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("growth", ["linear", "logistic", "flat"])
def test_forward_kernel_matches_plain_on_the_card(card, growth):
    from tsspark_tpu_torch.kernels import forward as fk

    _, tc, meta, theta, data_t, _ = _setup(growth)
    data = tdesign.FitData(*(a.to(card) for a in data_t))
    th = torch.from_numpy(theta).to(card)
    before = fk.launches
    got = fk.forward(th, data, tc)
    assert fk.launches == before + 1
    want = fk.forward_plain(th, data, tc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_bands_kernel_matches_plain_on_given_draws(card):
    from tsspark_tpu_torch.kernels import forward as fk

    _, tc, meta, theta, data_t, _ = _setup("linear")
    data = tdesign.FitData(*(a.to(card) for a in data_t))
    th = torch.from_numpy(theta).to(card)
    _, det, add, mult = fk.forward(th, data, tc)
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=card)
    floor = torch.zeros_like(scale)
    gen = torch.Generator(device=card).manual_seed(0)
    draws = bk.sample_draws((64,) + tuple(data.t.shape), gen, card)
    got = bk.bands(th, data, det, add, mult, scale, floor, tc, 64,
                   draws=draws)
    want = bk.bands_plain(th, data, det, add, mult, scale, floor, tc, draws)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(scale.max()))


@pytest.mark.parametrize("s", [16385, 40000])
def test_bands_kernel_past_the_old_sample_cap_on_the_card(card, s):
    """Sample counts past one block's shared memory go through the
    device-memory scratch, and still agree with the plain version."""
    from tsspark_tpu_torch.kernels import forward as fk

    _, tc, meta, theta, data_t, _ = _setup("linear", b=4, horizon=6)
    data = tdesign.FitData(*(a.to(card) for a in data_t))
    th = torch.from_numpy(theta).to(card)
    _, det, add, mult = fk.forward(th, data, tc)
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=card)
    floor = torch.zeros_like(scale)
    gen = torch.Generator(device=card).manual_seed(1)
    draws = bk.sample_draws((s,) + tuple(data.t.shape), gen, card)
    got = bk.bands(th, data, det, add, mult, scale, floor, tc, s,
                   draws=draws)
    want = bk.bands_plain(th, data, det, add, mult, scale, floor, tc, draws)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(scale.max()))


def test_forward_kernel_is_row_invariant_on_the_card(card):
    """A row's outputs are the same bits alone, sliced out of the batch
    and in a permuted batch."""
    from tsspark_tpu_torch.kernels import forward as fk

    _, tc, meta, theta, data_t, _ = _setup("linear", b=24)
    data = tdesign.FitData(*(a.to(card) for a in data_t))
    th = torch.from_numpy(theta).to(card)
    full = fk.forward(th, data, tc)
    perm = torch.randperm(24, generator=torch.Generator().manual_seed(0))
    for idx in (slice(5, 17), perm.to(card)):
        sub = data._replace(**{
            f: getattr(data, f)[idx].contiguous()
            for f in ("t", "y", "mask", "s", "cap", "X_reg")})
        got = fk.forward(th[idx].contiguous(), sub, tc)
        for g, w in zip(got, full):
            assert torch.equal(g, w[idx])
