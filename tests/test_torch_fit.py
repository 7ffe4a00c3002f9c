"""The port's MAP fit end to end on the CPU: ``CudaBackend(device="cpu")``
(the K3/K4 plain versions) against the JAX package's ``TpuBackend`` on a
config-3-shaped batch, and the fit's own contracts within the port —
segmented == unsegmented and compacted == uncompacted BITWISE, chunking
invisible, the rescue pass only improving, a short solve under a replaced
solver config, warm starts from JAX-fitted parameters,
and the port's scipy oracle against the JAX package's.

Tolerances, with their reasons: the two batched solvers run float32
arithmetic in other orders, so trajectories part after a few iterations
and each lands within the float32 noise of the optimum — per-series loss
no worse than the reference by more than KEEP_BEST_MARGIN (0.05 nats,
the rescue pass's own margin) and mean sMAPE within 0.05 (the parity
thresholds of tests/test_backends.py).
"""

import dataclasses
import functools

import chip_smoke
import numpy as np
import numpy.testing as npt
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.backends.registry import get_backend as jget
from tsspark_tpu.eval import metrics as jmetrics
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.carry import fitstate_to_numpy, fitstate_from_numpy
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.eval import configs, metrics
from tsspark_tpu_torch.kernels import fan as _fan_kernel
from tsspark_tpu_torch.kernels import loss as _loss_kernel
from tsspark_tpu_torch.models.prophet.model import (
    KEEP_BEST_MARGIN,
    ProphetModel,
)
from tsspark_tpu_torch.ops import lbfgs

torch.set_num_threads(2)

SPLIT = 360  # 90% of the 400-day batch
_FAN_PLAIN = _fan_kernel.fan_plain
_LOSS_ROWS = _loss_kernel._loss_rows


def _jax_config3():
    return jcfg.ProphetConfig(
        seasonalities=(jcfg.SeasonalityConfig("yearly", 365.25, 8),
                       jcfg.SeasonalityConfig("weekly", 7.0, 3)),
        regressors=(jcfg.RegressorConfig("holiday", standardize=False),
                    jcfg.RegressorConfig("price"),
                    jcfg.RegressorConfig("promo", standardize=False)),
        n_changepoints=25)


@pytest.fixture(scope="module")
def batch():
    return m5_like(64, 400, seed=2)


def _fit_args(b):
    return (b.ds[:SPLIT], np.nan_to_num(b.y[:, :SPLIT])), dict(
        mask=b.mask[:, :SPLIT], regressors=b.regressors[:, :SPLIT])


@pytest.fixture(scope="module")
def jax_fit(batch):
    """JAX TpuBackend's fit of config 3 (the reference)."""
    args, kw = _fit_args(batch)
    bk = jget("tpu", _jax_config3(), jcfg.SolverConfig(max_iters=120))
    state = bk.fit(*args, **kw)
    fc = bk.predict(state, batch.ds, regressors=batch.regressors,
                    num_samples=0)
    return state, np.asarray(fc["yhat"])


@pytest.fixture(scope="module")
def port_fit(batch):
    args, kw = _fit_args(batch)
    bk = get_backend("cuda", configs.CONFIG3, configs.SOLVER3, device="cpu")
    state = bk.fit(*args, **kw)
    fc = bk.predict(state, batch.ds, regressors=batch.regressors,
                    num_samples=0)
    return bk, state, fc["yhat"]


def _smape(batch, yhat, train=True):
    sc = configs.score(batch, {"yhat": yhat})
    return sc["smape_train" if train else "smape_holdout"]


def test_fit_matches_jax_on_a_config3_batch(batch, jax_fit, port_fit):
    jstate, jyhat = jax_fit
    bk, state, yhat = port_fit
    assert state.theta.shape == (64, configs.CONFIG3.num_params)
    assert state.theta.device.type == "cpu"
    assert np.isfinite(state.loss).all()
    # Per series: no worse than the JAX fit by more than the margin.
    assert np.all(state.loss <= np.asarray(jstate.loss) + KEEP_BEST_MARGIN)
    s_port, s_jax = _smape(batch, yhat), _smape(batch, jyhat)
    assert abs(s_port.mean() - s_jax.mean()) < 0.05
    # The 40-day holdout extrapolates a yearly seasonality fitted on at
    # most 360 days (sMAPE ~83 on this batch), which amplifies the two
    # solvers' float32 differences in beta: held to 0.5% of its mean.
    h_port, h_jax = _smape(batch, yhat, False), _smape(batch, jyhat, False)
    assert abs(h_port.mean() - h_jax.mean()) < 5e-3 * h_jax.mean()
    # The port's metrics are the JAX package's.
    y = np.nan_to_num(batch.y)
    npt.assert_allclose(metrics.smape(y, yhat, batch.mask),
                        np.asarray(jmetrics.smape(y, yhat, batch.mask)),
                        rtol=1e-6)
    # Every stage of the fit was timed, the rescue pass included.
    for stage in ("prep", "pack", "to_device", "init", "solve", "to_host",
                  "rescue"):
        assert bk.stages.seconds.get(stage, 0.0) > 0.0, stage


def test_chunked_fit_equals_unchunked(batch, port_fit):
    _, whole, _ = port_fit
    args, kw = _fit_args(batch)
    chunked = get_backend("cuda", configs.CONFIG3, configs.SOLVER3,
                          device="cpu", chunk_size=32).fit(*args, **kw)
    # Padding rows and the chunk width never reach a real row: every op
    # of the fit is row-local.
    for f in ("loss", "grad_norm", "converged", "n_iters", "status"):
        npt.assert_array_equal(getattr(chunked, f), getattr(whole, f),
                               err_msg=f)
    assert torch.equal(chunked.theta, whole.theta)
    npt.assert_array_equal(chunked.meta.ds_start, whole.meta.ds_start)


def test_rescue_pass_only_improves(batch, port_fit):
    _, rescued, _ = port_fit
    args, kw = _fit_args(batch)
    plain = get_backend("cuda", configs.CONFIG3, configs.SOLVER3,
                        device="cpu", rescue=False).fit(*args, **kw)
    stuck = np.isin(plain.status, (lbfgs.STATUS_FLOOR,
                                   lbfgs.STATUS_STALLED))
    assert stuck.any()
    assert np.all(rescued.loss <= plain.loss)
    # Rows that were not stuck are untouched; stuck ones spent more work.
    npt.assert_array_equal(rescued.loss[~stuck], plain.loss[~stuck])
    assert np.all(rescued.n_iters[stuck] > plain.n_iters[stuck])
    changed = rescued.loss < plain.loss - KEEP_BEST_MARGIN
    npt.assert_array_equal(
        (rescued.theta != plain.theta).any(-1).numpy(), changed)


def test_warm_start_from_jax_fitted_parameters(batch, jax_fit):
    jstate, _ = jax_fit
    arrays = {f: np.asarray(getattr(jstate, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    arrays.update({k: np.asarray(v) for k, v in
                   jstate.meta._asdict().items()})
    carried = fitstate_from_numpy(arrays, "cpu")
    args, kw = _fit_args(batch)
    warm = get_backend("cuda", configs.CONFIG3, configs.SOLVER3,
                       device="cpu", rescue=False).fit(
        *args, init=carried.theta, **kw)
    assert np.all(warm.loss <= arrays["loss"] + KEEP_BEST_MARGIN)
    # Started at the optimum, the solve stops within a few iterations.
    assert np.median(warm.n_iters) <= 10
    back = fitstate_to_numpy(warm)
    npt.assert_array_equal(back["ds_start"], arrays["ds_start"])


def _mixed(b=48, t=160, seed=0):
    """Mixed difficulty: most series converge early, every 4th is a noisy
    random walk that needs the full depth (tests/test_compaction.py)."""
    rng = np.random.default_rng(seed)
    ds = np.arange(t, dtype=np.float64)
    y = np.empty((b, t), np.float32)
    for i in range(b):
        if i % 4 == 0:
            y[i] = np.cumsum(rng.normal(0, 1.0, t)) + 5 * np.sin(
                ds / 7 * 2 * np.pi)
        else:
            y[i] = 0.01 * i + 0.05 * ds + rng.normal(0, 0.01, t)
    return ds, y


CFG_SMALL = tcfg.ProphetConfig(
    seasonalities=(tcfg.SeasonalityConfig("weekly", 7.0, 3),),
    n_changepoints=5)


def _assert_equal_states(a, b):
    assert torch.equal(a.theta, b.theta)
    for f in ("loss", "grad_norm", "converged", "n_iters", "status"):
        npt.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_segmented_and_compacted_solves_are_bitwise_equal(monkeypatch):
    gathers = []
    take = lbfgs.take_state
    monkeypatch.setattr(lbfgs, "take_state",
                        lambda st, idx: gathers.append(len(idx))
                        or take(st, idx))
    ds, y = _mixed()
    # A per-series grid keeps every solve on the plain FitData path.
    ds2 = np.broadcast_to(ds, y.shape)
    model = ProphetModel(CFG_SMALL, tcfg.SolverConfig(max_iters=48),
                         device="cpu")
    whole = model.fit(ds2, y)
    seen = []
    seg = model.fit(ds2, y, iter_segment=8, on_segment=lambda: seen.append(1))
    comp = model.fit(ds2, y, iter_segment=8, compact=True)
    _assert_equal_states(whole, seg)
    _assert_equal_states(seg, comp)
    assert 1 < len(seen) <= 6
    # The compacted solve really shrank its batch (48 rows -> 32).
    assert gathers == [32]


@pytest.mark.parametrize("precond", ["none", "gn_diag"])
def test_solver_config_sets_depth_and_metric_as_in_jax(batch, precond):
    """A short solve under a replaced SolverConfig (the way a two-phase
    fit picks its depth and metric) against the JAX package under the
    same config.  Within six iterations the two float32 trajectories have
    not parted (they agree to ~4e-6 of the loss scale; a row may stop one
    iteration apart at the noise floor): losses held to 1e-4 of it."""
    args, kw = _fit_args(batch)
    args, kw = (args[0], args[1][:8]), {k: v[:8] for k, v in kw.items()}
    solver = dataclasses.replace(configs.SOLVER3, max_iters=6,
                                 precond=precond)
    port = get_backend("cuda", configs.CONFIG3, solver, device="cpu",
                       rescue=False).fit(*args, **kw)
    ref = jget("tpu", _jax_config3(),
               jcfg.SolverConfig(max_iters=6, precond=precond),
               rescue=False).fit(*args, **kw)
    assert int(port.n_iters.max()) <= 6
    jl = np.asarray(ref.loss)
    npt.assert_allclose(port.loss, jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())


def test_cpu_oracle_matches_the_jax_oracle():
    rng = np.random.default_rng(7)
    ds = 18000.0 + np.arange(200, dtype=np.float64)
    base = 10 + 0.02 * np.arange(200) + np.sin(2 * np.pi * ds / 7.0)
    y = np.stack([base, 3 * base + 5, 0.5 * base - 2]) \
        + rng.normal(0, 0.2, (3, 200))
    jc = jcfg.ProphetConfig(
        seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 3),),
        n_changepoints=5)
    solver = tcfg.SolverConfig(max_iters=200)
    port = get_backend("cpu", CFG_SMALL, solver)
    st = port.fit(ds, y)
    jst = jget("cpu", jc, jcfg.SolverConfig(max_iters=200)).fit(ds, y)
    npt.assert_allclose(st.loss, np.asarray(jst.loss), rtol=1e-4)
    mask = np.ones_like(y)
    s_port = metrics.smape(y, port.predict(st, ds, num_samples=0)["yhat"],
                           mask)
    s_jax = np.asarray(jmetrics.smape(
        y, jget("cpu", jc).predict(jst, ds, num_samples=0)["yhat"], mask))
    npt.assert_allclose(s_port, s_jax, atol=0.1)
    # And the batched port against its own oracle (test_backends' rule).
    bst = get_backend("cuda", CFG_SMALL, solver, device="cpu").fit(ds, y)
    s_b = metrics.smape(y, get_backend("cuda", CFG_SMALL, device="cpu")
                        .predict(bst, ds, num_samples=0)["yhat"], mask)
    npt.assert_allclose(s_b, s_port, atol=0.1)
    assert abs(s_b.mean() - s_port.mean()) < 0.05


@functools.lru_cache(maxsize=2)
def _parity_case(seed):
    """``chip_smoke.py``'s parity subset (128 of config 3's 30,490 series,
    fitted on 1,746 days) of ``m5_like(30490, 1941, seed)``, with the
    port's plain fit and scipy-oracle fit of it."""
    b = m5_like(30490, 1941, seed=seed)
    idx = chip_smoke.fit_subset()
    split = configs.split_point(1941)
    args = (b.ds[:split], np.nan_to_num(b.y[idx, :split]))
    kw = dict(mask=b.mask[idx, :split], regressors=b.regressors[idx, :split])
    plain = get_backend("cuda", configs.CONFIG3, configs.SOLVER3,
                        device="cpu").fit(*args, **kw)
    oracle = get_backend("cpu", configs.CONFIG3, configs.SOLVER3).fit(
        *args, **kw)
    return args, kw, plain.loss, oracle.loss


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3])
def test_full_length_config3_fit_against_jax(capsys, seed):
    """At config 3's full length (1,746 days) two float32 lockstep solvers
    stop at the noise floor at different points.  The readings that
    ``chip_smoke.py``'s loss-parity limits rest on: the port's plain fit
    and the JAX package's, each against the other and the scipy oracle,
    both held to those limits.  Prints them:
    ``pytest -m slow tests/test_torch_fit.py -k full_length -s``."""
    args, kw, port, oracle = _parity_case(seed)
    ref = np.asarray(jget("tpu", _jax_config3(),
                          jcfg.SolverConfig(max_iters=120)).fit(
        *args, **kw).loss)
    port_vs_jax, failed = chip_smoke.loss_parity(port, ref, oracle)
    assert not failed
    jax_vs_port, failed = chip_smoke.loss_parity(ref, port, oracle)
    assert not failed
    with capsys.disabled():
        print(f"\nseed {seed}: port vs jax {port_vs_jax}\n"
              f"seed {seed}: jax vs port {jax_vs_port}")


def _fan_without_changepoint_prior(theta, d, ladder, data, config):
    from tsspark_tpu_torch.models.prophet.params import unpack

    out = _FAN_PLAIN(theta, d, ladder, data, config)
    delta = unpack(theta, config).delta[None] \
        + ladder[..., None] * unpack(d, config).delta[None]
    return out - (_loss_kernel.smooth_abs(delta)
                  / config.changepoint_prior_scale).sum(-1)


def _grad_delta_off_by_2_percent(theta, data, config, grad):
    f, g = _LOSS_ROWS(theta, data, config, grad)
    if g is not None:
        g = g.clone()
        g[:, 3:3 + config.n_changepoints] *= 0.98
    return f, g


@pytest.mark.slow
@pytest.mark.parametrize("fault,caught", [
    ("stuck at its init", True),
    ("cut at 60 iterations", True),
    ("fan without the changepoint prior", True),
    ("gradient's changepoint block x0.98", False),
    ("rescue pass skipped", False),
])
def test_loss_parity_fails_planted_faults(monkeypatch, capsys, fault,
                                          caught):
    """Faults planted in the port's fit (at run time, in this process)
    against its correct plain fit and the oracle on the parity subset:
    ``chip_smoke.loss_parity`` fails each gross one.  A gradient off by
    2% moves the fit less than float32 noise does and passes; the
    kernel-vs-plain checks are what hold the gradient.  Skipping the
    rescue pass passes too: it changes little on this subset (the
    printed readings say how little)."""
    args, kw, plain, oracle = _parity_case(2)
    solver, opts = configs.SOLVER3, {}
    if fault == "stuck at its init":
        solver = dataclasses.replace(solver, max_iters=0)
    elif fault == "cut at 60 iterations":
        solver = dataclasses.replace(solver, max_iters=60)
    elif fault == "rescue pass skipped":
        opts = dict(rescue=False)
    elif fault.startswith("fan"):
        monkeypatch.setattr(_fan_kernel, "fan_plain",
                            _fan_without_changepoint_prior)
    else:
        monkeypatch.setattr(_loss_kernel, "_loss_rows",
                            _grad_delta_off_by_2_percent)
    loss = get_backend("cuda", configs.CONFIG3, solver, device="cpu",
                       **opts).fit(*args, **kw).loss
    readings, failed = chip_smoke.loss_parity(loss, plain, oracle)
    with capsys.disabled():
        print(f"\n{fault}: {readings} failed {failed}")
    assert bool(failed) == caught
