"""The port's batched L-BFGS (ops/lbfgs.py): one iteration from the same
state as the JAX package's ``run_segment``, and the JAX suite's own
problems — batched convex quadratics (exact answer), a Rosenbrock batch,
mixed convergence rates — plus the host loop's contract: segments chain
bitwise, the convergence check's period changes nothing, and the loop
never runs past its cap.

Tolerances: one iteration from a shared state lands on the same point to
rtol 1e-4 (the two-loop dots and the fan's sums run in float32 in
another order; the accepted rung is the same), with equal status,
convergence and iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import init as jinit
from tsspark_tpu.models.prophet import loss as jloss
from tsspark_tpu.ops import lbfgs as jlbfgs
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.config import SolverConfig
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import loss as tloss
from tsspark_tpu_torch.ops import lbfgs

torch.set_num_threads(2)


def _prophet_problem():
    cfgs = []
    for mod in (jcfg, tcfg):
        cfgs.append(mod.ProphetConfig(
            seasonalities=(mod.SeasonalityConfig("yearly", 365.25, 4),
                           mod.SeasonalityConfig("weekly", 7.0, 3)),
            regressors=(mod.RegressorConfig("holiday", standardize=False),
                        mod.RegressorConfig("price")),
            n_changepoints=8))
    cj, ct = cfgs
    batch = m5_like(16, 250, seed=8)
    y = np.nan_to_num(batch.y)
    kw = dict(mask=batch.mask, regressors=batch.regressors[..., :2])
    dj, _ = jdesign.prepare_fit_data(batch.ds, y, cj, as_numpy=True, **kw)
    dt, _ = tdesign.prepare_fit_data(batch.ds, y, ct, **kw)
    return (cj, ct, jdesign.FitData(*map(jnp.asarray, dj)),
            tdesign.fitdata_to_device(dt, "cpu"))


def _to_torch_state(js) -> lbfgs.LbfgsState:
    conv = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return lbfgs.LbfgsState(**{
        f: (int(getattr(js, f)) if f == "iteration" else conv(getattr(js, f)))
        for f in lbfgs.LbfgsState._fields
    })


def test_one_iteration_matches_jax_from_the_same_state():
    cj, ct, dj, dt = _prophet_problem()
    solver_j = jcfg.SolverConfig(max_iters=50)
    solver_t = tcfg.SolverConfig(max_iters=50)
    fun_j = lambda th: jloss.value_and_grad_batch(th, dj, cj)  # noqa: E731
    fval_j = lambda th: jloss.value_batch(th, dj, cj)  # noqa: E731
    fan_j = lambda th, d, s: jloss.fan_value_closed_form(  # noqa: E731
        th, d, s, dj, cj)
    theta0 = jinit.ridge_init(dj, cj)
    js = jlbfgs.init_state(fun_j, theta0, solver_j,
                           jinit.curvature_diag(dj, cj, theta0))
    # A few iterations first, so the history ring holds pairs.
    js = jlbfgs.run_segment(fun_j, js, solver_j, 3, fun_value=fval_j,
                            fan_value=fan_j)
    ts = _to_torch_state(js)
    js1 = jlbfgs.run_segment(fun_j, js, solver_j, 1, fun_value=fval_j,
                             fan_value=fan_j)
    ts1 = lbfgs.run_segment(
        lambda th: tloss.value_and_grad_batch(th, dt, ct), ts, solver_t, 1,
        fun_value=lambda th: tloss.value_batch(th, dt, ct),
        fan_value=lambda th, d, s: tloss.fan_value_closed_form(
            th, d, s, dt, ct))
    assert ts1.iteration == int(js1.iteration) == 4
    active = ~np.asarray(js.converged)
    assert active.any()
    npt.assert_allclose(ts1.theta.numpy(), np.asarray(js1.theta), rtol=1e-4,
                        atol=1e-5)
    npt.assert_allclose(ts1.f.numpy(), np.asarray(js1.f), rtol=1e-5)
    npt.assert_allclose(ts1.prev_step.numpy(), np.asarray(js1.prev_step),
                        rtol=1e-6)
    for f in ("converged", "n_iters", "status", "floor_count",
              "ftol_count"):
        npt.assert_array_equal(getattr(ts1, f).numpy(),
                               np.asarray(getattr(js1, f)), err_msg=f)
    # The caller's state is not touched by the in-place history update.
    npt.assert_array_equal(ts.s_hist.numpy(), np.asarray(js.s_hist))


def _quadratics(b=16, p=8, seed=0):
    rng = np.random.default_rng(seed)
    a_half = rng.normal(size=(b, p, p))
    a = np.einsum("bij,bkj->bik", a_half, a_half) + 0.1 * np.eye(p)
    c = rng.normal(size=(b, p))
    a_t = torch.from_numpy(a.astype(np.float32))
    c_t = torch.from_numpy(c.astype(np.float32))

    def fun(theta):
        d = theta - c_t
        ad = torch.einsum("bij,bj->bi", a_t, d)
        return 0.5 * (d * ad).sum(-1), ad

    theta0 = torch.from_numpy(rng.normal(size=(b, p)).astype(np.float32))
    return fun, theta0, c


def test_batched_quadratic_exact():
    fun, theta0, centers = _quadratics()
    res = lbfgs.minimize(fun, theta0)
    assert bool(res.converged.all())
    npt.assert_allclose(res.theta.numpy(), centers, atol=1e-3)
    assert float(res.f.max()) < 1e-6
    # Clean quadratics stop solved: on the gradient test, the decrease
    # test or the float32 noise floor (as in the JAX package), never
    # stalled or still running.
    assert set(res.status.tolist()) <= {lbfgs.STATUS_GTOL,
                                        lbfgs.STATUS_FTOL,
                                        lbfgs.STATUS_FLOOR}


def test_rosenbrock_batch():
    def fun(x):
        x = x.detach().requires_grad_(True)
        f = (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
             + (1.0 - x[:, :-1]) ** 2).sum(-1)
        (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    rng = np.random.default_rng(1)
    theta0 = torch.from_numpy(rng.uniform(-1.5, 1.5, (8, 4)).astype(
        np.float32))
    res = lbfgs.minimize(fun, theta0,
                         SolverConfig(max_iters=500, tol=0.0, gtol=1e-5))
    # Every start reaches a stationary point; in float32 the decrease
    # test stops a row at the noise floor (f ~ 1e-8 here, where the
    # gradient can still read a few 1e-3 on Rosenbrock's curvature).
    assert float(res.grad_norm.max()) < 1e-2
    assert set(res.status.tolist()) <= {lbfgs.STATUS_GTOL,
                                        lbfgs.STATUS_FLOOR}
    at_global = (res.theta - 1.0).abs().amax(-1) < 1e-2
    assert int(at_global.sum()) >= 4


def test_mixed_convergence_rates_freeze_correctly():
    fun, theta0, _ = _quadratics(b=4, p=6, seed=2)
    cfg = SolverConfig(max_iters=60)
    full = lbfgs.minimize(fun, theta0, cfg)
    n = full.n_iters.numpy()
    assert n.min() < n.max()  # rows stop at different iterations
    # A frozen row's result is the one it had when it converged: running
    # the batch longer changes nothing once a row is converged.
    longer = lbfgs.minimize(fun, theta0, SolverConfig(max_iters=200))
    assert bool(full.converged.all())
    for f in lbfgs.LbfgsResult._fields:
        assert torch.equal(getattr(full, f), getattr(longer, f)), f


def test_segments_chain_bitwise_and_sync_period_is_free(monkeypatch):
    fun, theta0, _ = _quadratics(b=8, p=6, seed=3)
    cfg = SolverConfig(max_iters=40, tol=0.0, gtol=1e-9)
    st = lbfgs.init_state(fun, theta0, cfg)
    whole = lbfgs.run_segment(fun, st, cfg)
    seg = st
    for _ in range(10):
        seg = lbfgs.run_segment(fun, seg, cfg, 4)
    monkeypatch.setattr(lbfgs, "SYNC_EVERY", 1)
    every = lbfgs.run_segment(fun, st, cfg)
    for f in lbfgs.LbfgsResult._fields:
        a = getattr(lbfgs.to_result(whole), f)
        assert torch.equal(a, getattr(lbfgs.to_result(seg), f)), f
        assert torch.equal(a, getattr(lbfgs.to_result(every), f)), f


@pytest.mark.parametrize("num_iters,cap", [(7, 10), (None, 5), (3, 2)])
def test_loop_never_runs_past_its_cap(num_iters, cap):
    fun, theta0, _ = _quadratics(b=4, p=6, seed=4)
    cfg = SolverConfig(max_iters=cap, tol=0.0, gtol=0.0)
    st = lbfgs.init_state(fun, theta0, cfg)
    out = lbfgs.run_segment(fun, st, cfg, num_iters)
    want = min(num_iters or cap, cap)
    assert out.iteration == want
    assert int(out.n_iters.max()) <= want


def test_take_state_rows_continue_bitwise():
    fun, theta0, _ = _quadratics(b=8, p=6, seed=5)
    cfg = SolverConfig(max_iters=30, tol=0.0, gtol=1e-9)
    st = lbfgs.run_segment(fun, lbfgs.init_state(fun, theta0, cfg), cfg, 3)
    full = lbfgs.run_segment(fun, st, cfg, 5)
    idx = torch.tensor([6, 1, 3])

    def sub_fun(theta):
        # The same quadratics, restricted to rows idx (padded back to the
        # full batch for the objective, then cut).
        pad = torch.zeros((8, theta.shape[1]))
        pad[idx] = theta
        f, g = fun(pad)
        return f[idx], g[idx]

    sub = lbfgs.run_segment(sub_fun, lbfgs.take_state(st, idx), cfg, 5)
    for f in lbfgs.LbfgsResult._fields:
        assert torch.equal(getattr(lbfgs.to_result(sub), f),
                           getattr(lbfgs.to_result(full), f)[idx]), f


def test_jax_reference_runs_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
