"""The port's MAP objective against the JAX package: ``neg_log_posterior``,
``value_batch``, ``value_and_grad_batch`` (the K3 kernel's plain version,
gradient written out by hand) and ``fan_value_closed_form`` (K4's plain
version), on the same inputs made from numpy seeds.

Tolerances, with their reasons:
  * loss: rtol 2e-5 — float32 sums over T of another order (the JAX
    package adds features as einsums, the port in feature order);
  * gradient against jax.vjp: |g_port - g_jax| <= 2e-4 * (1 + |g|_max of
    the row) — each entry is a sum over T of ~1e2-magnitude terms in
    float32, taken in another order;
  * hand-written gradient against torch.autograd in float64: rtol 1e-9
    (same arithmetic, exact up to float64 rounding);
  * fan against JAX and against a direct evaluation of each rung: rtol
    1e-4 on the loss — the closed form expands the sum of squares, which
    cancels in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import chip_smoke
from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import loss as jloss
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.kernels import fan as fan_kernel
from tsspark_tpu_torch.kernels import loss as loss_kernel
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import loss as tloss

torch.set_num_threads(2)

T = torch.from_numpy
J = jnp.asarray


def _case(growth, mode, per_series, regs, seed=0, b=6, t_len=80):
    """The same config, FitData and theta in both packages."""
    kw = dict(growth=growth, n_changepoints=5, seasonality_mode=mode)
    cfgs = []
    for mod in (jcfg, tcfg):
        seas = (dataclasses.replace(mod.YEARLY, fourier_order=3, mode=mode),
                dataclasses.replace(mod.WEEKLY, mode="additive"))
        regs_c = tuple(mod.RegressorConfig(f"r{i}",
                                           mode="multiplicative" if i else
                                           "additive", prior_scale=2.0)
                       for i in range(regs))
        cfgs.append(mod.ProphetConfig(seasonalities=seas, regressors=regs_c,
                                      **kw))
    jc, tc = cfgs
    rng = np.random.default_rng(seed)
    ds = 18000.0 + np.arange(t_len, dtype=np.float64)
    if per_series:
        ds = ds[None, :] + rng.integers(0, 200, (b, 1))
    y = (10 + 0.05 * np.arange(t_len) + np.sin(np.asarray(ds) / 7.0)
         + rng.normal(0, 0.3, (b, t_len)))
    y = np.broadcast_to(y, (b, t_len)).copy()
    y[rng.uniform(size=y.shape) < 0.1] = np.nan
    kwargs = {}
    if regs:
        kwargs["regressors"] = rng.normal(0, 1, (b, t_len, regs))
    if growth == "logistic":
        kwargs["cap"] = np.full((b, t_len), 20.0)
    data_t, _ = tdesign.prepare_fit_data(ds, y, tc, **kwargs)
    data_j, _ = jdesign.prepare_fit_data(ds, y, jc, as_numpy=True, **kwargs)
    theta = rng.normal(0, 0.1, (b, tc.num_params)).astype(np.float32)
    theta[:, 0] = rng.normal(0.5, 0.3, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    theta[:, 2] = np.log(rng.uniform(0.03, 0.3, b))
    data_t = tdesign.FitData(*(T(np.ascontiguousarray(a)) for a in data_t))
    data_j = jdesign.FitData(*(J(a) for a in data_j))
    return jc, tc, data_j, data_t, theta


CASES = [
    (g, mode, per_series, regs)
    for g in ("linear", "flat", "logistic")
    for mode in ("additive", "multiplicative")
    for per_series in (False, True)
    for regs in (0, 3)
]


def _grad_close(got, want):
    scale = 1.0 + np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 2e-4 * scale), \
        np.max(np.abs(got - want) / scale)


@pytest.mark.parametrize("growth,mode,per_series,regs", CASES)
def test_value_and_grad_match_jax(growth, mode, per_series, regs):
    jc, tc, data_j, data_t, theta = _case(growth, mode, per_series, regs)
    f_t, g_t = tloss.value_and_grad_batch(T(theta), data_t, tc)
    f_j, g_j = jloss.value_and_grad_batch(J(theta), data_j, jc)
    npt.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-5)
    _grad_close(g_t.numpy(), np.asarray(g_j))
    npt.assert_allclose(tloss.value_batch(T(theta), data_t, tc).numpy(),
                        np.asarray(jloss.value_batch(J(theta), data_j, jc)),
                        rtol=2e-5)
    npt.assert_allclose(
        tloss.neg_log_posterior(T(theta), data_t, tc).numpy(),
        np.asarray(jloss.neg_log_posterior(J(theta), data_j, jc)),
        rtol=2e-5)


@pytest.mark.parametrize("growth,mode,per_series,regs", CASES)
def test_hand_gradient_matches_autograd(growth, mode, per_series, regs):
    _, tc, _, data_t, theta = _case(growth, mode, per_series, regs, seed=1)
    data64 = tdesign.FitData(*(a.double() for a in data_t))
    th = T(theta).double().requires_grad_(True)
    f = tloss.neg_log_posterior(th, data64, tc)
    (g_auto,) = torch.autograd.grad(f.sum(), th)
    f_hand, g_hand = loss_kernel.loss_plain(th.detach(), data64, tc)
    npt.assert_allclose(f_hand.numpy(), f.detach().numpy(), rtol=1e-12)
    npt.assert_allclose(g_hand.numpy(), g_auto.numpy(), rtol=1e-9,
                        atol=1e-9)


def test_stacked_trials_reuse_the_data_rows():
    """(N, B, P) trial stacks score row i on data row i % B: the same
    values as N separate calls."""
    _, tc, _, data_t, theta = _case("flat", "additive", False, 3)
    rng = np.random.default_rng(3)
    stack = T(theta[None] + rng.normal(0, 0.05, (4,) + theta.shape)
              .astype(np.float32))
    got = tloss.value_batch(stack, data_t, tc)
    assert got.shape == (4, theta.shape[0])
    for n in range(4):
        assert torch.equal(got[n], tloss.value_batch(stack[n], data_t, tc))
    with pytest.raises(ValueError, match="parameter rows"):
        loss_kernel.loss_plain(stack.reshape(-1, tc.num_params)[:-1],
                               data_t, tc)


@pytest.mark.parametrize("n_rows,b,grad,stack", [
    (21 * 8, 8, False, True), (2 * 8, 8, False, True), (8, 8, False, False),
    (21 * 8, 8, True, False), (8, 8, True, False),
])
@pytest.mark.parametrize("per_series", [False, True])
def test_stack_layout_dispatch_rule(n_rows, b, grad, stack, per_series):
    """The wrapper launches the trial-stack layout for value mode on a
    stack of more than one copy of the batch, the row layout otherwise
    (config 4: the layout's plan fits)."""
    from tsspark_tpu_torch.eval.configs import CONFIG4

    assert loss_kernel.uses_stack_layout(n_rows, b, grad, CONFIG4,
                                         per_series) is stack


@pytest.mark.parametrize("growth", ["logistic", "flat"])
@pytest.mark.parametrize("ncp,order,regs", [(300, 32, 0), (400, 10, 0)])
def test_stack_layout_gives_way_where_its_plan_does_not_fit(growth, ncp,
                                                            order, regs):
    """Where the trial-stack layout's 21 slots pass the card's shared
    memory (many changepoints or columns) while the row layout's 7 still
    fit, a value-mode stack goes through the row layout: the kernel, not
    a refusal."""
    cfg = tcfg.ProphetConfig(
        growth=growth, n_changepoints=ncp,
        seasonalities=(tcfg.SeasonalityConfig("yearly", 365.25, order),),
        regressors=tuple(tcfg.RegressorConfig(f"r{i}")
                         for i in range(regs)))
    with pytest.raises(ValueError, match="shared memory"):
        loss_kernel.smem_bytes("loss", cfg, False, False, True)
    assert loss_kernel.smem_bytes("loss", cfg, False, False, False) \
        <= 232448
    assert not loss_kernel.uses_stack_layout(21 * 8, 8, False, cfg, False)


@pytest.mark.parametrize("n_trials,b", [
    (2, 8), (3, 10), (21, 13), (21, 8192), (7, 5), (1, 9), (9, 1),
])
def test_stack_layout_covers_every_trial_row_once(n_trials, b):
    """The trial-stack layout's block plan: every (trial, series) row in
    exactly one warp of one block, each block's rows of one series (one
    data row a stage), a warp's trials consecutive and at most
    TRIALS_PER_WARP, the blocks of a series adjacent in launch order,
    ceil(n / (ROWS * TRIALS_PER_WARP)) of them."""
    per_warp = loss_kernel.TRIALS_PER_WARP
    plan = loss_kernel.stack_block_rows(n_trials, b)
    groups = -(-n_trials // (loss_kernel.ROWS * per_warp))
    assert len(plan) == b * groups
    rows = [r for block in plan for warp in block for r in warp]
    assert sorted(rows) == list(range(n_trials * b))
    for x, block in enumerate(plan):
        assert len(block) == loss_kernel.ROWS
        flat = [r for warp in block for r in warp]
        assert {r % b for r in flat} == {x // groups}
        trials = [r // b for r in flat]
        assert trials == list(range(trials[0], trials[0] + len(flat)))
        assert all(len(warp) <= per_warp for warp in block)
        # Live warps come first: a warp past the last trial holds none.
        sizes = [len(warp) for warp in block]
        assert sizes == sorted(sizes, reverse=True)


def _ladder(b, k=20, seed=0):
    rng = np.random.default_rng(seed)
    step0 = rng.uniform(0.1, 1.0, b).astype(np.float32)
    return (step0[None, :] * 0.5 ** np.arange(k, dtype=np.float32)[:, None])


@pytest.mark.parametrize("mode,per_series,regs", [
    ("additive", False, 3), ("multiplicative", False, 3),
    ("additive", True, 0), ("multiplicative", True, 3),
])
def test_fan_matches_jax_and_direct_rungs(mode, per_series, regs):
    jc, tc, data_j, data_t, theta = _case("linear", mode, per_series, regs,
                                          seed=4)
    rng = np.random.default_rng(5)
    d = rng.normal(0, 0.05, theta.shape).astype(np.float32)
    ladder = _ladder(theta.shape[0])
    got = tloss.fan_value_closed_form(T(theta), T(d), T(ladder), data_t, tc)
    want = jloss.fan_value_closed_form(J(theta), J(d), J(ladder), data_j, jc)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    direct = tloss.value_batch(
        T(theta[None] + ladder[:, :, None] * d[None]), data_t, tc)
    npt.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-4)


def test_fan_clamps_a_cancelled_sum_of_squares():
    """Where a step zeroes the residual, the expanded sum of squares
    cancels in float32 and can go negative; the fan clamps it at 0 (no
    falsely low loss), as the JAX package does, and keeps NaN."""
    jc, tc, data_j, data_t, theta = _case("linear", "additive", False, 0,
                                          seed=6, b=32)
    rng = np.random.default_rng(7)
    target = theta + rng.normal(0, 0.2, theta.shape).astype(np.float32)
    yhat, _ = tdesign.model_yhat(T(target), data_t, tc)
    exact = data_t._replace(y=yhat * data_t.mask)
    exact_j = data_j._replace(y=J(exact.y.numpy()))
    d = target - theta
    ladder = np.ones((1, theta.shape[0]), np.float32)
    # The unclamped polynomial at s = 1, as the fan expands it.
    from tsspark_tpu_torch.models.prophet.params import unpack

    p0, pd = unpack(T(theta), tc), unpack(T(d), tc)
    c0 = tdesign.trend_fn(p0, exact, tc) + tdesign.seasonal_split(
        T(theta), exact, tc)[0]
    c1 = tdesign.trend_fn(pd, exact, tc) + tdesign.seasonal_split(
        T(d), exact, tc)[0]
    r0 = (exact.y - c0) * exact.mask
    c1m = c1 * exact.mask
    poly = ((r0 * r0).sum(-1) - 2.0 * (r0 * c1m).sum(-1)
            + (c1m * c1m).sum(-1))
    assert bool((poly < 0).any()), "no row reached the clamp"
    got = tloss.fan_value_closed_form(T(theta), T(d), T(ladder), exact, tc)
    want = jloss.fan_value_closed_form(J(theta), J(d), J(ladder), exact_j,
                                       jc)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # With ssr = 0 the loss is its sigma and prior terms alone.
    sigma = loss_kernel.SIGMA_FLOOR + torch.exp(T(target)[:, 2])
    floor_f = (exact.mask.sum(-1) * torch.log(sigma))
    assert bool((got[0] >= floor_f - 1e-3 * floor_f.abs()).all())
    d_nan = d.copy()
    d_nan[0, 0] = np.nan
    bad = tloss.fan_value_closed_form(T(theta), T(d_nan), T(ladder), exact,
                                      tc)
    assert bool(torch.isnan(bad[0, 0])) and bool(torch.isfinite(bad[0, 1:])
                                                 .all())


def test_fan_needs_linear_growth_on_the_card_and_wrappers_refuse_others():
    _, tc, _, data_t, theta = _case("linear", "additive", False, 0)
    meta = lambda a: a.to("meta")  # noqa: E731
    before = (loss_kernel.launches, loss_kernel.stack_launches,
              fan_kernel.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        loss_kernel.loss(meta(T(theta)), data_t, tc)
    with pytest.raises(ValueError, match="unsupported device"):
        loss_kernel.loss(meta(T(np.concatenate([theta, theta]))), data_t, tc,
                         grad=False)
    with pytest.raises(ValueError, match="unsupported device"):
        fan_kernel.fan(meta(T(theta)), meta(T(theta)),
                       meta(T(_ladder(theta.shape[0]))), data_t, tc)
    assert (loss_kernel.launches, loss_kernel.stack_launches,
            fan_kernel.launches) == before
    assert tloss.has_closed_form_fan(tc)
    assert not tloss.has_closed_form_fan(
        dataclasses.replace(tc, growth="flat"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("growth,mode,per_series,regs",
                         [c for c in CASES if c[0] != "logistic"])
def test_loss_and_fan_kernels_match_their_plain_versions(card, growth, mode,
                                                         per_series, regs):
    _, tc, _, data_t, theta = _case(growth, mode, per_series, regs)
    on = tdesign.FitData(*(a.to(card) for a in data_t))
    f_k, g_k = loss_kernel.loss(T(theta).to(card), on, tc)
    f_p, g_p = loss_kernel.loss_plain(T(theta), data_t, tc)
    npt.assert_allclose(f_k.cpu().numpy(), f_p.numpy(), rtol=2e-5)
    _grad_close(g_k.cpu().numpy(), g_p.numpy())
    if growth == "linear":
        d = np.random.default_rng(2).normal(0, 0.05, theta.shape).astype(
            np.float32)
        lad = _ladder(theta.shape[0])
        got = fan_kernel.fan(T(theta).to(card), T(d).to(card),
                             T(lad).to(card), on, tc)
        want = fan_kernel.fan_plain(T(theta), T(d), T(lad), data_t, tc)
        npt.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4)


def test_logistic_loss_on_the_card_raises(card):
    """Logistic growth, once refused on the card (the name is that
    check's), now runs K3's logistic branch: on every logistic case, the
    loss and a trial stack against the plain version by
    ``chip_smoke.GAP_RULE`` (a float32 sum's bound a row: a trial row's
    loss of large cancelling terms is no relative-tolerance case), the
    gradient at the linear and flat cases' tolerance."""
    for growth, mode, per_series, regs in CASES:
        if growth != "logistic":
            continue
        _, tc, _, data_t, theta = _case(growth, mode, per_series, regs)
        on = tdesign.FitData(*(a.to(card) for a in data_t))
        f_k, g_k = loss_kernel.loss(T(theta).to(card), on, tc)
        f_p, g_p = loss_kernel.loss_plain(T(theta), data_t, tc)
        _grad_close(g_k.cpu().numpy(), g_p.numpy())
        stack = T(np.concatenate([theta, theta * 1.01]))
        s_k, _ = loss_kernel.loss(stack.to(card), on, tc, grad=False)
        s_p, _ = loss_kernel.loss_plain(stack, data_t, tc, grad=False)
        gaps = chip_smoke.loss_gaps(T(theta), data_t, tc, {
            "f": (f_k.cpu(), f_p), "stack": (s_k.cpu(), s_p)})
        assert chip_smoke.within_gap_rule(gaps), gaps


@pytest.mark.parametrize("growth", ["linear", "logistic"])
def test_gap_rule_fails_a_planted_wrong_loss(growth):
    """The rule K3 is held to on the card fails a wrong loss: the plain
    loss of each row with one observed cell dropped (a kernel that skips
    a cell), and one row's loss moved by twice its bound; the sound
    plain loss against itself passes."""
    _, tc, _, data_t, theta = _case(growth, "additive", False, 3)
    th = T(theta)
    f_p, _ = loss_kernel.loss_plain(th, data_t, tc, grad=False)
    assert chip_smoke.within_gap_rule(
        chip_smoke.loss_gaps(th, data_t, tc, {"f": (f_p, f_p)}))
    mask = data_t.mask.clone()
    cell = torch.argmax(mask, dim=-1)
    mask[torch.arange(mask.shape[0]), cell] = 0.0
    f_drop, _ = loss_kernel.loss_plain(th, data_t._replace(mask=mask), tc,
                                       grad=False)
    gaps = chip_smoke.loss_gaps(th, data_t, tc, {"f": (f_drop, f_p)})
    assert not chip_smoke.within_gap_rule(gaps), gaps
    f_scale, _ = chip_smoke.loss_scales(th, data_t, tc)
    eps = float(np.finfo(np.float32).eps)
    bound = chip_smoke.GAP_TOL * data_t.t.shape[-1] * eps * f_scale
    moved = f_p.clone()
    moved[2] = moved[2] + 2.0 * bound[2]
    gaps = chip_smoke.loss_gaps(th, data_t, tc, {"f": (moved, f_p)})
    assert not chip_smoke.within_gap_rule(gaps), gaps


def test_jax_reference_is_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"


def test_kernel_limit_is_the_shared_memory_plan():
    """The wrappers' limit is the K3 / K4 kernels' own: an even number of
    seasonal columns up to 64, and a block's shared memory within the
    card's 227 KB; config 3 (the fit's main path) fits in both layouts."""
    from tsspark_tpu_torch.eval.configs import CONFIG3

    for per_series in (False, True):
        for kernel in ("loss", "fan"):
            assert loss_kernel.smem_bytes(kernel, CONFIG3, per_series) \
                <= 232448
    wide = dataclasses.replace(
        CONFIG3, seasonalities=(dataclasses.replace(tcfg.YEARLY,
                                                    fourier_order=40),))
    many = dataclasses.replace(CONFIG3, n_changepoints=2000)
    for cfg, what in ((wide, "seasonal columns"), (many, "shared memory")):
        for kernel in ("loss", "fan"):
            with pytest.raises(ValueError, match=what):
                loss_kernel.smem_bytes(kernel, cfg, False)


@pytest.mark.parametrize("growth", ["logistic", "flat"])
@pytest.mark.parametrize("per_series", [False, True])
def test_stack_layout_fits_three_blocks_a_multiprocessor(growth,
                                                         per_series):
    """The trial-stack layout's plan (21 slots, one row a stage) leaves
    room for the three blocks a multiprocessor it runs at the line
    search's configs: config 4 (logistic) and config 3 under flat
    growth (the card's 228 KB less 1 KB a block)."""
    from tsspark_tpu_torch.eval.configs import CONFIG3, CONFIG4

    cfg = CONFIG4 if growth == "logistic" else dataclasses.replace(
        CONFIG3, growth="flat")
    assert 3 * (loss_kernel.smem_bytes("loss", cfg, per_series, False, True)
                + 1024) <= 228 * 1024


@pytest.mark.parametrize("per_series", [False, True])
def test_fit_data_rises_along_t_and_s(per_series):
    """K3 and K4 carry each row's changepoint segment along its ascending
    walk over T: the fit's data must give t rising along every row and
    ascending changepoints, as prepare_fit_data does."""
    _, tc, _, data_t, _ = _case("linear", "additive", per_series, 3)
    assert bool((torch.diff(data_t.t, dim=-1) > 0).all())
    assert bool((torch.diff(data_t.s, dim=-1) >= 0).all())


def test_stack_past_its_plan_runs_the_row_layout(card):
    """A 21-trial value stack whose trial-stack plan passes the card's
    shared memory (logistic, 300 changepoints, 64 seasonal columns) goes
    through K3's row layout: no stack launch, every trial its own
    launch's bits."""
    cfg = tcfg.ProphetConfig(
        growth="logistic", n_changepoints=300,
        seasonalities=(tcfg.SeasonalityConfig("yearly", 365.25, 32),))
    rng = np.random.default_rng(3)
    b, t_len = 16, 400
    ds = 18000.0 + np.arange(t_len, dtype=np.float64)
    y = 10 + np.sin(ds / 7.0) + rng.normal(0, 0.3, (b, t_len))
    data, _ = tdesign.prepare_fit_data(ds, y, cfg,
                                       cap=np.full((b, t_len), 20.0))
    on = tdesign.FitData(*(T(np.ascontiguousarray(a)).to(card)
                           for a in data))
    theta = rng.normal(0, 0.005, (b, cfg.num_params)).astype(np.float32)
    theta[:, 0] = rng.uniform(1.0, 2.0, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    th = T(theta).to(card)
    trials = [th * (1.0 + 0.01 * n) for n in range(21)]
    before = loss_kernel.stack_launches
    fs, _ = loss_kernel.loss(torch.cat(trials).contiguous(), on, cfg, False)
    assert loss_kernel.stack_launches == before
    for n, part in enumerate(trials):
        fn, _ = loss_kernel.loss(part.contiguous(), on, cfg, False)
        assert torch.equal(fs[n * b:(n + 1) * b], fn)


def test_kernels_give_a_row_the_same_bits_anywhere(card):
    """K3 (both modes) and K4: a row's results are the same bits in a batch
    of its own, in a permuted batch and (K3) in a trial stack of 3B rows;
    in value mode a 21-trial stack (the trial-stack layout) gives each
    trial the row layout's bits."""
    _, tc, _, data_t, theta = _case("linear", "multiplicative", False, 3,
                                    b=40, t_len=300)
    on = tdesign.FitData(*(a.to(card) for a in data_t))
    th = T(theta).to(card)
    d = T(np.random.default_rng(8).normal(0, 0.05, theta.shape).astype(
        np.float32)).to(card)
    lad = T(_ladder(theta.shape[0])).to(card)
    sl = slice(10, 30)
    perm = torch.randperm(theta.shape[0],
                          generator=torch.Generator().manual_seed(1)).to(card)

    def rows(idx):
        return on._replace(**{f: getattr(on, f)[idx].contiguous()
                              for f in ("t", "y", "mask", "s", "cap",
                                        "X_reg")})

    for grad in (True, False):
        f, g = loss_kernel.loss(th, on, tc, grad)
        for idx in (sl, perm):
            f2, g2 = loss_kernel.loss(th[idx].contiguous(), rows(idx), tc,
                                      grad)
            assert torch.equal(f2, f[idx])
            assert g is None or torch.equal(g2, g[idx])
        parts = [th, th * 1.01, th * 0.99]
        fs, gs = loss_kernel.loss(torch.cat(parts).contiguous(), on, tc, grad)
        for n, part in enumerate(parts):
            fn, gn = loss_kernel.loss(part.contiguous(), on, tc, grad)
            block = slice(n * th.shape[0], (n + 1) * th.shape[0])
            assert torch.equal(fs[block], fn)
            assert gn is None or torch.equal(gs[block], gn)
    trials = [th * (1.0 + 0.01 * n) for n in range(21)]
    before = loss_kernel.stack_launches
    fs, _ = loss_kernel.loss(torch.cat(trials).contiguous(), on, tc, False)
    assert loss_kernel.stack_launches == before + 1
    for n, part in enumerate(trials):
        fn, _ = loss_kernel.loss(part.contiguous(), on, tc, False)
        assert torch.equal(fs[n * th.shape[0]:(n + 1) * th.shape[0]], fn)
    out = fan_kernel.fan(th, d, lad, on, tc)
    for idx in (sl, perm):
        got = fan_kernel.fan(th[idx].contiguous(), d[idx].contiguous(),
                             lad[:, idx].contiguous(), rows(idx), tc)
        assert torch.equal(got, out[:, idx])
