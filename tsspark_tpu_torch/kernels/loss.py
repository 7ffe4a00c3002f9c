"""K3 ``loss``: the MAP objective and its gradient as one CUDA kernel.

``loss`` is the wrapper ``models.prophet.loss`` calls (``value_batch``,
``value_and_grad_batch``).  On a CPU tensor it runs the plain PyTorch
version, ``loss_plain``, whose gradient is written out by hand: the same
sums the kernel takes (``csrc/loss.cu``), with logistic growth's pull
back through the offset recursion on top (the kernel's logistic branch
takes the same pull-back).  On a CUDA tensor it launches the kernel or
raises.  ``launches`` counts kernel launches, ``grad_launches`` those in
gradient mode among them, ``stack_launches`` those in a stack layout (the
trial stack's or the draw stack's).

``theta`` may hold N stacked copies of the batch, (N * B, P) for a (B, T)
``data``: row i is scored on data row i % B (the stacked line-search
trials of logistic and flat growth, the fallback row, and ADVI's draws).
Such a stack (N > 1) goes through the kernel's stack layout of its mode
where that layout's shared-memory plan fits the card
(``uses_stack_layout``): in value mode the trial-stack layout, which
stages each data row once for 21 trials, three a warp
(``stack_block_rows``); in gradient mode the draw-stack layout, which
stages it once for four draws, all in one warp (``draw_block_rows``).  A
row's value and gradient are the same bits in either layout as in the
row layout.  The kernel needs ``t`` rising along each row and ascending
changepoints, as ``prepare_fit_data`` builds them (K4 too).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import build
from tsspark_tpu_torch.kernels.forward import (
    GROWTH_CODES,
    _require,
    aligned16,
)

#: Kernel launches since the count was last set to 0, those of them in
#: gradient mode, and those in a stack layout (trial or draw stack).
launches = 0
grad_launches = 0
stack_launches = 0

# The K3 / K4 kernels' shared-memory plan (csrc/loss.cu, csrc/fan.cu
# ``Plan``): a block of ROWS row warps, one row each, and one producer
# warp walks T in tiles through a STAGES-deep pipeline; seasonal columns
# are unrolled to the next of _FS_BUCKETS.  K3's trial-stack layout gives
# each row warp TRIALS_PER_WARP trials of one series and stages one row a
# stage; its draw-stack layout gives each row warp ``draws_per_warp``
# draws of one series.
ROWS = 7
STAGES = 2
TRIALS_PER_WARP = 3
_FS_BUCKETS = (8, 16, 24, 32, 48, 64)
_MAX_SMEM_BYTES = 232448


def _r4(n: int) -> int:
    return (n + 3) & ~3


def draws_per_warp(kfs: int) -> int:
    """Draws a warp of the draw-stack layout: four where four draws'
    column sums fit a lane's registers (up to 32 seasonal columns), else
    two (``csrc/loss.cu`` ``draws_per_warp``)."""
    return 4 if kfs <= 32 else 2


def uses_stack_layout(n_rows: int, b: int, grad: bool,
                      config: ProphetConfig, per_series: bool) -> bool:
    """Whether ``loss`` launches a stack layout: a stack of more than one
    copy of the batch, where the mode's layout (value: the trial stack's
    21 slots; gradient: the draw stack's 7 x ``draws_per_warp`` slots)
    fits the card's shared memory (past that, many changepoints or
    columns, the row layout: the same bits).  ``csrc/loss.cu``
    ``launch`` makes the same choice from the same plan."""
    return (n_rows > b
            and _plan_bytes("loss", config, per_series, grad, True)
            <= _MAX_SMEM_BYTES)


def stack_block_rows(n_trials: int, b: int) -> list:
    """The trial-stack layout's block plan (``csrc/loss.cu``,
    ``stack_kernel``): for each block in launch order, the rows of each of
    its row warps.  Series s takes ceil(n_trials / (ROWS *
    TRIALS_PER_WARP)) consecutive blocks; warp w of block g of them holds
    trials j = ROWS TRIALS_PER_WARP g + TRIALS_PER_WARP w + k, k <
    TRIALS_PER_WARP (those below n_trials), trial j's row being j b + s;
    warps past the last trial hold none.  This is the plan written out
    for the CPU tests; what checks the kernel itself is the card's
    bitwise tests (every trial against its row-layout launch alone)."""
    per_block = ROWS * TRIALS_PER_WARP
    groups = -(-n_trials // per_block)
    plan = []
    for x in range(b * groups):
        series, g0 = x // groups, (x % groups) * per_block
        warps = []
        for w in range(ROWS):
            j0 = g0 + w * TRIALS_PER_WARP
            warps.append([j * b + series for j in range(
                j0, min(j0 + TRIALS_PER_WARP, n_trials))])
        plan.append(warps)
    return plan


def draw_block_rows(n_draws: int, b: int, kfs: int) -> list:
    """The draw-stack layout's block plan (``csrc/loss_draws.cuh``,
    ``draw_kernel``): for each block in launch order, the rows of each of
    its row warps.  With d = ``draws_per_warp(kfs)``, unit u = ROWS x + w
    (block x, warp w) is series u % b and draw group u // b, holding the
    draws j = d (u // b) + k, k < d (those below n_draws), draw j's row
    being j b + u % b; warps past the last unit hold none.  This is the
    plan written out for the CPU tests; what checks the kernel itself is
    the card's bitwise tests (every draw against its row-layout launch
    alone)."""
    d = draws_per_warp(kfs)
    units = -(-n_draws // d) * b
    plan = []
    for x in range(-(-units // ROWS)):
        warps = []
        for w in range(ROWS):
            u = ROWS * x + w
            if u >= units:
                warps.append([])
                continue
            series, j0 = u % b, (u // b) * d
            warps.append([j * b + series for j in range(
                j0, min(j0 + d, n_draws))])
        plan.append(warps)
    return plan


def _plan_bytes(kernel: str, config: ProphetConfig, per_series: bool,
                grad: bool, stack: bool) -> int:
    """Bytes of ``smem_bytes``'s plan, past the card's limit or not
    (``stack``: the loss kernel's stack layout of the mode: the trial
    stack's in value mode, the draw stack's in gradient mode)."""
    ncp = config.n_changepoints
    fs = config.num_seasonal_features
    r = config.num_regressors
    p = config.num_params
    if fs % 2 or fs > _FS_BUCKETS[-1]:
        raise ValueError(
            f"{kernel} kernel: {fs} seasonal columns; it takes an even "
            f"number (sin/cos pairs) up to {_FS_BUCKETS[-1]}")
    kfs = next(k for k in _FS_BUCKETS if fs <= k)
    if stack and grad and kfs == 32 and fs <= 28:
        kfs = 28  # the draw-stack layout's own bucket (csrc/loss.cu)
    tile = 32 if per_series else 128
    if kernel == "loss":
        row = (_r4(p) + 3 * _r4(ncp) + 2 * _r4(ncp + 1) + 4 * kfs
               + 4 * _r4(r) + _r4(r + kfs + 2) + _r4(fs + r))
    else:
        row = (2 * _r4(p) + _r4(ncp) + 4 * _r4(ncp + 1) + 4 * kfs
               + 4 * _r4(r) + 16 + _r4(fs + r))
    streams = 4 if kernel == "loss" and config.growth == "logistic" else 3
    st_row = streams * (tile + 8) + _r4(tile * r) + 8
    st_x = _r4(tile * fs) + 8 + kfs
    if stack and not grad:
        return 4 * (4 * STAGES + ROWS * TRIALS_PER_WARP * row
                    + STAGES * (st_row + st_x))
    slots = draws_per_warp(kfs) if stack else 1
    st_x *= ROWS if per_series else 1
    racc = _r4(r) * 32 * (ROWS + 1) if kernel == "loss" and grad else 0
    return 4 * (4 * STAGES + ROWS * slots * row
                + STAGES * (ROWS * st_row + st_x) + slots * racc)


def smem_bytes(kernel: str, config: ProphetConfig, per_series: bool,
               grad: bool = True, stack: bool = False) -> int:
    """Bytes of shared memory one block of the ``"loss"`` or ``"fan"``
    kernel takes for ``config`` (the loss kernel stages each row's
    capacity too under logistic growth; ``stack``: its stack layout of
    the mode, the trial stack's or the draw stack's); ValueError past the
    kernels' limits."""
    total = _plan_bytes(kernel, config, per_series, grad, stack)
    if total > _MAX_SMEM_BYTES:
        raise ValueError(
            f"{kernel} kernel: {config.n_changepoints} changepoints, "
            f"{config.num_seasonal_features} seasonal and "
            f"{config.num_regressors} regressor columns need {total} bytes "
            f"of shared memory a block, past the card's {_MAX_SMEM_BYTES}")
    return total


# models/prophet/loss.py's constants (the kernel's copies live in
# csrc/prophet_model.cuh).
HUBER_EPS = 1e-4
SIGMA_FLOOR = 1e-5


def smooth_abs(x: torch.Tensor, eps: float = HUBER_EPS) -> torch.Tensor:
    """C1 approximation of |x| (pseudo-Huber)."""
    return torch.sqrt(x * x + eps * eps) - eps


def _logistic_pullback(k, m, delta, s, dx_drate, dx_doff, t):
    """Gradient of the logistic trend's data term w.r.t. (k, m, delta).

    ``dx_drate``, ``dx_doff``: (B, T) adjoints of the trend's rate
    k + A delta and offset m + A gamma; gamma's recursion
    (``trend._logistic_gamma``) is pulled back by hand, last changepoint
    first.
    """
    from tsspark_tpu_torch.models.prophet.trend import _safe_div

    ncp = delta.shape[-1]
    gk = dx_drate.sum(dim=-1)
    gm = dx_doff.sum(dim=-1)
    if ncp == 0:
        return gk, gm, delta.new_zeros(delta.shape)
    active = [(t >= s[:, j : j + 1]).to(t.dtype) for j in range(ncp)]
    gdelta = [(dx_drate * a).sum(dim=-1) for a in active]
    ggamma = [(dx_doff * a).sum(dim=-1) for a in active]
    # Forward recursion, keeping what the pull-back needs.
    eps = 1e-10
    csum = torch.zeros_like(k)
    gamma_sum = torch.zeros_like(m)
    k_prev = k
    rec = []
    for j in range(ncp):
        csum = csum + delta[:, j]
        k_next = k + csum
        q = _safe_div(k_prev, k_next)
        a = s[:, j] - m - gamma_sum
        rec.append((k_prev, k_next, a, 1.0 - q))
        gamma_sum = gamma_sum + a * (1.0 - q)
        k_prev = k_next
    # Pull-back: adjoints of gamma_sum, of k_next_j (as the next step's
    # k_prev) and of each k_next_j in total.
    g_gsum = torch.zeros_like(m)
    g_kprev = torch.zeros_like(k)
    g_knext = [None] * ncp
    gm_rec = torch.zeros_like(m)
    for j in reversed(range(ncp)):
        kp, kn, a, one_minus_q = rec[j]
        g_gamma = ggamma[j] + g_gsum
        g_a = g_gamma * one_minus_q
        g_q = -(g_gamma * a)
        gm_rec = gm_rec - g_a
        g_gsum = g_gsum - g_a
        clamped = kn.abs() < eps
        safe = torch.where(clamped, torch.where(kn < 0, -eps, eps), kn)
        g_kn = g_kprev + torch.where(clamped, 0.0, -g_q * kp / (safe * safe))
        g_knext[j] = g_kn
        g_kprev = g_q / safe
    gk = gk + g_kprev + torch.stack(g_knext, dim=-1).sum(dim=-1)
    # delta_l enters every k_next_j with j >= l: a reverse cumulative sum.
    tail = torch.flip(torch.cumsum(torch.flip(torch.stack(g_knext, -1),
                                              [-1]), -1), [-1])
    gdelta = torch.stack(gdelta, dim=-1) + tail
    return gk, gm + gm_rec, gdelta


def _loss_rows(theta, data, config, grad: bool):
    """The plain version on one (B, P) block against (B, T) data.

    The objective's one plain copy (``neg_log_posterior`` is its value
    half).  ``kernels.fan.fan_plain`` and the K3 / K4 kernels re-derive
    every term — a change here must be mirrored there.
    """
    from tsspark_tpu_torch.models.prophet.design import (
        seasonal_split,
        trend_fn,
    )
    from tsspark_tpu_torch.models.prophet.params import unpack

    p = unpack(theta, config)
    g = trend_fn(p, data, config)
    add, mult = seasonal_split(theta, data, config)
    yhat = g * (1.0 + mult) + add
    sigma = SIGMA_FLOOR + torch.exp(p.log_sigma)
    resid = (data.y - yhat) * data.mask
    n_obs = data.mask.sum(dim=-1)
    ssr = (resid * resid).sum(dim=-1)
    nll = 0.5 * ssr / (sigma * sigma) + n_obs * torch.log(sigma)
    prior = 0.5 * (p.k / config.k_prior_scale) ** 2
    prior = prior + 0.5 * (p.m / config.m_prior_scale) ** 2
    prior = prior + 0.5 * (sigma / config.sigma_prior_scale) ** 2
    cps = config.changepoint_prior_scale
    if config.n_changepoints:
        prior = prior + (smooth_abs(p.delta) / cps).sum(dim=-1)
    if config.num_features:
        prior = prior + 0.5 * ((p.beta / data.prior_scales) ** 2).sum(dim=-1)
    f = nll + prior
    if not grad:
        return f, None

    # w = -df/dyhat; u = -df/dtrend.
    inv_s2 = 1.0 / (sigma * sigma)
    w = resid * data.mask * inv_s2[:, None]
    u = w * (1.0 + mult)
    t = data.t
    if config.growth == "linear":
        gk = -(u * t).sum(dim=-1)
        gm = -u.sum(dim=-1)
        gdelta = [-(u * torch.clamp(t - data.s[:, j : j + 1], min=0.0))
                  .sum(dim=-1) for j in range(config.n_changepoints)]
        gdelta = (torch.stack(gdelta, dim=-1) if gdelta
                  else theta.new_zeros((theta.shape[0], 0)))
    elif config.growth == "flat":
        gk = torch.zeros_like(p.k)
        gm = -u.sum(dim=-1)
        gdelta = torch.zeros_like(p.delta)
    else:
        # d trend / dx = cap sig(x) (1 - sig(x)), x = rate * (t - offset).
        from tsspark_tpu_torch.models.prophet import trend as trend_mod

        rate = p.k[:, None] + trend_mod.step_weighted_sum(p.delta, t, data.s)
        gamma = trend_mod._logistic_gamma(p.k, p.m, p.delta, data.s)
        offset = p.m[:, None] + trend_mod.step_weighted_sum(gamma, t, data.s)
        sig = torch.sigmoid(rate * (t - offset))
        v = -u * data.cap * sig * (1.0 - sig)   # df/dx
        gk, gm, gdelta = _logistic_pullback(
            p.k, p.m, p.delta, data.s, v * (t - offset), -v * rate, t)
    gk = gk + p.k / config.k_prior_scale ** 2
    gm = gm + p.m / config.m_prior_scale ** 2
    e = torch.exp(p.log_sigma)
    gls = e * (-ssr / (sigma * sigma * sigma) + n_obs / sigma
               + sigma / config.sigma_prior_scale ** 2)
    if config.n_changepoints:
        gdelta = gdelta + (p.delta / torch.sqrt(p.delta * p.delta
                                                + HUBER_EPS * HUBER_EPS)) / cps
    fs = config.num_seasonal_features
    gbeta = []
    for f_i in range(config.num_features):
        mf = data.mult_mask[f_i]
        coef = (1.0 - mf) * w + mf * (w * g)
        x = (data.X_season[..., f_i] if f_i < fs
             else data.X_reg[..., f_i - fs])
        gbeta.append(p.beta[:, f_i] / data.prior_scales[f_i] ** 2
                     - (coef * x).sum(dim=-1))
    gbeta = (torch.stack(gbeta, dim=-1) if gbeta
             else theta.new_zeros((theta.shape[0], 0)))
    grad_out = torch.cat([gk[:, None], gm[:, None], gls[:, None], gdelta,
                          gbeta], dim=-1)
    return f, grad_out


def loss_plain(theta: torch.Tensor, data, config: ProphetConfig,
               grad: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(f (N*B,), g (N*B, P) or None) for ``theta`` (N*B, P) on (B, T)
    data: each block of B rows in turn."""
    b = data.t.shape[0]
    n = theta.shape[0]
    if n == b:
        return _loss_rows(theta, data, config, grad)
    if b == 0 or n % b:
        raise ValueError(f"loss: {n} parameter rows for {b} data rows")
    parts = [_loss_rows(theta[i:i + b], data, config, grad)
             for i in range(0, n, b)]
    f = torch.cat([pt[0] for pt in parts])
    return f, (torch.cat([pt[1] for pt in parts]) if grad else None)


def loss(theta: torch.Tensor, data, config: ProphetConfig,
         grad: bool = True
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The objective (and its gradient); see ``loss_plain``."""
    global launches, grad_launches, stack_launches
    dev = theta.device
    if dev.type == "cpu":
        return loss_plain(theta, data, config, grad)
    if dev.type != "cuda":
        raise ValueError(f"loss: unsupported device {dev}")
    b, t_len = data.t.shape
    n = theta.shape[0]
    ncp = config.n_changepoints
    fs = config.num_seasonal_features
    r = config.num_regressors
    f_all = fs + r
    if b == 0 or n % b:
        raise ValueError(f"loss: {n} parameter rows for {b} data rows")
    per_series = data.X_season.ndim == 3
    stack = uses_stack_layout(n, b, grad, config, per_series)
    smem_bytes("loss", config, per_series, grad, stack)
    _require("theta", theta, (n, config.num_params), dev)
    logistic = config.growth == "logistic"
    for name in ("t", "y", "mask") + (("cap",) if logistic else ()):
        _require(name, getattr(data, name), (b, t_len), dev)
    _require("s", data.s, (b, ncp), dev)
    xs = data.X_season
    if xs.ndim == 2:
        _require("X_season", xs, (t_len, fs), dev)
        xs_bstride = 0
    else:
        _require("X_season", xs, (b, t_len, fs), dev)
        xs_bstride = t_len * fs
    _require("X_reg", data.X_reg, (b, t_len, r), dev)
    t, y, mask, xs, xr = aligned16(data.t, data.y, data.mask, xs, data.X_reg)
    cap = aligned16(data.cap)[0] if logistic else None
    _require("prior_scales", data.prior_scales, (f_all,), dev)
    _require("mult_mask", data.mult_mask, (f_all,), dev)
    f = torch.empty((n,), dtype=torch.float32, device=dev)
    g = (torch.empty((n, config.num_params), dtype=torch.float32, device=dev)
         if grad else None)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tsspark_loss(
            theta.data_ptr(), t.data_ptr(), y.data_ptr(), mask.data_ptr(),
            None if cap is None else cap.data_ptr(),
            data.s.data_ptr(), xs.data_ptr(), xs_bstride, xr.data_ptr(),
            data.prior_scales.data_ptr(),
            data.mult_mask.data_ptr(), f.data_ptr(),
            None if g is None else g.data_ptr(),
            n, b, t_len, config.num_params, ncp, fs, r,
            GROWTH_CODES[config.growth], config.k_prior_scale,
            config.m_prior_scale, config.sigma_prior_scale,
            config.changepoint_prior_scale, stream,
        )
    build.check(err, "loss")
    launches += 1
    grad_launches += bool(grad)
    stack_launches += stack
    return f, g
