"""K4 ``fan``: the closed-form losses of a whole line-search ladder as one
CUDA kernel.

``fan`` is the wrapper ``models.prophet.loss.fan_value_closed_form``
calls.  On a CPU tensor it runs the plain PyTorch version, ``fan_plain``
(the JAX package's ``fan_value_closed_form`` in torch ops); on a CUDA
tensor it launches ``csrc/fan.cu`` or raises.  Linear growth only (the
only growth with a closed form along a ray).  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import build
from tsspark_tpu_torch.kernels.forward import _require, aligned16
from tsspark_tpu_torch.kernels.loss import SIGMA_FLOOR, smem_bytes, smooth_abs

#: Kernel launches since the count was last set to 0.
launches = 0


def ray_terms(theta: torch.Tensor, direction: torch.Tensor, data,
              config: ProphetConfig):
    """The per-cell terms of the model along ``theta + s * direction``.

    Along a ray the linear-growth model mean is the polynomial
    c0 + s c1 + s^2 c2.  Returns (r0, c1, c2) masked, each (B, T), with
    r0 = y - c0, and the unpacked ``theta`` and ``direction``.
    """
    from tsspark_tpu_torch.models.prophet.design import (
        seasonal_split,
        trend_fn,
    )
    from tsspark_tpu_torch.models.prophet.params import unpack

    p0 = unpack(theta, config)
    pd = unpack(direction, config)
    g0 = trend_fn(p0, data, config)
    gd = trend_fn(pd, data, config)        # linear map of d's trend block
    a0, m0 = seasonal_split(theta, data, config)
    ad, md = seasonal_split(direction, data, config)

    mask = data.mask
    c0 = g0 * (1.0 + m0) + a0
    c1 = gd * (1.0 + m0) + g0 * md + ad
    c2 = gd * md
    return (data.y - c0) * mask, c1 * mask, c2 * mask, p0, pd


def fan_plain(theta: torch.Tensor, direction: torch.Tensor,
              ladder: torch.Tensor, data, config: ProphetConfig
              ) -> torch.Tensor:
    """Losses (K, B) at ``theta + s * direction`` for every step s of the
    (K, B) ``ladder``.

    The masked sum of squares along the ray (``ray_terms``) is six
    reductions computed once; the Gaussian priors are quadratic in s, the
    sigma terms exact per step, and only the smoothed Laplace prior needs
    per-step work over (K, B, n_cp).
    """
    r0, c1m, c2m, p0, pd = ray_terms(theta, direction, data, config)
    s00 = (r0 * r0).sum(dim=-1)            # (B,)
    s01 = (r0 * c1m).sum(dim=-1)
    s02 = (r0 * c2m).sum(dim=-1)
    s11 = (c1m * c1m).sum(dim=-1)
    s12 = (c1m * c2m).sum(dim=-1)
    s22 = (c2m * c2m).sum(dim=-1)
    n_obs = data.mask.sum(dim=-1)

    s = ladder                             # (K, B)
    s2_ = s * s
    sigma = SIGMA_FLOOR + torch.exp(p0.log_sigma[None] + s * pd.log_sigma[None])
    # The expanded sum of squares can go slightly negative from float32
    # cancellation where a step nearly zeroes the residual; the clamp
    # keeps NaN (torch.clamp propagates it), so a bad ray is rejected.
    ssr = torch.clamp(
        s00[None]
        - 2.0 * s * s01[None]
        + s2_ * (s11[None] - 2.0 * s02[None])
        + 2.0 * s * s2_ * s12[None]
        + s2_ * s2_ * s22[None],
        min=0.0,
    )
    nll = 0.5 * ssr / (sigma * sigma) + n_obs[None] * torch.log(sigma)

    # Gaussian priors: 0.5*((a + s b)/c)^2 summed -> quadratic in s.
    def quad(a, b, c):
        return (
            0.5 * ((a / c) ** 2).sum(dim=-1)[None]
            + s * (a * b / (c * c)).sum(dim=-1)[None]
            + 0.5 * s * s * ((b / c) ** 2).sum(dim=-1)[None]
        )

    k_scale = torch.tensor([config.k_prior_scale, config.m_prior_scale],
                           dtype=theta.dtype, device=theta.device)
    prior = quad(torch.stack([p0.k, p0.m], -1), torch.stack([pd.k, pd.m], -1),
                 k_scale)
    if config.num_features:
        prior = prior + quad(p0.beta, pd.beta, data.prior_scales)
    prior = prior + 0.5 * (sigma / config.sigma_prior_scale) ** 2
    if config.n_changepoints:
        delta_s = p0.delta[None] + s[..., None] * pd.delta[None]  # (K, B, C)
        prior = prior + (smooth_abs(delta_s)
                         / config.changepoint_prior_scale).sum(dim=-1)
    return nll + prior


def fan(theta: torch.Tensor, direction: torch.Tensor, ladder: torch.Tensor,
        data, config: ProphetConfig) -> torch.Tensor:
    """The ladder's losses (K, B); see ``fan_plain``."""
    global launches
    dev = theta.device
    if dev.type == "cpu":
        return fan_plain(theta, direction, ladder, data, config)
    if dev.type != "cuda":
        raise ValueError(f"fan: unsupported device {dev}")
    if config.growth != "linear":
        raise ValueError("fan: the closed-form ladder needs linear growth")
    b, t_len = data.t.shape
    k_steps = ladder.shape[0]
    ncp = config.n_changepoints
    fs = config.num_seasonal_features
    r = config.num_regressors
    p = config.num_params
    smem_bytes("fan", config, data.X_season.ndim == 3)
    _require("theta", theta, (b, p), dev)
    _require("direction", direction, (b, p), dev)
    _require("ladder", ladder, (k_steps, b), dev)
    for name in ("t", "y", "mask"):
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
    _require("prior_scales", data.prior_scales, (fs + r,), dev)
    _require("mult_mask", data.mult_mask, (fs + r,), dev)
    out = torch.empty((k_steps, b), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tsspark_fan(
            theta.data_ptr(), direction.data_ptr(), ladder.data_ptr(),
            t.data_ptr(), y.data_ptr(), mask.data_ptr(), data.s.data_ptr(),
            xs.data_ptr(), xs_bstride, xr.data_ptr(),
            data.prior_scales.data_ptr(),
            data.mult_mask.data_ptr(), out.data_ptr(),
            b, t_len, p, ncp, fs, r, k_steps, config.k_prior_scale,
            config.m_prior_scale, config.sigma_prior_scale,
            config.changepoint_prior_scale, stream,
        )
    build.check(err, "fan")
    launches += 1
    return out
