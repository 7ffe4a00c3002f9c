"""Forecasting: point predictions, component decomposition, and intervals.

Uncertainty follows the public Prophet recipe, as in the JAX package:
the MAP fit is a point estimate, so predictive intervals come from
simulating future trend changepoints (same frequency as history, delta
magnitudes ~ Laplace with the MLE scale of the fitted deltas) plus
Gaussian observation noise, then taking quantiles over samples.

On a CUDA tensor ``forecast`` is two kernel launches: the forward model
(``kernels.forward``) and, when sampling, the interval kernel
(``kernels.bands``), which never stores the (S, B, T) samples;
``forecast_from_draws`` (the posterior predictive of MCMC draws) is the
posterior-draws kernel (``kernels.draws``).  On a CPU tensor each runs
its plain PyTorch version (``_simulate_trends`` below is the plain trend
simulation).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import bands as bands_kernel
from tsspark_tpu_torch.kernels import draws as draws_kernel
from tsspark_tpu_torch.kernels import forward as forward_kernel
from tsspark_tpu_torch.models.prophet import seasonality, trend
from tsspark_tpu_torch.models.prophet.design import (
    FitData,
    ScalingMeta,
    _component,
    trend_fn,
)
from tsspark_tpu_torch.models.prophet.params import unpack


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)
    ).to(device)


def prepare_predict_data(
    ds: np.ndarray,
    meta: ScalingMeta,
    config: ProphetConfig,
    device: torch.device,
    cap: Optional[np.ndarray] = None,
    regressors: Optional[np.ndarray] = None,
    conditions=None,
) -> FitData:
    """Design tensors for a (future or in-sample) time grid, on ``device``.

    Scalings are the *training* scalings from ``meta``.  Time maps are
    computed on the host in float64 (absolute epoch days vs. float32's
    ~5-minute ulp) and only then cast to float32 and shipped.
    """
    ds_np = np.asarray(ds, np.float64)
    b = meta.y_scale.shape[0]
    shared_grid = ds_np.ndim == 1
    ds_b = (np.broadcast_to(ds_np, (b,) + ds_np.shape[-1:])
            if shared_grid else ds_np)
    t_len = ds_b.shape[-1]
    ds_start = np.asarray(meta.ds_start, np.float64)
    ds_span = np.asarray(meta.ds_span, np.float64)
    t = (ds_b - ds_start[:, None]) / ds_span[:, None]

    y_scale = np.asarray(meta.y_scale, np.float64)
    floor = np.asarray(meta.floor, np.float64)
    if config.growth == "logistic":
        if cap is None:
            raise ValueError("logistic growth requires cap at predict time")
        cap_s = _to((np.asarray(cap, np.float64) - floor[:, None])
                    / y_scale[:, None], device)
    else:
        cap_s = torch.ones((b, t_len), dtype=torch.float32, device=device)

    x_season = seasonality.seasonal_feature_matrix(
        ds_np if shared_grid else ds_b, config.seasonalities
    ).astype(np.float32)
    x_season = seasonality.apply_conditions(
        x_season, config.seasonalities, conditions, b
    )

    r = config.num_regressors
    if r:
        if regressors is None:
            raise ValueError(f"config declares {r} regressors but none given")
        reg = np.asarray(regressors, np.float64)
        x_reg = (
            (reg - np.asarray(meta.reg_mean, np.float64)[:, None, :])
            / np.asarray(meta.reg_std, np.float64)[:, None, :]
        )
    else:
        x_reg = np.zeros((b, t_len, 0))

    zeros = torch.zeros((b, t_len), dtype=torch.float32, device=device)
    return FitData(
        t=_to(t, device),
        y=zeros,
        mask=zeros,
        # Fit-time changepoint locations: prediction evaluates the trend
        # on the SAME grid the parameters were fit against.
        s=_to(meta.changepoints, device),
        cap=cap_s,
        X_season=_to(x_season, device),
        X_reg=_to(x_reg, device),
        prior_scales=_to(config.feature_prior_scales(), device),
        mult_mask=_to([1.0 if m else 0.0 for m in config.feature_modes()],
                      device),
    )


def component_breakdown(theta: torch.Tensor, data: FitData,
                        meta: ScalingMeta, config: ProphetConfig
                        ) -> Dict[str, torch.Tensor]:
    """Per-block components in data units (additive) / relative units (mult)."""
    p = unpack(theta, config)
    dev = theta.device
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32,
                            device=dev)[:, None]
    floor = torch.as_tensor(meta.floor, dtype=torch.float32,
                            device=dev)[:, None]
    out: Dict[str, torch.Tensor] = {
        "trend": trend_fn(p, data, config) * scale + floor
    }
    offset = 0
    for s_cfg in config.seasonalities:
        nf = s_cfg.num_features
        blk = _component(p.beta[..., offset : offset + nf],
                         data.X_season[..., offset : offset + nf])
        out[s_cfg.name] = blk if s_cfg.mode == "multiplicative" \
            else blk * scale
        offset += nf
    for i, r_cfg in enumerate(config.regressors):
        col = p.beta[..., config.num_seasonal_features + i]
        blk = col[:, None] * data.X_reg[..., i]
        out[r_cfg.name] = blk if r_cfg.mode == "multiplicative" \
            else blk * scale
    return out


def step_cp_prob(data: FitData, config: ProphetConfig) -> torch.Tensor:
    """(B,) changepoint probability of a future grid step: the mean
    spacing of the row's future steps times n_cp, clipped to [0, 1] (the
    history's changepoint frequency)."""
    future = (data.t > 1.0).to(data.t.dtype)  # (B, T)
    dt = torch.diff(data.t, dim=-1, prepend=data.t[..., :1])
    mean_dt = (dt * future).sum(-1) / torch.clamp(future.sum(-1), min=1.0)
    return torch.clamp(config.n_changepoints * mean_dt, 0.0, 1.0)


def laplace_scale(delta: torch.Tensor, config: ProphetConfig
                  ) -> torch.Tensor:
    """(...,) Laplace scale of a simulated delta from fitted deltas
    (..., n_cp): their mean |delta| (Prophet's lambda), floored at 1e-8."""
    if config.n_changepoints:
        lam = delta.abs().mean(-1)
    else:
        lam = delta.new_zeros(delta.shape[:-1])
    return torch.clamp(lam, min=1e-8)


def sample_rates(p, data: FitData, config: ProphetConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) changepoint probability of a future grid step
    (``step_cp_prob``) and (B,) Laplace scale of its delta
    (``laplace_scale`` of the fit's deltas)."""
    return step_cp_prob(data, config), laplace_scale(p.delta, config)


def sampled_deltas(p, data: FitData, config: ProphetConfig,
                   u: torch.Tensor, lap: torch.Tensor,
                   rates=None) -> torch.Tensor:
    """(S, B, T) rate changes of the simulated future changepoints, one
    possible at every future grid step, from the (S, B, T) uniform and
    standard-Laplace draws; ``rates``: (cp_prob, lam) in place of
    ``sample_rates``'."""
    cp_prob, lam = sample_rates(p, data, config) if rates is None else rates
    future = (data.t > 1.0).to(data.t.dtype)
    ind = (u < cp_prob[None, :, None]).to(data.t.dtype) * future[None]
    return ind * (lap * lam[None, :, None])


def _simulate_trends(theta: torch.Tensor, data: FitData,
                     config: ProphetConfig, u: torch.Tensor,
                     lap: torch.Tensor,
                     det: Optional[torch.Tensor] = None,
                     rates=None) -> torch.Tensor:
    """(S, B, T) scaled trend sample paths with simulated future
    changepoints, from the given (S, B, T) uniform and standard-Laplace
    draws (the plain version of the interval kernels' simulation);
    ``rates`` as ``sampled_deltas`` takes them."""
    p = unpack(theta, config)
    num_samples = u.shape[0]
    b, t_len = data.t.shape
    new_delta = sampled_deltas(p, data, config, u, lap, rates)

    if det is None:
        det = trend_fn(p, data, config)  # (B, T) deterministic trend
    if config.growth == "linear":
        # Slope change delta_j at future grid point t_j adds
        # delta_j * (t - t_j) for t >= t_j:  t*cumsum(d) - cumsum(d*t).
        c = torch.cumsum(new_delta, dim=-1)
        d = torch.cumsum(new_delta * data.t[None], dim=-1)
        return det[None] + data.t[None] * c - d
    if config.growth == "logistic":
        return _logistic_paths(p, data, new_delta)
    return det[None].expand((num_samples, b, t_len))


def _logistic_paths(p, data: FitData, new_delta: torch.Tensor
                    ) -> torch.Tensor:
    """(S, B, T) logistic trend paths with the sampled changepoints
    ``new_delta`` (S, B, T), one at every grid step, by a scan over the
    steps: O(S B (T + n_cp)).

    The JAX package recomputes ``trend.logistic`` per sample over the
    history changepoints followed by one changepoint per step, placed at
    ``t_clamped = max(t, 1 + 1e-6)`` (in-sample steps carry delta 0; the
    clamp keeps the vector sorted).  The scan carries that recursion
    (``trend._logistic_gamma``) along the steps: each sample row holds
    the running sum of deltas (history first, then each step's draw),
    k_prev, and the running sum of gammas.  A step at or past its own
    clamped position (t >= 1 + 1e-6) sees every changepoint up to its own
    and reads the state just after it: rate k + csum, offset m + gamma
    sum.  Earlier steps see only the history changepoints they pass, as
    the deterministic trend does.  Every sum is formed in the order of
    ``_logistic_gamma`` and ``step_weighted_sum`` and the sigmoid runs on
    (B, T) blocks as there, so the paths are the same bits as that
    per-sample recompute on the CPU, where future times rise strictly
    along each row and the history changepoints lie before them (a
    forecast grid does).  The plain version of the interval kernel's
    logistic branch (``csrc/bands.cu``)."""
    t = data.t
    b, t_len = t.shape
    n_s = new_delta.shape[0]
    ncp = data.s.shape[-1]
    t_clamped = torch.clamp(t, min=1.0 + 1e-6)
    # The deterministic trend's rate and offset at every step, and the
    # recursion's state after the last history changepoint.
    rate_det = p.k[:, None] + trend.step_weighted_sum(p.delta, t, data.s)
    gamma = trend._logistic_gamma(p.k, p.m, p.delta, data.s)
    off_det = p.m[:, None] + trend.step_weighted_sum(gamma, t, data.s)
    csum = torch.zeros_like(p.k)
    gamma_sum = torch.zeros_like(p.m)
    for j in range(ncp):
        csum = csum + p.delta[:, j]
        gamma_sum = gamma_sum + gamma[:, j]
    k_prev = p.k + csum if ncp else p.k
    csum, gamma_sum, k_prev = (x.expand(n_s, b) for x in
                               (csum, gamma_sum, k_prev))
    read = t >= t_clamped
    rate = torch.empty((n_s, b, t_len), dtype=t.dtype, device=t.device)
    off = torch.empty_like(rate)
    for c in range(t_len):
        csum = csum + new_delta[:, :, c]
        k_next = p.k + csum
        gamma_c = (t_clamped[:, c] - p.m - gamma_sum) * (
            1.0 - trend._safe_div(k_prev, k_next))
        gamma_sum = gamma_sum + gamma_c
        k_prev = k_next
        rate[:, :, c] = torch.where(read[:, c], k_next, rate_det[:, c])
        off[:, :, c] = torch.where(read[:, c], p.m + gamma_sum,
                                   off_det[:, c])
    return torch.stack([data.cap * torch.sigmoid(rate[i] * (t - off[i]))
                        for i in range(n_s)])


def forecast_from_draws(
    samples: torch.Tensor,
    data: FitData,
    meta: ScalingMeta,
    config: ProphetConfig,
    seed: int = 0,
    return_samples: bool = False,
    variates=None,
) -> Dict[str, torch.Tensor]:
    """Posterior-predictive forecast from (S, B, P) MCMC draws.

    Unlike the MAP path (:func:`forecast`), every component (trend,
    seasonality, regressors, observation noise) carries posterior
    uncertainty: each draw contributes one full trajectory (with its own
    simulated future changepoints), and intervals are quantiles across
    draws.  ``yhat``, ``trend``, ``additive`` and ``multiplicative`` are
    the means over draws of each draw's deterministic values; the bands
    are quantiles of the sampled yhat and trend.  All (B, T) in data
    units, plus "yhat_samples" (S, B, T) with ``return_samples``.

    On a CUDA tensor one launch of the posterior-draws kernel
    (``kernels.draws``) a chunk of rows, which never stores the (S, B, T)
    trajectories; on a CPU tensor its plain version.  ``seed`` keys the
    variates unless ``variates`` gives them: (u, laplace, normal), each
    (S, B, T).
    """
    dev = samples.device
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=dev)
    floor = torch.as_tensor(meta.floor, dtype=torch.float32, device=dev)
    return draws_kernel.draws(
        samples.contiguous(), data, scale, floor, config, seed=seed,
        variates=variates, return_samples=return_samples,
    )


def forecast(
    theta: torch.Tensor,
    data: FitData,
    meta: ScalingMeta,
    config: ProphetConfig,
    seed: Optional[int] = None,
    num_samples: Optional[int] = None,
    return_samples: bool = False,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """Point forecast + components + predictive intervals, in data units.

    Returns "yhat", "trend", "additive", "multiplicative" and, when
    sampling (``seed`` given, or ``draws``, and a nonzero sample count),
    "yhat_lower"/"yhat_upper"/"trend_lower"/"trend_upper", all (B, T);
    ``return_samples`` adds "yhat_samples" (S, B, T).  ``draws``: given
    (u, laplace, normal) variates of shape (S, B, T) in place of the
    seeded ones.
    """
    dev = theta.device
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32, device=dev)
    floor = torch.as_tensor(meta.floor, dtype=torch.float32, device=dev)
    if draws is not None:
        n_s = int(draws[0].shape[0])
    else:
        n_s = config.uncertainty_samples if num_samples is None \
            else num_samples
    if not n_s or (seed is None and draws is None):
        yhat, g, add, mult = forward_kernel.forward(
            theta, data, config, y_scale=scale, floor=floor
        )
        return {"yhat": yhat, "trend": g, "additive": add,
                "multiplicative": mult}
    yhat_s, trend_s, add, mult = forward_kernel.forward(theta, data, config)
    sc, fl = scale[:, None], floor[:, None]
    out = {
        "yhat": yhat_s * sc + fl,
        "trend": trend_s * sc + fl,
        "additive": add * sc,
        "multiplicative": mult,
    }
    out.update(bands_kernel.bands(
        theta, data, trend_s, add, mult, scale, floor, config, n_s,
        seed=0 if seed is None else seed, draws=draws,
        return_samples=return_samples,
    ))
    return out
