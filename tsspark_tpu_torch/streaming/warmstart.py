"""Warm-start parameter transfer between refits (torch, on the device).

A refit on extended data changes every per-series scaling (y_scale grows
with new extremes, ds_span grows with new timestamps, changepoint grids
move), so yesterday's fitted theta lives in a DIFFERENT parameter space
than today's solver.  This module maps old parameters into the new space
analytically, as the JAX package's ``streaming/warmstart.py`` does:

  time map:   t_old = a * t_new + b  with a = span_new/span_old,
              b = (start_new - start_old)/span_old
  scale map:  r = y_scale_old / y_scale_new

  k', delta'  — the piecewise slope curve is resampled: slope_new(s'_j) =
                a*r*slope_old(t_old(s'_j)), delta' = successive differences.
  m'          — r * g_old(b)   (trend value at new t=0, rescaled)
  beta'       — r * beta for additive features; unchanged for multiplicative
                (those are relative to trend and unitless).
  log_sigma'  — log_sigma + log r.

Exact for the trend between changepoints and for all linear components;
the only approximation is quantizing old changepoints onto the new grid.
The affine maps ``a``, ``b`` and ``r`` are taken in float64 on the host
from the float64 metas and cast to float32 only afterwards; the rest is
float32 torch on the device, in the reference's order of operations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.models.prophet.params import (
    ProphetParams,
    pack,
    unpack,
)


def transfer_theta(
    theta_old: torch.Tensor,
    meta_old: ScalingMeta,
    meta_new: ScalingMeta,
    config: ProphetConfig,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Map (B, P) fitted params from meta_old's space into meta_new's space,
    on ``device`` (default: ``theta_old``'s)."""
    dev = theta_old.device if device is None else torch.device(device)
    dtype = torch.float32
    p = unpack(theta_old.to(dev, dtype), config)
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    # Host float64: ds_start is absolute epoch days (~2e4), and
    # start_new - start_old cancels catastrophically in float32 at
    # sub-daily cadence.  The O(1) differences and ratios are cast after.
    # Rows the store does not know arrive zero-filled (ParamStore.lookup):
    # their spans and scales are 0, so they get identity maps instead of
    # 0/0 (the caller discards them through the lookup's found-mask).
    span_old = f64(meta_old.ds_span)
    scale_new = f64(meta_new.y_scale)
    known = (span_old > 0) & (f64(meta_old.y_scale) > 0)
    span_old = np.where(known, span_old, 1.0)
    col = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x)).to(dev, dtype)[:, None]
    a = col(np.where(known, f64(meta_new.ds_span), 1.0) / span_old)
    b = col(np.where(known, f64(meta_new.ds_start) - f64(meta_old.ds_start),
                     0.0) / span_old)
    r = col(np.where(known, f64(meta_old.y_scale), 1.0)
            / np.where(scale_new > 0, scale_new, 1.0))

    batch = theta_old.shape[0]
    s_old = torch.from_numpy(f64(meta_old.changepoints)).to(dev, dtype)
    s_new = torch.from_numpy(f64(meta_new.changepoints)).to(dev, dtype)

    # Old cumulative slope at the new window's origin and at each new
    # changepoint, mapped to old time (a sliding window folds the old
    # changepoints in (0, b) into the new base slope).
    eval_pts = torch.cat([b, a * s_new + b], dim=-1)  # (B, n_cp + 1)
    if s_old.shape[-1]:
        idx = torch.searchsorted(s_old.contiguous(), eval_pts.contiguous(),
                                 right=True)
    else:
        idx = torch.zeros(eval_pts.shape, dtype=torch.int64, device=dev)
    zeros = torch.zeros((batch, 1), dtype=dtype, device=dev)
    csum = torch.cat([zeros, torch.cumsum(p.delta, dim=-1)], dim=-1)
    slope_old_at = p.k[:, None] + torch.take_along_dim(csum, idx, dim=-1)
    # Linear rates are in y-scaled units and pick up r; the logistic rate
    # sits inside sigmoid(k (t - m)), invariant to y rescaling.
    rate_scale = a if config.growth == "logistic" else a * r
    slope_new_at = rate_scale * slope_old_at

    k_new = slope_new_at[:, 0]
    delta_new = torch.diff(slope_new_at, dim=-1)

    if config.growth == "logistic":
        # m is the sigmoid midpoint in scaled time: t_old = a t_new + b.
        m_new = (p.m - b[:, 0]) / a[:, 0]
    else:
        gsum = torch.cat([zeros, torch.cumsum(-s_old * p.delta, dim=-1)],
                         dim=-1)
        off_old_at0 = p.m + torch.take_along_dim(gsum, idx[:, :1],
                                                 dim=-1)[:, 0]
        g_old_at0 = slope_old_at[:, 0] * b[:, 0] + off_old_at0
        shift = col((f64(meta_old.floor) - f64(meta_new.floor))
                    / scale_new)[:, 0]
        m_new = r[:, 0] * g_old_at0 + shift

    mult_mask = torch.tensor(
        [1.0 if m else 0.0 for m in config.feature_modes()], dtype=dtype,
        device=dev)
    beta_new = p.beta * torch.where(mult_mask > 0, 1.0, r)
    log_sigma_new = p.log_sigma + torch.log(torch.clamp(r[:, 0], min=1e-30))

    return pack(ProphetParams(k=k_new, m=m_new, log_sigma=log_sigma_new,
                              delta=delta_new, beta=beta_new))
