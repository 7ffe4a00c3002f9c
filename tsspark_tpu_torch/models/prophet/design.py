"""Fit-data assembly and the batched forward model.

One set of padded, batched tensors holds the whole series batch, and the
model is evaluated over it in one pass:

  * host prep (``prepare_fit_data``, ``quantile_changepoints``) is pure
    numpy in float64, bitwise equal to the JAX package's host prep;
  * the forward model (``model_yhat``) runs the hand-written kernel
    ``kernels.forward`` on a CUDA tensor and the plain PyTorch functions
    below (``trend_fn``, ``seasonal_split``) on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.models.prophet import seasonality, trend
from tsspark_tpu_torch.models.prophet.params import ProphetParams, unpack


class ScalingMeta(NamedTuple):
    """Per-series affine scalings needed to map predictions back to data units.

    Fields are HOST numpy float64: ``ds_start`` is absolute epoch days
    (~2e4), where float32's ulp is ~5 minutes, so every time map is
    computed in float64 before anything is cast to the device's float32.
    """

    y_scale: np.ndarray        # (B,)
    floor: np.ndarray          # (B,)
    ds_start: np.ndarray       # (B,) absolute days of first observation
    ds_span: np.ndarray        # (B,) observed span in days (>= 1 step)
    reg_mean: np.ndarray       # (B, R) regressor standardization mean
    reg_std: np.ndarray        # (B, R) regressor standardization std
    changepoints: np.ndarray   # (B, n_cp) changepoint locations, scaled time


class FitData(NamedTuple):
    """Everything the batched model needs, padded to (B, T).

    Leaves are host numpy arrays out of ``prepare_fit_data`` and float32
    tensors on one device out of ``predict.prepare_predict_data``.
    X_season may be (T, Fs) — a shared calendar grid — or (B, T, Fs).
    X_reg is (B, T, R) (external features are per-series).
    """

    t: torch.Tensor            # (B, T) per-series scaled time
    y: torch.Tensor            # (B, T) scaled observations (0 where masked)
    mask: torch.Tensor         # (B, T) 1.0 where observed
    s: torch.Tensor            # (B, n_cp) changepoints in scaled time
    cap: torch.Tensor          # (B, T) scaled capacity (ones unless logistic)
    X_season: torch.Tensor     # (T, Fs) or (B, T, Fs)
    X_reg: torch.Tensor        # (B, T, R)
    prior_scales: torch.Tensor  # (F,) per-feature normal prior scale
    mult_mask: torch.Tensor    # (F,) 1.0 where the feature is multiplicative


def _component(beta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """beta (B, F) times features (T, F) or (B, T, F) -> (B, T).

    A loop over F of elementwise multiply-adds, in feature order: the
    order the forward kernel adds in, and row-local, so padding rows or
    a wider batch never change a row's bits."""
    b = beta.shape[0]
    t_len = x.shape[-2]
    out = torch.zeros((b, t_len), dtype=beta.dtype, device=beta.device)
    for f in range(x.shape[-1]):
        out = out + beta[:, f : f + 1] * x[..., f]
    return out


def trend_fn(params: ProphetParams, data: FitData, config: ProphetConfig
             ) -> torch.Tensor:
    if config.growth == "linear":
        return trend.piecewise_linear(data.t, params.k, params.m,
                                      params.delta, data.s)
    if config.growth == "logistic":
        return trend.logistic(data.t, data.cap, params.k, params.m,
                              params.delta, data.s)
    return trend.flat(data.t, params.m)


def seasonal_split(theta: torch.Tensor, data: FitData, config: ProphetConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(additive_total, multiplicative_total) in scaled units, each (B, T)."""
    p = unpack(theta, config)
    fs = config.num_seasonal_features
    beta_season, beta_reg = p.beta[..., :fs], p.beta[..., fs:]
    mm_season, mm_reg = data.mult_mask[:fs], data.mult_mask[fs:]

    add = _component(beta_season * (1.0 - mm_season), data.X_season)
    add = add + _component(beta_reg * (1.0 - mm_reg), data.X_reg)
    mult = _component(beta_season * mm_season, data.X_season)
    mult = mult + _component(beta_reg * mm_reg, data.X_reg)
    return add, mult


def model_yhat(theta: torch.Tensor, data: FitData, config: ProphetConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched forward pass in scaled units.

    Returns (yhat, trend) each (B, T):
      yhat = trend * (1 + X_mult @ beta_mult) + X_add @ beta_add
    On a CUDA tensor this is one launch of the forward kernel.
    """
    from tsspark_tpu_torch.kernels import forward

    yhat, g, _, _ = forward.forward(theta, data, config)
    return yhat, g


def _warn_out_of_span(s_scaled: np.ndarray, has_obs: np.ndarray,
                      b: int) -> None:
    out = ((s_scaled <= 0.0) | (s_scaled >= 1.0)) & has_obs[:, None]
    if np.any(out):
        import warnings

        warnings.warn(
            f"{int(out.any(axis=1).sum())} of {b} series have "
            f"explicit changepoints outside their observed span "
            f"({int(out.sum())} (series, changepoint) pairs); these "
            "are inert or shift the base trend rather than kinking it",
            stacklevel=3,
        )


def prepare_fit_data(
    ds: np.ndarray,
    y: np.ndarray,
    config: ProphetConfig,
    mask: Optional[np.ndarray] = None,
    cap: Optional[np.ndarray] = None,
    floor: Optional[np.ndarray] = None,
    regressors: Optional[np.ndarray] = None,
    conditions=None,
    dtype=np.float32,
) -> Tuple[FitData, ScalingMeta]:
    """Scale, mask, and assemble a padded batch (host numpy).

    Args:
      ds: (T,) shared calendar grid or (B, T) per-series grids, absolute days.
      y:  (B, T) raw observations; NaN marks missing (merged into mask).
      mask: optional (B, T) validity; default = finite(y).
      cap: (B, T) capacities, required for logistic growth (data units).
      floor: (B,) or (B, T) logistic floor, defaults to 0.
      regressors: (B, T, R) raw external regressor values.
      conditions: dict condition_name -> (B, T) truthy values, required when
        any seasonality has a condition_name.

    Returns:
      (FitData, ScalingMeta) with host numpy leaves, bitwise equal to the
      JAX package's ``prepare_fit_data(..., as_numpy=True)``.
    """
    # All scaling statistics are computed HOST-SIDE in float64: ds carries
    # absolute epoch days (~2e4) where float32 quantizes to ~5 minutes, so
    # the (ds - ds_start) subtraction must happen before any f32 cast.
    y_np = np.asarray(y, np.float64)
    if y_np.ndim != 2:
        raise ValueError(f"y must be (B, T), got {y_np.shape}")
    b, t_len = y_np.shape
    ds_np = np.asarray(ds, np.float64)
    shared_grid = ds_np.ndim == 1
    ds_b = np.broadcast_to(ds_np, (b, t_len)) if shared_grid else ds_np

    finite = np.isfinite(y_np)
    if mask is None:
        mask_np = finite.astype(np.float64)
    else:
        mask_np = np.asarray(mask, np.float64) * finite
    y_np = np.where(mask_np > 0, np.nan_to_num(y_np), 0.0)

    # Per-series observed span -> scaled time in [0, 1].  Fully-masked rows
    # (dummy padding series) fall back to the raw grid span.
    any_obs = mask_np.sum(axis=-1) > 0
    big = np.where(mask_np > 0, ds_b, np.inf)
    small = np.where(mask_np > 0, ds_b, -np.inf)
    ds_start = np.where(any_obs, big.min(axis=-1), ds_b.min(axis=-1))
    ds_end = np.where(any_obs, small.max(axis=-1), ds_b.max(axis=-1))
    # Span floor = one grid step, so degenerate (single-observation) series
    # keep future scaled times O(1) instead of exploding.
    grid_span = ds_b.max(axis=-1) - ds_b.min(axis=-1)
    step = grid_span / max(t_len - 1, 1)
    ds_span = np.maximum(ds_end - ds_start, np.maximum(step, 1e-9))
    t = (ds_b - ds_start[:, None]) / ds_span[:, None]

    # Per-series y scaling (Prophet absmax scaling; floor only for logistic).
    if floor is None:
        floor_b = np.zeros((b,))
    else:
        floor_b = np.asarray(floor, np.float64)
        if floor_b.ndim == 2:
            floor_b = floor_b[:, 0]
    y_shift = y_np - floor_b[:, None]
    y_scale = np.maximum(np.max(np.abs(y_shift) * mask_np, axis=-1), 1e-10)
    y_s = np.where(mask_np > 0, y_shift / y_scale[:, None], 0.0)

    if config.growth == "logistic":
        if cap is None:
            raise ValueError("logistic growth requires cap")
        cap_s = (np.asarray(cap, np.float64) - floor_b[:, None]) \
            / y_scale[:, None]
    else:
        cap_s = np.ones((b, t_len))

    # Changepoints in scaled time (the observed span maps to exactly
    # [0, 1]), recorded in ScalingMeta so prediction reuses the FIT-time
    # locations.
    if config.changepoints is not None:
        cp = np.asarray(config.changepoints, np.float64)
        s_f64 = (cp[None, :] - ds_start[:, None]) / ds_span[:, None]
        _warn_out_of_span(s_f64, mask_np.any(axis=-1), b)
        s = s_f64.astype(dtype)
    elif config.changepoint_placement == "quantile":
        s = quantile_changepoints(
            t, mask_np, config.n_changepoints, config.changepoint_range
        ).astype(dtype)
    else:
        s = trend.uniform_changepoints(
            np.zeros((b,), dtype),
            np.ones((b,), dtype),
            config.n_changepoints,
            config.changepoint_range,
        )

    # Seasonal features from absolute time; shared grid -> shared matrix.
    x_season = seasonality.seasonal_feature_matrix(
        ds_np if shared_grid else ds_b, config.seasonalities
    ).astype(dtype)
    # Conditional blocks force a per-series matrix (conditions are data).
    x_season = seasonality.apply_conditions(
        x_season, config.seasonalities, conditions, b
    )

    # External regressors: per-series standardization over observed window.
    r = config.num_regressors
    if r:
        if regressors is None:
            raise ValueError(f"config declares {r} regressors but none given")
        reg = np.asarray(regressors, np.float64)
        if reg.shape != (b, t_len, r):
            raise ValueError(f"regressors shape {reg.shape} != {(b, t_len, r)}")
        n = np.maximum(mask_np.sum(-1), 1.0)[:, None]
        mean = (reg * mask_np[..., None]).sum(1) / n
        var = (((reg - mean[:, None, :]) ** 2) * mask_np[..., None]).sum(1) / n
        std = np.sqrt(np.maximum(var, 0.0))
        # Don't rescale columns the user opted out of, nor (near-)constant
        # or binary-indicator columns (Prophet's standardize='auto' rule).
        opt_out = np.asarray(
            [not rc.standardize for rc in config.regressors], bool
        )[None, :]
        skip = opt_out | np.all(
            (mask_np[..., None] == 0) | (reg == 0) | (reg == 1), axis=1
        ) | (std < 1e-8)
        std_eff = np.where(skip, 1.0, std)
        mean_eff = np.where(skip, 0.0, mean)
        x_reg = (reg - mean_eff[:, None, :]) / std_eff[:, None, :]
    else:
        x_reg = np.zeros((b, t_len, 0))
        mean_eff = np.zeros((b, 0))
        std_eff = np.ones((b, 0))

    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    data = FitData(
        t=cast(t),
        y=cast(y_s),
        mask=cast(mask_np),
        s=cast(s),
        cap=cast(cap_s),
        X_season=x_season,
        X_reg=cast(x_reg),
        prior_scales=cast(config.feature_prior_scales()),
        mult_mask=cast([1.0 if m else 0.0 for m in config.feature_modes()]),
    )
    meta = ScalingMeta(
        y_scale=y_scale,
        floor=floor_b,
        ds_start=ds_start,
        ds_span=ds_span,
        reg_mean=mean_eff,
        reg_std=std_eff,
        changepoints=np.asarray(s, np.float64),
    )
    return data, meta


def quantile_changepoints(t: np.ndarray, mask: np.ndarray,
                          n_changepoints: int, changepoint_range: float
                          ) -> np.ndarray:
    """Per-series changepoints at observed-timestamp quantiles (host numpy).

    Public Prophet's placement: the first ``changepoint_range`` fraction of
    each series' OBSERVED rows, with changepoints at evenly spaced order
    statistics of those timestamps.

    Args:
      t: (B, T) scaled times; mask: (B, T) 1.0 where observed.
    Returns:
      (B, n_changepoints) sorted changepoint locations in scaled time.
    """
    b, t_len = t.shape
    if n_changepoints == 0:
        return np.zeros((b, 0), t.dtype)
    sorted_t = np.sort(np.where(mask > 0, t, np.inf), axis=1)
    n_obs = (mask > 0).sum(axis=1)
    hist = np.floor(n_obs * changepoint_range).astype(np.int64)
    # Prophet's np.linspace(0, hist-1, n_cp+1)[1:] order statistics.
    fracs = np.arange(1, n_changepoints + 1, dtype=np.float64) / n_changepoints
    idx = np.round(np.maximum(hist - 1, 0)[:, None] * fracs[None, :]).astype(
        np.int64
    )
    q = np.take_along_axis(sorted_t, np.minimum(idx, t_len - 1), axis=1)
    # Degenerate series (fully masked, or fewer than 2 rows in the history
    # window) fall back to the uniform grid.
    uniform = trend.uniform_changepoints(
        np.zeros((b,), t.dtype), np.ones((b,), t.dtype),
        n_changepoints, changepoint_range,
    )
    bad = (hist < 2)[:, None] | ~np.isfinite(q)
    return np.where(bad, uniform, q)
