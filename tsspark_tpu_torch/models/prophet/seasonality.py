"""Fourier seasonality features (host numpy).

Seasonal features are a function of absolute time (days since a fixed
epoch), so a batch that shares one calendar grid shares one (T, F)
matrix.  Everything here runs on the host in numpy with the period fold
in float64 and is bitwise equal to the JAX package's host branch; the
result is cast to float32 before it is shipped to the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.config import (
    DAILY,
    WEEKLY,
    YEARLY,
    SeasonalityConfig,
)


def fourier_features(t_days: np.ndarray, period: float, order: int
                     ) -> np.ndarray:
    """Fourier basis for one seasonality block.

    Args:
      t_days: (..., T) time in days since a fixed epoch.
      period: period in days.
      order:  number of harmonics K.

    Returns:
      (..., T, 2K) float32 features [sin(2pi*1*t/p), cos(2pi*1*t/p), ...,
      sin(2pi*K*t/p), cos(2pi*K*t/p)].
    """
    # Fold t into [0, period) in float64 first so the trig arguments keep
    # phase precision for large absolute day counts (epoch days ~2e4
    # quantize to ~5 min in float32).
    t_mod = np.mod(np.asarray(t_days).astype(np.float64), period)
    n = np.arange(1, order + 1, dtype=t_mod.dtype)
    angles = 2.0 * np.pi * t_mod[..., None] * n / period
    feats = np.stack([np.sin(angles), np.cos(angles)], axis=-1)
    feats = feats.reshape(feats.shape[:-2] + (2 * order,))
    return feats.astype(np.float32)


def seasonal_feature_matrix(
    t_days: np.ndarray, seasonalities: Sequence[SeasonalityConfig]
) -> np.ndarray:
    """Concatenate all seasonality blocks into one (..., T, F_seasonal)."""
    t_days = np.asarray(t_days)
    if not seasonalities:
        return np.zeros(t_days.shape + (0,), np.float32)
    blocks = [
        fourier_features(t_days, s.period, s.fourier_order)
        for s in seasonalities
    ]
    return np.concatenate(blocks, axis=-1)


def apply_conditions(
    x_season: np.ndarray,
    seasonalities: Sequence[SeasonalityConfig],
    conditions,
    batch: int,
) -> np.ndarray:
    """Gate conditional seasonality blocks by their per-row conditions.

    Args:
      x_season: (T, Fs) shared or (B, T, Fs) per-series feature matrix.
      conditions: dict mapping condition_name -> (B, T) truthy array.
      batch: B (needed to broadcast a shared matrix per-series).

    Returns:
      ``x_season`` unchanged when no block is conditional, else
      (B, T, Fs) with each gated block zero where its condition is False
      (Prophet's ``add_seasonality(..., condition_name=...)``).
    """
    cond_needed = [s.condition_name for s in seasonalities if s.condition_name]
    if not cond_needed:
        return x_season
    conditions = conditions or {}
    missing = [c for c in cond_needed if c not in conditions]
    if missing:
        raise ValueError(
            f"conditional seasonalities need condition values for {missing}"
        )
    t_len = x_season.shape[-2]
    if x_season.ndim == 2:
        x_season = np.broadcast_to(
            x_season, (batch, t_len, x_season.shape[-1])
        )
    gated = []
    offset = 0
    for s in seasonalities:
        block = x_season[..., offset : offset + s.num_features]
        if s.condition_name:
            c = np.asarray(conditions[s.condition_name])
            if c.shape != (batch, t_len):
                raise ValueError(
                    f"condition {s.condition_name!r} has shape {c.shape}, "
                    f"expected {(batch, t_len)}"
                )
            block = block * (c[..., None] != 0)
        gated.append(block)
        offset += s.num_features
    return np.concatenate(gated, axis=-1)


def auto_seasonalities(ds_days, mask=None) -> Tuple[SeasonalityConfig, ...]:
    """Prophet's auto-seasonality rule from the observed calendar.

    yearly  — span >= 2 years (730 days);
    weekly  — span >= 2 weeks AND finest spacing < 7 days;
    daily   — span >= 2 days  AND finest spacing < 1 day.
    """
    ds = np.asarray(ds_days, np.float64).ravel()
    if mask is not None:
        ds = ds[np.asarray(mask).ravel() > 0]
    ds = np.unique(ds[np.isfinite(ds)])
    if ds.size < 2:
        return ()
    span = float(ds[-1] - ds[0])
    spacing = float(np.min(np.diff(ds)))
    out = []
    if span >= 730.0:
        out.append(YEARLY)
    if span >= 14.0 and spacing < 7.0:
        out.append(WEEKLY)
    if span >= 2.0 and spacing < 1.0:
        out.append(DAILY)
    return tuple(out)
