"""Fit-data assembly and the batched forward model.

One set of padded, batched tensors holds the whole series batch, and the
model is evaluated over it in one pass:

  * host prep (``prepare_fit_data``, ``quantile_changepoints``) is pure
    numpy in float64, bitwise equal to the JAX package's host prep;
  * the forward model (``model_yhat``) runs the hand-written kernel
    ``kernels.forward`` on a CUDA tensor and the plain PyTorch functions
    below (``trend_fn``, ``seasonal_split``) on a CPU tensor;
  * the fit's transfer form (``PackedFitData``): packed on the host in
    numpy (``pack_fit_data``, bitwise equal to the JAX package's), copied
    to the device (``packed_to_device``) and expanded there by torch ops
    (``unpack_fit_data``).
"""

from __future__ import annotations

import contextlib
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


class PackedFitData(NamedTuple):
    """Transfer form of a FitData batch on a shared calendar grid.

    The same information in a fraction of the bytes, bit-exactly:

      * no mask: masked cells of ``y`` travel as NaN and the device
        recovers ``mask = isfinite(y)`` and ``y = where(mask, y, 0)``,
        both exact because prep zeroes masked observations and the packer
        requires an exact 0/1 mask;
      * exact-0/1 indicator regressor columns (holidays, promos) travel
        bit-packed, 8 time steps per byte (``X_reg_bits``);
      * no ``t``: the (B, T) scaled-time grid is an affine map of the
        shared calendar, rebuilt on the device from the (T,) relative grid
        and two (B,) per-series scalars;
      * ``cap`` collapses to (B, 1) for non-logistic growth.

    Host numpy out of ``pack_fit_data``; float32 / uint8 tensors on the
    device after ``packed_to_device``.
    """

    y: torch.Tensor            # (B, T) f32 scaled observations; NaN = masked
    ds_rel: torch.Tensor       # (T,) f32 shared grid minus grid[0]
    t_off: torch.Tensor        # (B,) f32: (ds_start - grid[0]) / ds_span
    t_inv_span: torch.Tensor   # (B,) f32: 1 / ds_span
    s: torch.Tensor            # (B, n_cp) f32 changepoints (scaled time)
    cap: torch.Tensor          # (B, 1) f32, or (B, T) f32 for logistic
    X_season: torch.Tensor     # (T, Fs) or (B, T, Fs) f32
    X_reg: torch.Tensor        # (B, T, R - K) f32 non-indicator columns
    X_reg_bits: torch.Tensor   # (B, ceil(T/8), K) u8 bit-packed indicators
    prior_scales: torch.Tensor
    mult_mask: torch.Tensor


# PackedFitData fields that ALWAYS carry a leading per-series batch axis —
# the fields a row gather/concat over series must touch.  X_season is NOT
# here: it is (T, Fs) shared for plain seasonalities but (B, T, Fs) when
# conditional seasonalities make it per-series.
PACKED_PER_SERIES_FIELDS = (
    "y", "t_off", "t_inv_span", "s", "cap", "X_reg", "X_reg_bits",
)


def take_fit_data(data: FitData, idx) -> FitData:
    """Gather a row subset of a FitData batch (series axis): the design-
    tensor half of the compaction primitive (``ops.lbfgs.take_state``).

    Shared leaves — a (T, Fs) calendar seasonal matrix, the prior
    vectors — are carried as-is; everything per-series is gathered on
    axis 0.  Gathered rows are bitwise copies, so a solve continued on
    the subset reproduces each selected series' full-width trajectory.
    """
    idx = torch.as_tensor(idx, device=data.y.device)
    take = lambda a: a.index_select(0, idx)  # noqa: E731
    return FitData(
        t=take(data.t),
        y=take(data.y),
        mask=take(data.mask),
        s=take(data.s),
        cap=take(data.cap),
        X_season=(
            data.X_season if data.X_season.ndim == 2 else take(data.X_season)
        ),
        X_reg=take(data.X_reg),
        prior_scales=data.prior_scales,
        mult_mask=data.mult_mask,
    )


def _bitpack_time(a: np.ndarray) -> np.ndarray:
    """(B, T, K) exact-0/1 array -> (B, ceil(T/8), K) uint8, little-endian
    bits along the time axis (host side, numpy)."""
    b, t, k = a.shape
    tb = (t + 7) // 8
    if k == 0:
        return np.zeros((b, tb, 0), np.uint8)
    pad = tb * 8 - t
    u8 = np.asarray(a, np.uint8)
    if pad:
        u8 = np.concatenate([u8, np.zeros((b, pad, k), np.uint8)], axis=1)
    w = (1 << np.arange(8, dtype=np.uint16)).reshape(1, 1, 8, 1)
    return (
        (u8.reshape(b, tb, 8, k).astype(np.uint16) * w).sum(axis=2)
    ).astype(np.uint8)


def _bitunpack_time(p: torch.Tensor, t: int) -> torch.Tensor:
    """(B, ceil(T/8), K) uint8 -> (B, T, K) uint8 of 0/1 (device side)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=p.device)
    bits = (p[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return bits.reshape(p.shape[0], 8 * p.shape[1], p.shape[-1])[:, :t, :]


def _indicator_reg_cols(x_reg: np.ndarray) -> Tuple[int, ...]:
    """Columns of (B, T, R) whose every value is exactly 0.0 or 1.0 —
    holiday / promo style indicators that survive a uint8 round trip
    bit-for-bit (prep's auto rule never rescales binary columns)."""
    return tuple(
        j for j in range(x_reg.shape[-1])
        if bool(np.all((x_reg[..., j] == 0.0) | (x_reg[..., j] == 1.0)))
    )


def packable_batch(ds, mask) -> bool:
    """THE packed-transit eligibility predicate: a shared (T,) calendar
    grid and an exact 0/1 mask (fractional observation weights need the
    plain FitData path)."""
    if np.asarray(ds).ndim != 1:
        return False
    if mask is None:
        return True  # prepare derives an isfinite mask, exactly 0/1
    m = np.asarray(mask)
    return bool(np.all((m == 0.0) | (m == 1.0)))


def pack_fit_data(
    data: FitData,
    meta: ScalingMeta,
    ds: np.ndarray,
    reg_u8_cols: Optional[Tuple[int, ...]] = None,
    collapse_cap: bool = False,
) -> Tuple[PackedFitData, Tuple[int, ...]]:
    """Host-side (numpy) packing of a prepared batch.

    ``ds`` is the shared (T,) calendar grid in absolute days (float64: the
    ds - ds[0] subtraction happens before the f32 cast).  Requires a
    shared grid and an exact 0/1 mask (the NaN-fold transit only encodes
    observed/missing, so it would DROP fractionally-weighted observations
    instead of down-weighting them).

    ``reg_u8_cols``: which X_reg columns travel bit-packed.  None
    auto-detects exact-0/1 columns; chunked callers detect ONCE on the
    full dataset and pass the result, so every chunk packs alike.

    Returns (packed, reg_u8_cols): ``unpack_fit_data`` takes the tuple to
    reassemble X_reg in its original column order.
    """
    ds64 = np.asarray(ds, np.float64)
    if ds64.ndim != 1:
        raise ValueError("pack_fit_data requires a shared (T,) grid")
    mask_np = np.asarray(data.mask)
    if not np.all((mask_np == 0.0) | (mask_np == 1.0)):
        raise ValueError(
            "pack_fit_data requires an exact 0/1 mask; fractional "
            "observation weights need the plain FitData path"
        )
    y_np = np.asarray(data.y)
    if not np.all(np.isfinite(y_np[mask_np > 0])):
        raise ValueError(
            "pack_fit_data requires finite y wherever mask == 1: the "
            "NaN-fold transit recovers the mask as isfinite(y), so a "
            "non-finite OBSERVED cell would silently become masked on "
            "device while the plain FitData path propagates it into the "
            "loss"
        )
    f32 = np.float32
    cap = np.asarray(data.cap)
    # Collapse is a config-level decision (non-logistic growth has an
    # all-ones, unused cap), never a per-chunk data one.
    if collapse_cap and cap.shape[-1] != 1:
        cap = cap[..., :1]
    x_reg = np.asarray(data.X_reg, f32)
    u8_cols = (
        _indicator_reg_cols(x_reg) if reg_u8_cols is None
        else tuple(reg_u8_cols)
    )
    if reg_u8_cols is not None:
        bad = [
            j for j in u8_cols
            if not np.all((x_reg[..., j] == 0.0) | (x_reg[..., j] == 1.0))
        ]
        if bad:
            raise ValueError(
                f"reg_u8_cols {bad} contain non-0/1 values in this batch; "
                "the bit-packed transit would corrupt them"
            )
    f32_cols = tuple(j for j in range(x_reg.shape[-1]) if j not in u8_cols)
    # Mask folded into y as NaN: exact because prep zeroes masked cells.
    y_nan = np.where(
        mask_np > 0, np.asarray(data.y, f32), np.float32(np.nan)
    ).astype(f32)
    packed = PackedFitData(
        y=y_nan,
        ds_rel=(ds64 - ds64[0]).astype(f32),
        t_off=((meta.ds_start - ds64[0]) / meta.ds_span).astype(f32),
        t_inv_span=(1.0 / meta.ds_span).astype(f32),
        s=np.asarray(data.s, f32),
        cap=cap.astype(f32),
        X_season=np.asarray(data.X_season, f32),
        X_reg=np.ascontiguousarray(x_reg[..., f32_cols]),
        X_reg_bits=_bitpack_time(
            np.ascontiguousarray(x_reg[..., u8_cols])
        ),
        prior_scales=np.asarray(data.prior_scales, f32),
        mult_mask=np.asarray(data.mult_mask, f32),
    )
    return packed, u8_cols


def packed_to_device(packed: PackedFitData, device) -> PackedFitData:
    """Copy a host-packed batch to ``device`` (contiguous leaves, dtypes
    kept: float32, and uint8 for the indicator bits)."""
    return PackedFitData(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in packed
    ))


def fitdata_to_device(data: FitData, device) -> FitData:
    """A FitData batch (host numpy leaves, or tensors) on ``device`` as
    contiguous float32 tensors; tensors already there are kept as they
    are."""
    return FitData(*(
        a.to(device, torch.float32).contiguous()
        if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for a in data
    ))


def unpack_fit_data(packed: PackedFitData,
                    reg_u8_cols: Tuple[int, ...] = ()) -> FitData:
    """Rebuild FitData from device tensors (torch ops on the packed
    tensors' device): ``t = ds_rel * t_inv_span - t_off`` and
    ``mask = isfinite(y)``."""
    t = (
        packed.ds_rel[None, :] * packed.t_inv_span[:, None]
        - packed.t_off[:, None]
    )
    finite = torch.isfinite(packed.y)
    y = torch.where(finite, packed.y, torch.zeros_like(packed.y))
    mask = finite.to(y.dtype)
    cap = packed.cap
    if cap.shape[-1] == 1:
        cap = cap.expand(packed.y.shape).contiguous()
    r = packed.X_reg.shape[-1] + packed.X_reg_bits.shape[-1]
    f32_cols = tuple(j for j in range(r) if j not in reg_u8_cols)
    if reg_u8_cols:
        x_u8 = _bitunpack_time(packed.X_reg_bits, packed.y.shape[-1])
    cols = [None] * r
    for i, j in enumerate(f32_cols):
        cols[j] = packed.X_reg[..., i]
    for i, j in enumerate(reg_u8_cols):
        cols[j] = x_u8[..., i].to(y.dtype)
    x_reg = (
        torch.stack(cols, dim=-1) if cols
        else packed.y.new_zeros(packed.y.shape + (0,))
    )
    return FitData(
        t=t,
        y=y,
        mask=mask,
        s=packed.s,
        cap=cap,
        X_season=packed.X_season,
        X_reg=x_reg,
        prior_scales=packed.prior_scales,
        mult_mask=packed.mult_mask,
    )


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


# Chunked backends fit one batch as many prepare_fit_data calls; this flag
# (set via the context manager) silences the per-chunk out-of-span warning
# so the backend can emit ONE full-batch warning instead.
_CP_SPAN_WARNING_DISABLED = False


@contextlib.contextmanager
def changepoint_span_warning_suppressed():
    global _CP_SPAN_WARNING_DISABLED
    prev = _CP_SPAN_WARNING_DISABLED
    _CP_SPAN_WARNING_DISABLED = True
    try:
        yield
    finally:
        _CP_SPAN_WARNING_DISABLED = prev


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


def warn_out_of_span_changepoints(config, ds, y, mask) -> None:
    """Full-batch out-of-span check for chunked backends (see above):
    each observed series' raw-day span, computed directly with prep's
    first/last-observation convention, and one warning with whole-batch
    counts."""
    if config.changepoints is None or _CP_SPAN_WARNING_DISABLED:
        return
    y = np.asarray(y)
    m = (np.asarray(mask) > 0) if mask is not None else np.isfinite(y)
    b, t_len = m.shape
    has_obs = m.any(axis=-1)
    i0 = m.argmax(axis=-1)
    i1 = t_len - 1 - m[:, ::-1].argmax(axis=-1)
    dsb = np.asarray(ds, np.float64)
    if dsb.ndim == 1:
        dsb = np.broadcast_to(dsb, (b, t_len))
    rows = np.arange(b)
    start = dsb[rows, i0]
    span = np.maximum(dsb[rows, i1] - start, 1e-9)
    cp = np.asarray(config.changepoints, np.float64)
    s = (cp[None, :] - start[:, None]) / span[:, None]
    _warn_out_of_span(s, has_obs, b)


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
        if not _CP_SPAN_WARNING_DISABLED:
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


#: Rows a block of ``prepare_fit_data_blocks`` prepares on one thread,
#: and its threads.
PREP_BLOCK_ROWS = 4096
PREP_THREADS = 4
#: Per-series fields of FitData (the rest are shared by every row).
_FIT_ROW_FIELDS = ("t", "y", "mask", "s", "cap", "X_reg")


def prepare_fit_data_blocks(ds, y, config: ProphetConfig, mask=None,
                            cap=None, floor=None, regressors=None,
                            conditions=None, block: int = PREP_BLOCK_ROWS):
    """``prepare_fit_data`` of a large batch as row blocks of ``block``
    rows on ``PREP_THREADS`` threads, concatenated: the same bits, since
    every statistic it takes is a series' own and the shared-grid seasonal
    matrix is the same for every block (numpy releases the interpreter
    lock for its array work).  A batch of one block or less, per-series
    grids, conditional seasonalities and explicit changepoints (whose
    out-of-span warning is once a batch) take one call."""
    from concurrent.futures import ThreadPoolExecutor

    y = np.asarray(y)
    b = y.shape[0]
    kw = dict(mask=mask, cap=cap, floor=floor, regressors=regressors)
    if (b <= block or np.asarray(ds).ndim != 1
            or conditions is not None or config.changepoints is not None):
        return prepare_fit_data(ds, y, config, conditions=conditions, **kw)

    def rows(a, lo, hi):
        if a is None:
            return None
        a = np.asarray(a)
        return a[lo:hi] if a.ndim >= 1 and a.shape[0] == b else a

    def one(lo):
        hi = min(lo + block, b)
        return prepare_fit_data(
            ds, y[lo:hi], config,
            **{k: rows(v, lo, hi) for k, v in kw.items()})

    with ThreadPoolExecutor(min(PREP_THREADS, -(-b // block)),
                            thread_name_prefix="prep-block") as pool:
        parts = list(pool.map(one, range(0, b, block)))
    data0, _meta0 = parts[0]
    data = data0._replace(**{
        f: np.concatenate([getattr(d, f) for d, _ in parts])
        for f in _FIT_ROW_FIELDS})
    meta = type(_meta0)(*[np.concatenate([getattr(m, f) for _, m in parts])
                          for f in _meta0._fields])
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
