"""Long-format DataFrame front end: the user-facing fit/predict API.

The port's copy of the JAX package's ``frame`` module, with the same
names and behaviour.  A long frame (series id, ``ds`` timestamp, ``y``
value) is pivoted onto a shared calendar grid (collect), handed as
padded host arrays to a ``ForecastBackend`` (the ``cuda`` backend fits
and forecasts on the card, through the hand-written kernels), and the
results are exploded back to long format (scatter).  The front end adds
no arithmetic of its own: on the same arrays it gives the array path's
bits.

Timestamps are converted to float days since the Unix epoch; any pandas
datetime64 resolution or a plain numeric "days" column works.  The grid
stays float64 on the host (the device module's time-map policy); ``y``,
caps, floors and regressors are handed over in float32, as the JAX
package's front end hands them to its backends.

Everything runs on the card unless the backend is built for the CPU:
``Forecaster(..., device="cpu")`` passes ``device`` to the backend, and
every model the front end builds itself (the ``mcmc_samples`` route,
``predictive_samples``) takes the backend's device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from tsspark_tpu_torch import native
from tsspark_tpu_torch.backends.registry import ForecastBackend, get_backend
from tsspark_tpu_torch.config import McmcConfig, ProphetConfig, SolverConfig
from tsspark_tpu_torch.models import holidays as holidays_mod
from tsspark_tpu_torch.models.prophet.model import FitState, ProphetModel

_SECONDS_PER_DAY = 86400.0


def _ds_to_days(ds: pd.Series) -> np.ndarray:
    if np.issubdtype(ds.dtype, np.number):
        return ds.to_numpy(np.float64)
    # Resolution-agnostic (pandas >= 2 may store datetime64 in s/ms/us/ns).
    ts = pd.to_datetime(ds)
    delta = ts - pd.Timestamp("1970-01-01")
    return (delta / pd.Timedelta(days=1)).to_numpy(np.float64)


def _days_to_ts(days: np.ndarray) -> pd.Series:
    return pd.Timestamp("1970-01-01") + pd.to_timedelta(
        np.round(days * _SECONDS_PER_DAY * 1e3).astype("int64"), unit="ms"
    )


def _f32(a) -> Optional[np.ndarray]:
    """Host float32 (a view when ``a`` already is float32)."""
    return None if a is None else np.asarray(a, np.float32)


def _host(v) -> np.ndarray:
    """A backend's or a model's output as host numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class PivotedBatch(NamedTuple):
    ds: np.ndarray             # (T,) shared grid in days
    y: np.ndarray              # (B, T) with NaN holes
    series_ids: np.ndarray     # (B,)
    cap: Optional[np.ndarray]
    floor: Optional[np.ndarray]       # (B,)
    regressors: Optional[np.ndarray]  # (B, T, R)


def pivot_long(
    df: pd.DataFrame,
    id_col: str = "series_id",
    ds_col: str = "ds",
    y_col: str = "y",
    cap_col: Optional[str] = None,
    floor_col: Optional[str] = None,
    regressor_cols: Sequence[str] = (),
) -> PivotedBatch:
    """Collect: long frame -> padded (B, T) arrays on the union calendar grid.

    The scatter runs through the native threaded pivot engine
    (``native.bulk_pivot``) when the compiled library is available;
    semantics (last row wins on duplicate (series, ds)) are identical
    either way.
    """
    days = _ds_to_days(df[ds_col])
    grid, cols = np.unique(days, return_inverse=True)
    rows, ids = pd.factorize(df[id_col], sort=False)
    if (rows < 0).any():  # factorize marks null ids with -1
        raise ValueError(f"null values in id column {id_col!r}")
    ids = np.asarray(ids)
    b, t_len = len(ids), len(grid)

    def scatter(col, fill=np.nan):
        out = native.bulk_pivot(
            rows, cols, df[col].to_numpy(np.float64), b, t_len
        )
        if not np.isnan(fill):
            out = np.where(np.isnan(out), fill, out)
        return out

    y = scatter(y_col)
    cap = scatter(cap_col) if cap_col else None
    if floor_col:
        # First *observed* floor per series (a series may have no row at the
        # earliest union-grid timestamp, so column 0 is not safe).
        floor_grid = scatter(floor_col)
        first_obs = np.argmax(np.isfinite(floor_grid), axis=1)
        floor = np.nan_to_num(floor_grid[np.arange(b), first_obs])
    else:
        floor = None
    reg = None
    if regressor_cols:
        reg = np.stack([np.nan_to_num(scatter(c)) for c in regressor_cols], axis=-1)
    return PivotedBatch(
        ds=grid, y=y, series_ids=ids, cap=cap, floor=floor, regressors=reg
    )


class Forecaster:
    """High-level fit/predict over long DataFrames, backed by a plugin backend.

    Example:
      fc = Forecaster(config, backend="cuda")   # device="cpu": plain path
      fc.fit(train_df)
      out = fc.predict(horizon=28)   # long frame: series_id, ds, yhat, bounds
    """

    def __init__(
        self,
        config: ProphetConfig = ProphetConfig(),
        solver_config: SolverConfig = SolverConfig(),
        backend: str = "cuda",
        id_col: str = "series_id",
        ds_col: str = "ds",
        y_col: str = "y",
        cap_col: Optional[str] = None,
        floor_col: Optional[str] = None,
        regressor_cols: Sequence[str] = (),
        holidays: Sequence[holidays_mod.Holiday] = (),
        changepoints: Optional[Sequence] = None,
        mcmc_samples: int = 0,
        mcmc_config: Optional[McmcConfig] = None,
        auto_seasonality: bool = False,
        **backend_kwargs,
    ):
        """``mcmc_samples > 0`` switches fitting to the full-posterior HMC
        path (the upstream Prophet ``mcmc_samples`` knob): predict intervals
        then carry seasonality/regressor uncertainty from the posterior
        draws instead of the MAP trend simulation.  MCMC runs unchunked —
        intended for batches that fit on one device.

        ``backend_kwargs`` go to ``get_backend`` (``device="cpu"`` runs
        the ``cuda`` backend's plain versions on the CPU)."""
        # Explicit changepoint dates (Prophet's ``changepoints=``):
        # datetimes/strings/numbers accepted, converted to absolute days.
        # Numeric covers numpy scalars too — np.int64 is not an `int`, and
        # routing it through pd.to_datetime would read it as NANOSECONDS
        # since epoch (a silently inert changepoint at day ~0).
        if changepoints is not None:
            cps = list(changepoints)
            numeric = all(
                isinstance(c, (int, float, np.integer, np.floating))
                for c in cps
            )
            days = _ds_to_days(
                pd.Series(cps if numeric else pd.to_datetime(cps))
            )
            config = dataclasses.replace(
                config, changepoints=tuple(float(d) for d in days)
            )
        # Prophet's add_regressor implies the input column is named after
        # the regressor: when the config declares regressors and no
        # explicit column mapping is given, default to the declared names.
        if not regressor_cols and config.regressors:
            regressor_cols = tuple(r.name for r in config.regressors)
        # Holidays are sugar over the regressor path: each (holiday, offset)
        # appends an unstandardized indicator column after the user's
        # regressor columns; the indicator values are computed from the
        # calendar grid at fit/predict time (no future_df needed for them).
        self.holidays = tuple(holidays)
        if self.holidays:
            config = holidays_mod.add_holidays(config, self.holidays)
        self.config = config
        # auto_seasonality defers the seasonality choice to fit time, where
        # Prophet's span/frequency rule is applied to the observed calendar
        # (seasonality.auto_seasonalities) and the backend is rebuilt with
        # the resolved config.  Explicit `seasonalities` are then ignored.
        self.auto_seasonality = auto_seasonality
        self._backend_ctor = (backend, solver_config, dict(backend_kwargs))
        self.backend: ForecastBackend = get_backend(
            backend, config, solver_config, **backend_kwargs
        )
        self.id_col, self.ds_col, self.y_col = id_col, ds_col, y_col
        self.cap_col, self.floor_col = cap_col, floor_col
        self.regressor_cols = tuple(regressor_cols)
        self._was_datetime = False
        self.state: Optional[FitState] = None
        self.series_ids: Optional[np.ndarray] = None
        self._train_ds: Optional[np.ndarray] = None
        self._freq_days: Optional[float] = None
        # An explicit mcmc_config enables MCMC by itself; mcmc_samples is
        # shorthand for the default config.  Conflicting values would
        # silently surprise either way, so they must agree.
        if (mcmc_config is not None and mcmc_samples > 0
                and mcmc_samples != mcmc_config.num_samples):
            raise ValueError(
                f"mcmc_samples={mcmc_samples} conflicts with "
                f"mcmc_config.num_samples={mcmc_config.num_samples}; "
                "give one or make them agree"
            )
        if mcmc_config is None and mcmc_samples > 0:
            mcmc_config = McmcConfig(num_samples=mcmc_samples)
        self.mcmc_config = mcmc_config
        self.mcmc_state = None

    def _model(self) -> ProphetModel:
        """A bare model on the backend's device: the ``mcmc_samples``
        route and ``predictive_samples`` need only the model layer, and
        must run where the backend runs (a backend without a ``device``
        attribute means the card)."""
        return ProphetModel(self.config, self.backend.solver_config,
                            device=getattr(self.backend, "device", None))

    def _combined_regressors(
        self, grid: np.ndarray, reg: Optional[np.ndarray], b: int
    ) -> Optional[np.ndarray]:
        """User regressor columns ++ holiday indicator columns, (B, T, R+H)."""
        if not self.holidays:
            return reg
        # A holiday whose enumerated dates stop before the forecast grid ends
        # would silently contribute zero effect exactly where the user expects
        # it most — warn so they extend the calendar
        # (country_holidays(years=…)).  "Stops before" must respect the
        # holiday's own recurrence: warn only when at least one *expected*
        # occurrence (last date + observed recurrence spacing) falls inside
        # the grid uncovered.  This keeps e.g. Thanksgiving quiet on a fit
        # through Dec 31 while still flagging a calendar that genuinely runs
        # out mid-horizon.  Single-date holidays have no observed spacing and
        # warn as soon as the grid passes them.
        grid_end = np.max(grid)

        def _runs_out(h) -> bool:
            if not h.dates:
                return False
            dates = np.sort(np.asarray(h.dates, dtype=np.float64))
            spacing = float(np.median(np.diff(dates))) if dates.size > 1 else 0.0
            return dates[-1] + h.upper_window + spacing < grid_end

        stale = [h.name for h in self.holidays if _runs_out(h)]
        if stale:
            warnings.warn(
                f"forecast grid extends past the last enumerated date of "
                f"holiday(s) {stale}; their effect will be zero there — "
                f"extend the holiday dates to cover the horizon",
                stacklevel=3,
            )
        hol = holidays_mod.holiday_features(grid, self.holidays)  # (T, H)
        # A read-only zero-stride view: the backends read it with numpy
        # (the fit's packer finds these exact-0/1, unstandardized columns
        # as bit-packed indicators) and copy it only where they cast.
        hol_b = np.broadcast_to(hol, (b,) + hol.shape)
        return hol_b if reg is None else np.concatenate([reg, hol_b], axis=-1)

    # -- fit -------------------------------------------------------------------

    def fit(self, df: pd.DataFrame, init=None) -> "Forecaster":
        """Fit every series of the long frame; ``init`` (B, P) warm-starts
        the solver."""
        self._was_datetime = not np.issubdtype(df[self.ds_col].dtype, np.number)
        cond_names = self.config.condition_names
        batch = pivot_long(
            df, self.id_col, self.ds_col, self.y_col,
            self.cap_col, self.floor_col,
            tuple(self.regressor_cols) + cond_names,
        )
        self.series_ids = batch.series_ids
        self._train_ds = batch.ds
        diffs = np.diff(batch.ds)
        self._freq_days = float(np.median(diffs)) if len(diffs) else 1.0
        self._resolve_auto_seasonality(batch.ds)
        reg, conditions = self._split_conditions(batch.regressors, cond_names)
        reg = self._combined_regressors(
            batch.ds, reg, len(batch.series_ids)
        )
        fit_kw = dict(
            cap=None if batch.cap is None else _f32(np.nan_to_num(batch.cap)),
            floor=_f32(batch.floor),
            regressors=_f32(reg),
            conditions=conditions,
        )
        if self.mcmc_config is not None:
            # Full-posterior path: backend-independent model math (MAP init
            # + lockstep HMC chains), unchunked, on the backend's device.
            self.mcmc_state = self._model().fit_mcmc(
                batch.ds, _f32(batch.y),
                mcmc_config=self.mcmc_config, init=init, **fit_kw,
            )
            self.state = self.mcmc_state.map_state
        else:
            self.state = self.backend.fit(
                batch.ds, _f32(batch.y), init=init, **fit_kw,
            )
        return self

    def _resolve_auto_seasonality(self, ds_days) -> None:
        """Apply Prophet's auto-seasonality rule to the observed calendar
        and rebuild the backend with the resolved config (and the same
        keyword arguments, ``device`` included).  Called by fit() AND by
        eval.diagnostics.cross_validation (which fits per-cutoff models
        from the config directly) so the flag means the same model
        everywhere."""
        if not self.auto_seasonality:
            return
        from tsspark_tpu_torch.models.prophet import seasonality as seas_mod

        self.config = dataclasses.replace(
            self.config,
            seasonalities=seas_mod.auto_seasonalities(ds_days),
        )
        name, solver, kwargs = self._backend_ctor
        self.backend = get_backend(name, self.config, solver, **kwargs)

    def _split_conditions(self, reg, cond_names):
        """Separate pivoted condition columns (appended after the user's
        regressor columns) back into the conditions dict."""
        if not cond_names:
            return reg, None
        n_r = len(self.regressor_cols)
        conditions = {
            c: reg[:, :, n_r + i] for i, c in enumerate(cond_names)
        }
        reg = reg[:, :, :n_r] if n_r else None
        return reg, conditions

    # -- predict ---------------------------------------------------------------

    def mcmc_diagnostics(self) -> pd.DataFrame:
        """Per-series sampler health: worst split-R-hat, smallest bulk ESS,
        acceptance rate, divergence count (the Stan-summary convergence gate
        for the ``mcmc_samples`` path).  R-hat above ~1.05 or tiny ESS means
        the chain has not converged — lengthen warmup/samples."""
        if self.mcmc_state is None:
            raise RuntimeError(
                "no MCMC fit: construct with mcmc_samples=N (or mcmc_config) "
                "and call fit first"
            )
        ms = self.mcmc_state
        rhat = _host(ms.rhat)
        ess = _host(ms.ess)
        return pd.DataFrame({
            "series_id": list(self.series_ids),
            "rhat_max": rhat.max(axis=-1),
            "ess_min": ess.min(axis=-1),
            "ess_mean": ess.mean(axis=-1),
            "accept_rate": _host(ms.accept_rate),
            "divergences": _host(ms.divergences),
        })

    def _params(self):
        from tsspark_tpu_torch.models.prophet.params import unpack

        theta = torch.as_tensor(self.state.theta).detach().cpu()
        return unpack(theta, self.config)

    def regressor_coefficients(self) -> pd.DataFrame:
        """Fitted external-regressor effects in interpretable units (the
        Prophet ``regressor_coefficients`` utility).

        Returns one row per (series, regressor): ``coef`` is the change in
        yhat per unit change of the RAW regressor value — additive effects
        in data units (beta rescaled by y_scale and the standardization
        std), multiplicative effects as a relative fraction of the trend.
        """
        if self.state is None:
            raise RuntimeError("fit before regressor_coefficients")
        regs = self.config.regressors
        if not regs:
            raise ValueError("model has no external regressors")
        beta = _host(self._params().beta)[
            :, self.config.num_seasonal_features:]
        meta = self.state.meta
        rows = []
        for j, rc in enumerate(regs):
            raw = beta[:, j] / np.asarray(meta.reg_std)[:, j]
            coef = raw if rc.mode == "multiplicative" \
                else raw * np.asarray(meta.y_scale)
            rows.append(pd.DataFrame({
                self.id_col: list(self.series_ids),
                "regressor": rc.name,
                "mode": rc.mode,
                "coef": coef,
            }))
        return pd.concat(rows, ignore_index=True)

    def changepoints_df(self, series_id=None) -> pd.DataFrame:
        """Fit-time changepoints for one series: ds (data units), the
        fitted rate adjustment ``delta`` (scaled units, the scale
        Prophet's 0.01 significance threshold applies to), and
        ``abs_delta``.  Feeds plot.add_changepoints_to_plot."""
        if self.state is None:
            raise RuntimeError("fit before changepoints_df")
        sid = series_id if series_id is not None else self.series_ids[0]
        order = {s: i for i, s in enumerate(self.series_ids)}
        if sid not in order:
            raise ValueError(f"series {sid!r} was not fitted")
        i = order[sid]
        meta = self.state.meta
        s = np.asarray(meta.changepoints, np.float64)[i]
        days = s * np.asarray(meta.ds_span)[i] + np.asarray(meta.ds_start)[i]
        delta = _host(self._params().delta)[i]
        return pd.DataFrame({
            self.id_col: sid,
            "ds": _days_to_ts(days) if self._was_datetime else days,
            "delta": delta,
            "abs_delta": np.abs(delta),
        })

    def make_future_grid(self, horizon: int, include_history: bool = False
                         ) -> np.ndarray:
        if self._train_ds is None:
            raise RuntimeError("fit before predict")
        last = self._train_ds[-1]
        fut = last + self._freq_days * np.arange(1, horizon + 1)
        return np.concatenate([self._train_ds, fut]) if include_history else fut

    def make_future_frame(
        self, horizon: int, include_history: bool = False
    ) -> pd.DataFrame:
        """Long (series_id, ds) frame continuing the training calendar —
        Prophet's ``make_future_dataframe`` for the batched case.

        The intended edit-then-predict loop for models that need future
        covariates: add cap/regressor/condition columns to the returned
        frame, then call ``predict(future_df=...)``.
        """
        grid = self.make_future_grid(horizon, include_history)
        ds_rep = np.tile(grid, len(self.series_ids))
        return pd.DataFrame({
            self.id_col: np.repeat(list(self.series_ids), len(grid)),
            self.ds_col: _days_to_ts(ds_rep) if self._was_datetime
            else ds_rep,
        })

    def predict(
        self,
        horizon: Optional[int] = None,
        future_df: Optional[pd.DataFrame] = None,
        include_history: bool = False,
        seed: int = 0,
        num_samples: Optional[int] = None,
    ) -> pd.DataFrame:
        """Scatter: forecast back to a long frame.

        Either give ``horizon`` (regular grid continuing the training
        frequency; only valid without external regressors) or ``future_df``
        (long frame carrying ds plus cap/regressor columns per series).
        """
        if self.state is None:
            raise RuntimeError("fit before predict")
        grid, cap, reg, conditions = self._resolve_future(
            horizon, future_df, include_history
        )
        reg = self._combined_regressors(grid, reg, len(self.series_ids))
        cap_h = None if cap is None else _f32(np.nan_to_num(cap))
        if self.mcmc_state is not None:
            fc = self._model().predict_mcmc(
                self.mcmc_state, grid, cap=cap_h, regressors=_f32(reg),
                seed=seed, max_draws=num_samples, conditions=conditions,
            )
        else:
            fc = self.backend.predict(
                self.state, grid, cap=cap_h, regressors=_f32(reg),
                seed=seed, num_samples=num_samples, conditions=conditions,
            )
        return self._to_long(grid, fc)

    def _resolve_future(
        self,
        horizon: Optional[int],
        future_df: Optional[pd.DataFrame],
        include_history: bool,
    ):
        """Shared grid/cap/regressor/condition resolution for every
        forecast-shaped entry point (predict, predictive_samples)."""
        if horizon is not None and not isinstance(
            horizon, (int, np.integer)
        ):
            # A DataFrame passed positionally lands here and would
            # otherwise surface as an inscrutable pandas error downstream.
            raise TypeError(
                f"horizon must be an int, got {type(horizon).__name__}; "
                "pass a frame as future_df=..."
            )
        if future_df is not None:
            return self._align_future(future_df)
        if horizon is None:
            raise ValueError("give horizon or future_df")
        if self.regressor_cols:
            raise ValueError(
                "models with external regressors need future_df with "
                "future regressor values"
            )
        if self.config.condition_names:
            raise ValueError(
                "models with conditional seasonalities need future_df "
                "with future condition values"
            )
        if self.cap_col is not None:
            raise ValueError("logistic models need future_df with cap")
        grid = self.make_future_grid(horizon, include_history)
        return grid, None, None, None

    def predictive_samples(
        self,
        horizon: Optional[int] = None,
        future_df: Optional[pd.DataFrame] = None,
        include_history: bool = False,
        seed: int = 0,
        num_samples: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Raw posterior-predictive draws (Prophet's ``predictive_samples``).

        Returns {"series_ids": (B,), "ds": (T,) grid,
        "yhat_samples": (S, B, T) in data units}.  Runs UNCHUNKED — the
        draws tensor is the product of samples x series x grid points,
        and it comes back to the host whole; budget ``num_samples``
        accordingly for large batches.

        MAP fits simulate future-changepoint trend paths + observation
        noise (S = ``num_samples`` or ``config.uncertainty_samples``);
        MCMC fits emit one trajectory per retained posterior draw
        (``num_samples`` thins the chain), so seasonality/regressor
        uncertainty rides along too.
        """
        if self.state is None:
            raise RuntimeError("fit before predictive_samples")
        if self.mcmc_state is None:
            n_s = (
                self.config.uncertainty_samples if num_samples is None
                else num_samples
            )
            if not n_s:
                raise ValueError(
                    "predictive_samples needs uncertainty_samples > 0 "
                    "(config) or num_samples > 0"
                )
        grid, cap, reg, conditions = self._resolve_future(
            horizon, future_df, include_history
        )
        reg = self._combined_regressors(grid, reg, len(self.series_ids))
        # Backend-independent: sampling needs only the model layer and the
        # fitted state, on the backend's device.
        model = self._model()
        cap_h = None if cap is None else _f32(np.nan_to_num(cap))
        if self.mcmc_state is not None:
            # One draw trajectory per retained posterior sample — the
            # sample count is the (possibly thinned) chain length.
            fc = model.predict_mcmc(
                self.mcmc_state, grid, cap=cap_h, regressors=_f32(reg),
                seed=seed, max_draws=num_samples, conditions=conditions,
                return_samples=True,
            )
        else:
            fc = model.predict(
                self.state, grid, cap=cap_h, regressors=_f32(reg),
                seed=seed, num_samples=num_samples, conditions=conditions,
                return_samples=True,
            )
        ds_out = _days_to_ts(grid) if self._was_datetime else grid
        return {
            "series_ids": np.asarray(self.series_ids),
            "ds": np.asarray(ds_out),
            "yhat_samples": _host(fc["yhat_samples"]),
        }

    def _align_future(self, future_df: pd.DataFrame):
        """Pivot a future frame and align its series order with training."""
        cond_names = self.config.condition_names
        batch = pivot_long(
            future_df, self.id_col, self.ds_col,
            y_col=self.ds_col,  # y unused at predict; reuse ds column
            cap_col=self.cap_col, floor_col=self.floor_col,
            regressor_cols=tuple(self.regressor_cols) + cond_names,
        )
        order = {s: i for i, s in enumerate(batch.series_ids)}
        missing = [s for s in self.series_ids if s not in order]
        if missing:
            raise ValueError(
                f"future frame is missing {len(missing)} training series "
                f"(e.g. {missing[:5]}); every fitted series needs future "
                f"rows, or pass horizon= to auto-extend the calendar"
            )
        perm = np.asarray([order[s] for s in self.series_ids])
        cap = None if batch.cap is None else batch.cap[perm]
        reg = None if batch.regressors is None else batch.regressors[perm]
        reg, conditions = self._split_conditions(reg, cond_names)
        return batch.ds, cap, reg, conditions

    def components(
        self,
        horizon: Optional[int] = None,
        future_df: Optional[pd.DataFrame] = None,
        include_history: bool = True,
    ):
        """Per-block component arrays for plotting / inspection.

        Returns (ds_grid, components) where components maps each seasonality
        and regressor name to a (B, T) array in data units (multiplicative
        blocks in relative units), matching the training series order.
        """
        if self.state is None:
            raise RuntimeError("fit before components")
        if future_df is not None:
            grid, cap, reg, conditions = self._align_future(future_df)
        else:
            if self.regressor_cols or self.cap_col or \
                    self.config.condition_names:
                raise ValueError(
                    "models with regressors, caps, or conditional "
                    "seasonalities need future_df for components"
                )
            grid = self.make_future_grid(
                horizon or 0, include_history=include_history
            )
            if grid.size == 0:
                raise ValueError(
                    "components with horizon=0 and include_history=False "
                    "selects no timestamps"
                )
            cap = reg = conditions = None
        reg = self._combined_regressors(grid, reg, len(self.series_ids))
        comps = self.backend.components(
            self.state, grid,
            cap=None if cap is None else _f32(np.nan_to_num(cap)),
            regressors=_f32(reg),
            conditions=conditions,
        )
        ds_out = _days_to_ts(grid) if self._was_datetime else grid
        return ds_out, {k: _host(v) for k, v in comps.items()}

    def _to_long(self, grid: np.ndarray, fc: Dict[str, np.ndarray]
                 ) -> pd.DataFrame:
        b, t_len = len(self.series_ids), len(grid)
        ds_rep = np.tile(grid, b)
        out = {
            self.id_col: np.repeat(self.series_ids, t_len),
            self.ds_col: _days_to_ts(ds_rep) if self._was_datetime else ds_rep,
        }
        # Columns in key order, as the JAX package's frames list them.
        for k in sorted(fc):
            out[k] = _host(fc[k]).reshape(-1)
        return pd.DataFrame(out)
