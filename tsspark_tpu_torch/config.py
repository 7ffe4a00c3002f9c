"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of the JAX package's ``config`` module: the same
dataclasses, fields, order and defaults.  ``utils.checkpoint.
config_fingerprint`` hashes ``dataclasses.asdict(config)``, so any drift
here would make the port refuse every registry the JAX package
published (and the reverse).  ``NUMERICS_REV`` is the same constant for
the same reason: the registry manifest pins it.

All configs are frozen dataclasses; anything that changes tensor shapes
(changepoint count, Fourier orders, regressor count) lives here, values
(prior scales, caps) travel as data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: THE fit-numerics revision, shared by every consumer that must refuse
#: to mix parameters fitted under different numerics regimes: bench.py's
#: resumable scratch fingerprint and the serve registry's manifest guard
#: (serve/registry.py) both read this one constant, so the two can never
#: drift apart.  Bump when a model/solver/backend change alters fit
#: NUMERICS (solver args, phase policy, data handling); orchestration-
#: only changes (probing, retries, logging) must NOT bump it — resume
#: state and published registries survive them by design.
#: rev 7: the online chunk autotuner varies chunk widths mid-run, which
#: changes the chunk the adaptive phase-1 depth observes.
NUMERICS_REV = 7


@dataclasses.dataclass(frozen=True)
class SeasonalityConfig:
    """One Fourier seasonality block (e.g. yearly / weekly / daily).

    period is in days (Prophet convention); fourier_order K produces 2K
    feature columns sin(2*pi*n*t/period), cos(2*pi*n*t/period) for n=1..K.
    """

    name: str
    period: float
    fourier_order: int
    prior_scale: float = 10.0
    mode: str = "additive"  # "additive" | "multiplicative"
    # Conditional seasonality (Prophet's condition_name): the block's feature
    # columns are zeroed on rows where the named boolean condition is False,
    # so the component only acts (and is only fit) where the condition holds
    # (e.g. "on_season", "is_weekend").  Condition values are per-(series,
    # timestamp) data supplied at fit/predict time.
    condition_name: Optional[str] = None

    def __post_init__(self):
        if self.fourier_order < 1:
            raise ValueError(f"fourier_order must be >= 1, got {self.fourier_order}")
        if self.period <= 0:
            raise ValueError(f"period must be > 0, got {self.period}")
        if self.mode not in ("additive", "multiplicative"):
            raise ValueError(f"mode must be additive|multiplicative, got {self.mode}")

    @property
    def num_features(self) -> int:
        return 2 * self.fourier_order


@dataclasses.dataclass(frozen=True)
class RegressorConfig:
    """An external regressor column (includes holiday indicator columns)."""

    name: str
    prior_scale: float = 10.0
    standardize: bool = True
    mode: str = "additive"

    def __post_init__(self):
        if self.mode not in ("additive", "multiplicative"):
            raise ValueError(f"mode must be additive|multiplicative, got {self.mode}")


# Default seasonalities mirroring Prophet's auto-seasonality choices.
YEARLY = SeasonalityConfig("yearly", period=365.25, fourier_order=10)
WEEKLY = SeasonalityConfig("weekly", period=7.0, fourier_order=3)
DAILY = SeasonalityConfig("daily", period=1.0, fourier_order=4)


@dataclasses.dataclass(frozen=True)
class ProphetConfig:
    """Full model specification for a (batch of) Prophet-style fit(s).

    One config describes every series in a batch; per-series data (caps,
    changepoint locations, masks) is carried in the design matrices.
    """

    growth: str = "linear"  # "linear" | "logistic" | "flat"
    n_changepoints: int = 25
    changepoint_range: float = 0.8
    changepoint_prior_scale: float = 0.05
    # "uniform": even grid over the observed span (identical to quantiles on
    # regular grids, zero gathers).  "quantile": observed-timestamp order
    # statistics per series (Prophet's placement) — use for irregular grids.
    changepoint_placement: str = "uniform"
    # Explicit changepoint locations in absolute days (Prophet's
    # ``changepoints=`` constructor arg; Forecaster converts datetimes).
    # When set, overrides placement and n_changepoints (forced to its
    # length); locations are shared across the batch in absolute time and
    # land at per-series scaled positions via each series' own span.
    changepoints: Optional[Tuple[float, ...]] = None
    seasonalities: Tuple[SeasonalityConfig, ...] = (YEARLY, WEEKLY)
    regressors: Tuple[RegressorConfig, ...] = ()
    seasonality_mode: str = "additive"  # default mode for seasonalities
    interval_width: float = 0.8
    uncertainty_samples: int = 256
    # Prior scales for the base trend params (Prophet uses 5.0 in its Stan model).
    k_prior_scale: float = 5.0
    m_prior_scale: float = 5.0
    sigma_prior_scale: float = 0.5  # half-normal scale on observation noise

    def __post_init__(self):
        if self.changepoints is not None:
            cps = tuple(sorted(float(c) for c in self.changepoints))
            object.__setattr__(self, "changepoints", cps)
            object.__setattr__(self, "n_changepoints", len(cps))
        if self.growth not in ("linear", "logistic", "flat"):
            raise ValueError(f"growth must be linear|logistic|flat, got {self.growth}")
        if self.changepoint_placement not in ("uniform", "quantile"):
            raise ValueError(
                "changepoint_placement must be uniform|quantile, "
                f"got {self.changepoint_placement}"
            )
        if not 0.0 < self.changepoint_range <= 1.0:
            raise ValueError("changepoint_range must be in (0, 1]")
        if self.n_changepoints < 0:
            raise ValueError("n_changepoints must be >= 0")
        if self.seasonality_mode not in ("additive", "multiplicative"):
            raise ValueError("seasonality_mode must be additive|multiplicative")
        names = [s.name for s in self.seasonalities] + [r.name for r in self.regressors]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate seasonality/regressor names: {names}")

    # ---- chainable builders (Prophet's add_seasonality/add_regressor) --------

    def with_seasonality(
        self,
        name: str,
        period: float,
        fourier_order: int,
        prior_scale: float = 10.0,
        mode: Optional[str] = None,
        condition_name: Optional[str] = None,
    ) -> "ProphetConfig":
        """Config with one more seasonality — the immutable counterpart of
        Prophet's ``m.add_seasonality(...)``.  ``mode=None`` inherits
        ``seasonality_mode``.  Chainable; duplicate names raise via
        __post_init__."""
        s = SeasonalityConfig(
            name, period, fourier_order, prior_scale=prior_scale,
            mode=mode or self.seasonality_mode,
            condition_name=condition_name,
        )
        return dataclasses.replace(
            self, seasonalities=self.seasonalities + (s,)
        )

    def with_regressor(
        self,
        name: str,
        prior_scale: float = 10.0,
        standardize: bool = True,
        mode: str = "additive",
    ) -> "ProphetConfig":
        """Config with one more external regressor (Prophet's
        ``m.add_regressor(...)``).  Chainable."""
        r = RegressorConfig(
            name, prior_scale=prior_scale, standardize=standardize, mode=mode
        )
        return dataclasses.replace(self, regressors=self.regressors + (r,))

    # ---- static shape helpers -------------------------------------------------

    @property
    def condition_names(self) -> Tuple[str, ...]:
        """Unique condition names used by conditional seasonalities, in
        first-appearance order."""
        seen = []
        for s in self.seasonalities:
            if s.condition_name and s.condition_name not in seen:
                seen.append(s.condition_name)
        return tuple(seen)

    @property
    def num_seasonal_features(self) -> int:
        return sum(s.num_features for s in self.seasonalities)

    @property
    def num_regressors(self) -> int:
        return len(self.regressors)

    @property
    def num_features(self) -> int:
        """Total beta dimension: seasonal Fourier columns + regressor columns."""
        return self.num_seasonal_features + self.num_regressors

    def feature_modes(self) -> Tuple[bool, ...]:
        """Per-feature flag: True if the column is multiplicative."""
        modes = []
        for s in self.seasonalities:
            modes.extend([s.mode == "multiplicative"] * s.num_features)
        for r in self.regressors:
            modes.append(r.mode == "multiplicative")
        return tuple(modes)

    def feature_prior_scales(self) -> Tuple[float, ...]:
        scales = []
        for s in self.seasonalities:
            scales.extend([s.prior_scale] * s.num_features)
        for r in self.regressors:
            scales.append(r.prior_scale)
        return tuple(scales)

    @property
    def num_params(self) -> int:
        """Flat parameter vector length: k, m, log_sigma, delta, beta."""
        return 3 + self.n_changepoints + self.num_features


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched L-BFGS MAP solver settings."""

    max_iters: int = 200
    history: int = 10  # L-BFGS memory
    tol: float = 2e-9  # relative objective-decrease tolerance (scipy's ftol)
    # Consecutive sub-tol iterations required before ftol ends a series: a
    # single microscopic accepted step is indistinguishable from a stuck
    # line search (measured on eval config 3: every holdout-tail outlier
    # was a single-shot ftol exit at 2-3 iterations, up to 5.5 nats above
    # the oracle's optimum — see ops/lbfgs.py).
    ftol_patience: int = 2
    gtol: float = 1e-6  # gradient-inf-norm convergence tolerance
    ls_max_steps: int = 20  # line-search step-ladder size (one fan eval)
    ls_shrink: float = 0.5
    ls_armijo_c1: float = 1e-4
    ls_seed_prev: bool = True  # seed each ladder from the last accepted step
    init_step: float = 1.0
    # Float32 noise-floor detection: a series whose accepted relative
    # objective decrease stays below floor_ulps machine epsilons for
    # floor_patience consecutive iterations is stationary in this precision
    # (gtol may be unreachable for it) and is marked converged with
    # status=STATUS_FLOOR instead of burning the remaining budget.
    floor_ulps: float = 8.0
    floor_patience: int = 3
    # Warm start: "ridge" solves the batched masked normal equations in
    # closed form (models/prophet/init.py) so L-BFGS starts next to the
    # optimum; "heuristic" is Prophet's endpoint initializer.
    init: str = "ridge"
    # Initial L-BFGS metric: "gn_diag" preconditions with the inverse
    # Gauss-Newton diagonal at theta0 (models/prophet/init.curvature_diag).
    # "auto" (default) currently resolves to "gn_diag" for every growth
    # mode on full-depth solves — measured round 4 on the M5 eval config
    # (609 series vs the scipy oracle): GN-primary + rescue cuts the
    # holdout-parity tail p99 0.86 -> 0.58 sMAPE at equal wall, and on
    # logistic growth the plain metric loses ~1 nat/series at the same
    # depth (mean gap +0.52 -> -0.95 after the switch).  The one place the
    # plain metric still wins is SHORT-depth lockstep passes (GN roughly
    # halves the fraction converged by iteration 12 on the well-ridge-
    # initialized majority), which is why the two-phase bench pins its
    # phase-1 to the plain metric and phase-2 to "gn_diag" via the traced
    # solver switches rather than relying on this default.
    precond: str = "auto"

    def __post_init__(self):
        if self.init not in ("ridge", "heuristic"):
            raise ValueError(f"init must be ridge|heuristic, got {self.init}")
        if self.precond not in ("gn_diag", "none", "auto"):
            raise ValueError(
                f"precond must be gn_diag|none|auto, got {self.precond}"
            )

    def resolved_precond(self, growth: str) -> str:
        """Concrete initial-metric choice for a model's growth mode."""
        if self.precond != "auto":
            return self.precond
        del growth  # measured best for every growth mode (see above)
        return "gn_diag"


@dataclasses.dataclass(frozen=True)
class McmcConfig:
    """Batched HMC full-posterior sampling settings.

    The batched analog of upstream Prophet's ``mcmc_samples=N`` Stan/NUTS
    path: one chain per series, all chains advanced in lockstep.
    """

    num_samples: int = 300
    num_warmup: int = 300
    num_leapfrog: int = 24
    # 0.9 (vs Stan's 0.8 default): the observation-noise tail has funnel-like
    # curvature, and with thousands of lockstep chains the frozen post-warmup
    # step must leave headroom or a few chains land stuck in divergence
    # regions.  The smaller step is cheap for these low-dim posteriors.
    target_accept: float = 0.9
    init_step_size: float = 0.1
    step_jitter: float = 0.2       # multiplicative leapfrog step-size jitter
    init_jitter: float = 0.01      # N(0, .) jitter on the MAP init per chain
    divergence_threshold: float = 1000.0  # energy error treated as divergent

    def __post_init__(self):
        if self.num_samples < 1 or self.num_warmup < 2:
            raise ValueError("num_samples >= 1 and num_warmup >= 2 required")
        if not 0.0 < self.target_accept < 1.0:
            raise ValueError("target_accept must be in (0, 1)")
        if self.num_leapfrog < 1:
            raise ValueError("num_leapfrog must be >= 1")


@dataclasses.dataclass(frozen=True)
class AdviConfig:
    """Batched mean-field ADVI settings.

    The cheap member of the uncertainty ladder (MAP < ADVI < NUTS): a
    diagonal-Gaussian posterior per series, fitted by maximizing a
    reparameterized ELBO over the same padded (n_series, n_timesteps)
    design tensors the L-BFGS MAP solve runs on, all series in
    lockstep.  "Going NUTS with ADVI" (PAPERS.md) measures ADVI
    intervals at NUTS quality for this model family at a fraction of
    the cost, which is why it is the default served tier and NUTS is
    the sampled gold audit.
    """

    num_steps: int = 200
    num_elbo_samples: int = 4      # MC samples per ELBO gradient step
    learning_rate: float = 0.05    # Adam step size
    init_rho: float = -3.0         # initial log-stddev (softplus-free)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError("num_steps must be >= 1")
        if self.num_elbo_samples < 1:
            raise ValueError("num_elbo_samples must be >= 1")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate must be > 0")
        if not 0.0 <= self.adam_b1 < 1.0 or not 0.0 <= self.adam_b2 < 1.0:
            raise ValueError("adam betas must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How a fit batch is laid out over a device mesh.

    series_axis shards the embarrassingly-parallel series batch; time_axis
    optionally shards long series over devices.  Kept field-for-field with
    the JAX package's copy (the multi-device fit is a later port slice).
    """

    series_axis: str = "series"
    time_axis: Optional[str] = None
    donate_params: bool = True
