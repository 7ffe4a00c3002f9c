"""High-level batched Prophet model: fit / predict on padded arrays.

The array-level API the ``cuda`` and ``cpu`` backends sit on.  One
``fit`` call fits ALL series of the batch at once: host prep and packing
in numpy, one copy of the packed batch to the device, then the ridge
init, the curvature metric and the batched L-BFGS solve as torch ops on
the device, whose objective and line-search fan are the K3 and K4
kernels on the card.  ``predict`` and ``components`` run the K1/K2
forecast path.  ``fit_mcmc`` follows the MAP fit with one HMC chain per
series (``ops/hmc.py``, its log density K3's), ``predict_mcmc`` forecasts
from the draws through K6.  Everything runs on the card unless
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import McmcConfig, ProphetConfig, SolverConfig
from tsspark_tpu_torch.device import resolve_device
from tsspark_tpu_torch.models.prophet import predict as predict_mod
from tsspark_tpu_torch.models.prophet.design import (
    FitData,
    PackedFitData,
    ScalingMeta,
    fitdata_to_device,
    pack_fit_data,
    packable_batch,
    packed_to_device,
    prepare_fit_data,
    prepare_fit_data_blocks,
    take_fit_data,
    unpack_fit_data,
)
from tsspark_tpu_torch.models.prophet.init import (
    curvature_diag,
    initial_theta,
)
from tsspark_tpu_torch.models.prophet.loss import (
    fan_value_closed_form,
    has_closed_form_fan,
    value_and_grad_batch,
    value_batch,
)
from tsspark_tpu_torch.ops import hmc, lbfgs
from tsspark_tpu_torch.parallel.sharding import compacted_width
from tsspark_tpu_torch.utils.spans import StageClock


class FitState(NamedTuple):
    """Fitted parameters + scaling metadata + solver diagnostics.

    ``theta`` is a float32 (B, P) tensor (on the host after a fit);
    ``meta`` stays host numpy float64; the diagnostics are host numpy
    arrays.  ``status`` is the per-series termination reason
    (ops/lbfgs.STATUS_*), None on states that never ran the solver.
    """

    theta: torch.Tensor
    meta: ScalingMeta
    loss: np.ndarray
    grad_norm: np.ndarray
    converged: np.ndarray
    n_iters: np.ndarray
    status: Optional[np.ndarray] = None


def _objective(data: FitData, config: ProphetConfig):
    """The solver's three callables on one device-resident batch."""
    fun = lambda th: value_and_grad_batch(th, data, config)  # noqa: E731
    fval = lambda th: value_batch(th, data, config)  # noqa: E731
    fan = ((lambda th, d, s: fan_value_closed_form(th, d, s, data, config))
           if has_closed_form_fan(config) else None)
    return fun, fval, fan


def _sync(device: torch.device) -> None:
    """Wait for the device, so a stage clock's span holds its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_core(
    data: FitData,
    theta0: Optional[torch.Tensor],
    config: ProphetConfig,
    solver_config: SolverConfig,
    stages: Optional[StageClock] = None,
    objective=None,
) -> lbfgs.LbfgsResult:
    """The batched MAP solve on device-resident ``data``.

    ``theta0=None`` computes the warm start (closed-form ridge by default,
    init.py).  ``stages`` times "init" (warm start and metric) and
    "solve".  ``objective``: the solver's ``(fun, fval, fan)`` in place
    of ``_objective(data, config)`` (the time-sharded fit's block sums);
    the warm start and the metric are still computed over ``data``.
    """
    stages = stages if stages is not None else StageClock()
    dev = data.y.device
    with stages.span("init"):
        if theta0 is None:
            theta0 = initial_theta(data, config, solver_config)
        theta0 = torch.as_tensor(theta0).to(dev, torch.float32).contiguous()
        precond = (
            curvature_diag(data, config, theta0)
            if solver_config.resolved_precond(config.growth) == "gn_diag"
            else None
        )
        _sync(dev)
    with stages.span("solve"):
        fun, fval, fan = (_objective(data, config) if objective is None
                          else objective)
        res = lbfgs.minimize(fun, theta0, solver_config, fun_value=fval,
                             precond=precond, fan_value=fan)
        _sync(dev)
    return res


def fit_core_packed(
    packed: PackedFitData,
    theta0: Optional[torch.Tensor],
    config: ProphetConfig,
    solver_config: SolverConfig,
    reg_u8_cols: Tuple[int, ...] = (),
    stages: Optional[StageClock] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fit_core over a device-resident PackedFitData (design.py): the
    unpack runs on the device, so the expanded (B, T) tensors never cross
    the host link.  The result is packed too: (theta (B, P), stats (5, B)
    float32 rows = loss, grad_norm, converged, n_iters, status)."""
    res = fit_core(
        unpack_fit_data(packed, reg_u8_cols), theta0, config, solver_config,
        stages=stages,
    )
    f32 = res.f.dtype
    stats = torch.stack([
        res.f,
        res.grad_norm,
        res.converged.to(f32),
        res.n_iters.to(f32),
        res.status.to(f32),
    ])
    return res.theta, stats


def fit_init_core(
    data: FitData,
    theta0: Optional[torch.Tensor],
    config: ProphetConfig,
    solver_config: SolverConfig,
) -> lbfgs.LbfgsState:
    """Solver-state construction (for the segmented fit path)."""
    if theta0 is None:
        theta0 = initial_theta(data, config, solver_config)
    theta0 = torch.as_tensor(theta0).to(data.y.device,
                                        torch.float32).contiguous()
    precond = (
        curvature_diag(data, config, theta0)
        if solver_config.resolved_precond(config.growth) == "gn_diag"
        else None
    )
    fun, _, _ = _objective(data, config)
    return lbfgs.init_state(fun, theta0, solver_config, precond)


def fit_segment_core(
    data: FitData,
    state: lbfgs.LbfgsState,
    config: ProphetConfig,
    solver_config: SolverConfig,
    num_iters: int,
) -> lbfgs.LbfgsState:
    """Advance a batched solve by ``num_iters`` iterations.  Chaining these
    reproduces fit_core's trajectory exactly (the full LbfgsState
    round-trips)."""
    fun, fval, fan = _objective(data, config)
    return lbfgs.run_segment(fun, state, solver_config, num_iters,
                             fun_value=fval, fan_value=fan)


# Default keep-best margin for multi-start / rescue selection: safely above
# solve-to-solve float noise at the typical loss scale (~1e3 nats, where a
# re-solve of the same basin lands within ~1e-3), and below any rescue gain
# worth taking (real gains start ~0.1 nats).
KEEP_BEST_MARGIN = 0.05


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def select_better_state(a: "FitState", b: "FitState",
                        margin: float = 0.0) -> "FitState":
    """Per-series argmin-loss merge of two fits of the SAME data.

    Non-finite losses always lose; ties keep ``a``.  Meta is identical by
    construction (same rows, deterministic prep), so ``a``'s is carried.
    ``margin``: the challenger ``b`` must beat ``a`` by MORE than this
    many nats to win, so an equal-quality restart cannot replace the
    incumbent parameters on float noise.
    """
    la = _host(a.loss)
    lb = _host(b.loss)
    take_b = np.isfinite(lb) & (~np.isfinite(la) | (lb < la - margin))

    def pick(xa, xb):
        if xa is None or xb is None:
            return xa
        xa, xb = _host(xa), _host(xb)
        shaped = take_b.reshape(take_b.shape + (1,) * (xa.ndim - 1))
        return np.where(shaped, xb, xa)

    return FitState(
        theta=torch.from_numpy(pick(a.theta, b.theta)),
        meta=a.meta,
        loss=pick(a.loss, b.loss),
        grad_norm=pick(a.grad_norm, b.grad_norm),
        converged=pick(a.converged, b.converged),
        n_iters=pick(a.n_iters, b.n_iters),
        status=pick(a.status, b.status),
    )


def _run_segments_compacted(
    data: FitData,
    ls: lbfgs.LbfgsState,
    config: ProphetConfig,
    solver: SolverConfig,
    iter_segment: int,
    n_seg: int,
    on_segment,
    floor: int,
    multiple: int,
) -> lbfgs.LbfgsResult:
    """The convergence-compacting segment scheduler.

    The batched solver freezes converged series, but frozen rows still
    ride every objective evaluation.  Between segments this scheduler
    GATHERS the surviving (unconverged) rows into the next power-of-2
    width (``parallel.sharding.compacted_width``) and continues the solve
    at that width, so per-iteration cost tracks the live set.  Departing
    rows' results are harvested into full-width host buffers when they
    leave; the final result scatters the remaining live rows back.

    Parity: every per-series quantity in the solver and the design
    tensors is row-local (``lbfgs.take_state`` / ``design.take_fit_data``),
    pad rows are converged duplicates the active mask freezes, and frozen
    rows never change — so the compacted schedule is BITWISE identical to
    the full-width segmented solve per series.
    """
    b_full = int(data.y.shape[0])
    live = np.arange(b_full)  # original row of each current REAL row
    n_real = b_full           # rows [0:n_real) are real; the rest pads
    buf = None                # full-width host result buffers

    def harvest(res, rows_local, rows_orig):
        nonlocal buf
        res_np = {f: _host(getattr(res, f)) for f in lbfgs.LbfgsResult._fields}
        if buf is None:
            buf = {
                f: np.empty((b_full,) + a.shape[1:], a.dtype)
                for f, a in res_np.items()
            }
        for f, a in res_np.items():
            buf[f][rows_orig] = a[rows_local]

    for seg_i in range(n_seg):
        width = int(data.y.shape[0])
        ls = fit_segment_core(data, ls, config, solver, iter_segment)
        if on_segment is not None:
            on_segment()
        conv = _host(ls.converged)
        if conv.all() or seg_i == n_seg - 1:
            break
        running = np.flatnonzero(~conv[:n_real])
        new_w = compacted_width(running.size, floor=floor, multiple=multiple)
        if new_w >= width:
            continue
        res = lbfgs.to_result(ls)
        done_local = np.flatnonzero(conv[:n_real])
        harvest(res, done_local, live[done_local])
        # Pads are converged rows repeated: frozen by the active mask,
        # never scattered back.
        pad = new_w - running.size
        gather = (
            np.concatenate([running, np.resize(done_local, pad)])
            if pad else running
        )
        gidx = torch.from_numpy(gather.astype(np.int64))
        ls = lbfgs.take_state(ls, gidx)
        data = take_fit_data(data, gidx.to(data.y.device))
        live = live[gather]
        n_real = running.size

    res = lbfgs.to_result(ls)
    if buf is None:
        return res  # never compacted: device-resident result
    rows = np.arange(n_real)
    harvest(res, rows, live[:n_real])
    return lbfgs.LbfgsResult(**{k: torch.from_numpy(v)
                                for k, v in buf.items()})


def fitstate_from_packed(theta, stats, meta: ScalingMeta) -> "FitState":
    """FitState from fit_core_packed's (theta, (5, B) stats) result."""
    stats = _host(stats)
    return FitState(
        theta=theta,
        meta=meta,
        loss=stats[0],
        grad_norm=stats[1],
        converged=stats[2].astype(bool),
        n_iters=stats[3].astype(np.int32),
        status=stats[4].astype(np.int32),
    )


class HostBatch(NamedTuple):
    """A batch prepared on the host for :meth:`ProphetModel.fit`: the
    FitData and its scaling meta, and the packed payload with its
    bit-packed regressor columns (both None off the packed transit)."""

    data: object
    meta: object
    packed: object
    reg_u8_cols: Optional[Tuple[int, ...]]


class McmcState(NamedTuple):
    """Full-posterior fit: (S, B, P) draws + scaling metadata + diagnostics.

    ``samples`` is a float32 tensor on the model's device; ``map_state``
    is the MAP fit the chains were initialized from (the point-estimate
    surface for ``predict`` and ``components``); the diagnostics are host
    numpy arrays: ``accept_rate`` (B,), ``step_size`` (B,),
    ``divergences`` (B,) and per-(series, parameter) split-R-hat and bulk
    ESS (``hmc.split_rhat_ess``), the convergence gate Stan users read off
    its summary.
    """

    samples: torch.Tensor
    meta: ScalingMeta
    accept_rate: np.ndarray
    step_size: np.ndarray
    divergences: np.ndarray
    map_state: FitState
    rhat: Optional[np.ndarray] = None   # (B, P)
    ess: Optional[np.ndarray] = None    # (B, P)


def mcmc_logdensity(data: FitData, config: ProphetConfig):
    """The posterior's log density and its gradient on (B, P) parameters:
    the negative MAP loss (K3's gradient mode on the card) plus the
    log-Jacobian of the sigma = exp(log_sigma) transform (+log_sigma,
    d/dlog_sigma = 1), which sampling needs and MAP optimization omits
    (Stan's optimize vs. sample make the same distinction)."""

    def logdensity(th: torch.Tensor):
        f, g = value_and_grad_batch(th, data, config)
        lp = -f + th[:, 2]
        grad = -g
        grad[:, 2] += 1.0
        return lp, grad

    return logdensity


def mcmc_core(
    data: FitData,
    theta0: torch.Tensor,
    generator: torch.Generator,
    config: ProphetConfig,
    mcmc_config: McmcConfig,
) -> hmc.HmcResult:
    """The batched posterior sample: one HMC chain per series, from the
    MAP point ``theta0`` jittered by ``init_jitter`` * N(0, 1) draws of
    ``generator`` (on the data's device), which then drives the sampler.
    """
    theta0 = theta0.to(data.y.device, torch.float32)
    jitter = mcmc_config.init_jitter * torch.randn(
        theta0.shape, generator=generator, device=theta0.device)
    return hmc.sample(mcmc_logdensity(data, config), theta0 + jitter,
                      generator, mcmc_config)


def thin_indices(n_draws: int, max_draws: int) -> np.ndarray:
    """Indices of ``max_draws`` draws spread evenly over ``n_draws``, as
    the JAX package takes them: ``linspace(0, n_draws - 1, max_draws)``
    in float32 (i / (max_draws - 1) scaled by n_draws - 1, the last one
    exactly n_draws - 1), truncated to integers.  Float64 could round an
    index across a boundary the other way."""
    if max_draws == 1:
        return np.zeros(1, np.int64)
    div = np.float32(max_draws - 1)
    step = np.arange(max_draws - 1, dtype=np.float32) / div
    pos = np.float32(n_draws - 1) * step
    pos = np.concatenate([pos, np.float32([n_draws - 1])])
    return pos.astype(np.int64)


class ProphetModel:
    """Batched Prophet-style forecaster over fitted parameters.

    Example:
      model = ProphetModel(ProphetConfig())          # on the card
      fc = model.predict(state, future_days)          # dict of (B, H)
    """

    def __init__(self, config: ProphetConfig = ProphetConfig(),
                 solver_config: SolverConfig = SolverConfig(),
                 device=None):
        self.config = config
        self.solver_config = solver_config
        self.device = resolve_device(device)
        # Host seconds per stage.  predict: "prep" (time map, features,
        # copies to the device) and "forecast" (the model's launches; on
        # the card they return before the kernels finish).  fit: "prep",
        # "pack", "to_device", "init", "solve", "to_host", each waiting
        # for the device before it closes.
        self.stages = StageClock()

    # -- fitting ---------------------------------------------------------------

    def fit(
        self,
        ds: np.ndarray,
        y: np.ndarray,
        mask: Optional[np.ndarray] = None,
        cap: Optional[np.ndarray] = None,
        floor: Optional[np.ndarray] = None,
        regressors: Optional[np.ndarray] = None,
        init=None,
        iter_segment: Optional[int] = None,
        on_segment=None,
        conditions=None,
        reg_u8_cols: Optional[Tuple[int, ...]] = None,
        compact: bool = False,
        compact_floor: int = 32,
        compact_multiple: int = 1,
        starts: Sequence = (),
        host: Optional["HostBatch"] = None,
    ) -> FitState:
        """Fit every series in the (B, T) batch.

        ``init`` warm-starts the solver from previous parameters (B, P).
        ``starts``: further starts (each None for the ridge init, or a
        (B, P) array) solved on the same prepared and packed batch after
        ``init``'s; when given, ``fit`` returns the list of FitStates,
        ``init``'s first, each the bits a call of its own would give.

        ``iter_segment`` splits the solve into segments of at most that
        many iterations with the full solver state carried across — the
        trajectory is IDENTICAL to one long solve; ``on_segment`` (no-arg
        callable) fires after every segment (once for an unsegmented
        solve).  ``compact`` shrinks the batch to the unconverged set
        between segments (``_run_segments_compacted``; bitwise-identical
        per-series results).

        Transfer path: shared-grid batches with an exact 0/1 mask are
        packed on the host (``design.PackedFitData``: the mask folded into
        y as NaN, indicator regressors bit-packed, no ``t``), copied to the
        device once and unpacked there; segmented solves, per-series grids
        and fractional masks copy the plain FitData.  ``reg_u8_cols`` pins
        which regressor columns travel bit-packed (chunked callers decide
        once per dataset).

        ``self.stages`` times prep, pack, to_device, init, solve and
        to_host (each span waits for the device before it closes).

        ``host``: this batch already prepared by :meth:`prepare_host` (on
        any thread); the arrays above are then not read again.
        """
        if host is None:
            host = self.prepare_host(
                ds, y, mask=mask, cap=cap, floor=floor,
                regressors=regressors, iter_segment=iter_segment,
                conditions=conditions, reg_u8_cols=reg_u8_cols,
                clock=self.stages,
            )
        data, meta = host.data, host.meta
        if host.packed is not None:
            packed, u8 = host.packed, host.reg_u8_cols
            with self.stages.span("to_device"):
                packed = packed_to_device(packed, self.device)
                _sync(self.device)
            states = []
            for init_i in (init, *starts):
                with self.stages.span("to_device"):
                    theta0 = (None if init_i is None
                              else self._theta_init(init_i))
                theta, stats = fit_core_packed(
                    packed, theta0, self.config, self.solver_config,
                    reg_u8_cols=u8, stages=self.stages,
                )
                if on_segment is not None:
                    on_segment()
                with self.stages.span("to_host"):
                    states.append(fitstate_from_packed(theta.cpu(), stats,
                                                       meta))
            del packed
            return states if starts else states[0]
        states = [self._fit_prepared(
            data, meta, init_i, iter_segment, on_segment, compact=compact,
            compact_floor=compact_floor, compact_multiple=compact_multiple,
        ) for init_i in (init, *starts)]
        return states if starts else states[0]

    def prepare_host(self, ds, y, mask=None, cap=None, floor=None,
                     regressors=None, iter_segment: Optional[int] = None,
                     conditions=None,
                     reg_u8_cols: Optional[Tuple[int, ...]] = None, *,
                     clock: StageClock) -> "HostBatch":
        """The host half of :meth:`fit`: ``prepare_fit_data`` and, where
        the batch rides the packed transit, ``pack_fit_data`` (numpy only,
        so it may run on a worker thread beside another chunk's solve).
        ``clock`` times "prep" and "pack" (give a thread its own)."""
        with clock.span("prep"):
            data, meta = prepare_fit_data(
                ds, y, self.config, mask=mask, cap=cap, floor=floor,
                regressors=regressors, conditions=conditions,
            )
        packable = (
            not (iter_segment and iter_segment < self.solver_config.max_iters)
            and packable_batch(ds, data.mask)
        )
        if not packable:
            return HostBatch(data, meta, None, None)
        with clock.span("pack"):
            packed, u8 = pack_fit_data(
                data, meta, ds, reg_u8_cols=reg_u8_cols,
                collapse_cap=self.config.growth != "logistic",
            )
        return HostBatch(data, meta, packed, u8)

    def _theta_init(self, init) -> torch.Tensor:
        return torch.as_tensor(init).to(self.device, torch.float32)

    def _fit_prepared(
        self,
        data: FitData,
        meta: ScalingMeta,
        init,
        iter_segment: Optional[int] = None,
        on_segment=None,
        compact: bool = False,
        compact_floor: int = 32,
        compact_multiple: int = 1,
    ) -> FitState:
        """The plain-FitData path: one copy of the prepared batch to the
        device, then one solve or a chain of segments."""
        solver = self.solver_config
        with self.stages.span("to_device"):
            data = fitdata_to_device(data, self.device)
            theta0 = None if init is None else self._theta_init(init)
            _sync(self.device)
        if iter_segment and iter_segment < solver.max_iters:
            with self.stages.span("init"):
                ls = fit_init_core(data, theta0, self.config, solver)
                _sync(self.device)
            n_seg = -(-solver.max_iters // iter_segment)
            with self.stages.span("solve"):
                if compact:
                    res = _run_segments_compacted(
                        data, ls, self.config, solver, iter_segment, n_seg,
                        on_segment, compact_floor, compact_multiple,
                    )
                else:
                    for _ in range(n_seg):
                        ls = fit_segment_core(data, ls, self.config, solver,
                                              iter_segment)
                        if on_segment is not None:
                            on_segment()
                        if bool(ls.converged.all()):
                            break
                    res = lbfgs.to_result(ls)
                _sync(self.device)
        else:
            res = fit_core(data, theta0, self.config, solver,
                           stages=self.stages)
            if on_segment is not None:
                on_segment()
        with self.stages.span("to_host"):
            return FitState(
                theta=res.theta.detach().cpu(),
                meta=meta,
                loss=_host(res.f),
                grad_norm=_host(res.grad_norm),
                converged=_host(res.converged),
                n_iters=_host(res.n_iters),
                status=_host(res.status),
            )

    def fit_mcmc(
        self,
        ds: np.ndarray,
        y: np.ndarray,
        mask: Optional[np.ndarray] = None,
        cap: Optional[np.ndarray] = None,
        floor: Optional[np.ndarray] = None,
        regressors: Optional[np.ndarray] = None,
        mcmc_config: McmcConfig = McmcConfig(),
        seed: int = 0,
        init=None,
        conditions=None,
    ) -> McmcState:
        """Full-posterior fit: MAP solve, then one HMC chain per series.

        The batched analog of upstream Prophet's ``mcmc_samples=N`` (Stan
        NUTS): intervals from :meth:`predict_mcmc` carry seasonality and
        regressor uncertainty, which the MAP path's trend-only simulation
        cannot.  The whole batch is prepared, copied to the device once,
        fitted (no rescue pass) and sampled there; ``seed`` keys the
        chains' generator.  ``self.stages`` adds "mcmc" (the sampler, on
        the device) and "rhat" (the split-R-hat / ESS summary, on the
        host) to the fit's stages.
        """
        with self.stages.span("prep"):
            data, meta = prepare_fit_data_blocks(
                ds, y, self.config, mask=mask, cap=cap, floor=floor,
                regressors=regressors, conditions=conditions,
            )
        with self.stages.span("to_device"):
            data = fitdata_to_device(data, self.device)
        map_state = self._fit_prepared(data, meta, init)
        with self.stages.span("mcmc"):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            res = mcmc_core(data, self._theta(map_state), gen, self.config,
                            mcmc_config)
            _sync(self.device)
        del data
        with self.stages.span("rhat"):
            rhat, ess = hmc.split_rhat_ess(res.samples)
        return McmcState(
            samples=res.samples,
            meta=meta,
            accept_rate=_host(res.accept_rate),
            step_size=_host(res.step_size),
            divergences=_host(res.divergences),
            map_state=map_state,
            rhat=rhat,
            ess=ess,
        )

    def _theta(self, state: FitState) -> torch.Tensor:
        return torch.as_tensor(state.theta).to(self.device, torch.float32)

    def predict(
        self,
        state: FitState,
        ds: np.ndarray,
        cap: Optional[np.ndarray] = None,
        regressors: Optional[np.ndarray] = None,
        seed: int = 0,
        num_samples: Optional[int] = None,
        conditions=None,
        return_samples: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Forecast on an arbitrary time grid (in-sample and/or future)."""
        with self.stages.span("prep"):
            data = predict_mod.prepare_predict_data(
                ds, state.meta, self.config, self.device, cap=cap,
                regressors=regressors, conditions=conditions,
            )
            theta = self._theta(state)
        with self.stages.span("forecast"):
            return predict_mod.forecast(
                theta, data, state.meta, self.config, seed=seed,
                num_samples=num_samples, return_samples=return_samples,
            )

    def predict_mcmc(
        self,
        state: McmcState,
        ds: np.ndarray,
        cap: Optional[np.ndarray] = None,
        regressors: Optional[np.ndarray] = None,
        seed: int = 0,
        max_draws: Optional[int] = None,
        conditions=None,
        return_samples: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Posterior-predictive forecast from the MCMC draws
        (``predict.forecast_from_draws``), at most ``max_draws`` of them
        spread evenly over the chain (``thin_indices``)."""
        with self.stages.span("prep"):
            data = predict_mod.prepare_predict_data(
                ds, state.meta, self.config, self.device, cap=cap,
                regressors=regressors, conditions=conditions,
            )
            samples = torch.as_tensor(state.samples).to(self.device,
                                                        torch.float32)
            n_s = int(samples.shape[0])
            if max_draws is not None and n_s > max_draws:
                idx = torch.from_numpy(thin_indices(n_s, max_draws))
                samples = samples[idx.to(self.device)]
        with self.stages.span("forecast"):
            return predict_mod.forecast_from_draws(
                samples, data, state.meta, self.config, seed=seed,
                return_samples=return_samples,
            )

    def components(self, state: FitState, ds, cap=None, regressors=None,
                   conditions=None) -> Dict[str, torch.Tensor]:
        data = predict_mod.prepare_predict_data(
            ds, state.meta, self.config, self.device, cap=cap,
            regressors=regressors, conditions=conditions,
        )
        return predict_mod.component_breakdown(
            self._theta(state), data, state.meta, self.config
        )
