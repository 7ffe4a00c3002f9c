"""CUDA backend: the batched fit and forecasts, chunked over series to
bound device memory.

The counterpart of the JAX package's ``TpuBackend``:

* ``fit``: batches larger than one chunk (8,192 series by default) are
  fitted chunk by chunk, every chunk padded to a power of two (32-row
  floor) with inert all-masked series; ragged-length batches may be
  split into length buckets; then a rescue pass refits the series that
  exited the solver stuck (status FLOOR or STALLED) from two starts with
  the GN-diagonal metric and keeps each series' best loss.
* ``fit_twophase``: the speed-first fit -- a shallow plain-metric phase
  over every series, then a full-depth GN-diagonal phase over the
  compacted unconverged tail, warm from phase 1 (no rescue pass).  The
  reference's traced phase controls become a ``dataclasses.replace``d
  ``SolverConfig`` and the presence of ``init`` (``phase1_dynamic_args``
  / ``phase2_dynamic_args``).
* ``resilient=True``: ``fit`` of an eligible batch (a shared 1-D ``ds``
  grid, an exact 0/1 mask or none, no ``init``, no ``conditions``) runs
  through ``orchestrate.fit_resilient``: process-isolated fit workers on
  this backend's device, chunk files fenced by leases and stamped with a
  CRC, a worker's crash costing a respawn and a resume, not the run.  It
  serves ``fit_twophase`` semantics: no rescue pass and no length
  buckets, whatever ``rescue`` / ``length_buckets`` say (announced once
  with a ``ResilienceWarning`` and noted on each returned state's
  ``resilience`` report).  ``resilient_opts`` go to ``fit_resilient``
  (``scratch_dir``, ``phase1_iters``, ``retry_policy``, ...); an
  ineligible batch falls back to the in-process fit with one warning
  naming the failed checks.
* ``mesh=`` (a ``parallel.mesh.Mesh``): every chunk's solve runs
  through the sharded fit (``parallel.sharding.fit_sharded_packed`` on a
  packable batch, else ``fit_sharded``): series-axis data parallelism
  and, per ``shard_config``, time-axis sequence parallelism.  The warm
  start is computed inside the sharded fit, over each series shard's
  rows.  Contract: on a series-only mesh each shard runs the one-device
  program over its rows, so a row's result is the meshless fit's when
  the shard width gives the row the same bits (on the CPU, measured:
  bitwise); a time-sharded fit adds each block's partial sums in another
  float32 order and is held to the meshless fit at tolerance (losses at
  rtol 2e-3, atol 2e-3, the reference's own ``tests/test_sharding.py``
  bound).  ``iter_segment`` with a mesh raises, and ``resilient=True``
  counts a mesh as ineligible.
* ``predict`` / ``components``: a batch larger than one chunk streams
  through the model in fixed-size chunks (the last padded by repeating a
  real row, whose outputs are discarded), each chunk seeded with its own
  ``SeedSequence((seed, chunk))`` draw.

A meshless batch of more than one chunk prepares its chunks on up to
``PREP_WORKERS`` host threads (``prepare_fit_data`` and ``pack_fit_data``
are numpy, which releases the interpreter lock for its array work) while
the card solves the chunk before: the same functions on the same rows, so
the same bits as preparing each chunk just before its solve.

Results come back on the host: numpy arrays, and the fitted ``theta`` as
a CPU tensor.  ``stages`` is the model's stage clock: the fit's prep,
pack, to_device, init, solve, to_host and (this backend's) rescue; the
forecast's prep, forecast and to_host; ``fit_twophase`` adds ``phase1``
and ``phase2`` around its two phases' fits (which count their own stages
into the same clock).  Under the threaded prep, ``prep`` and ``pack`` sum
the worker threads' seconds and ``prep_wait`` is the time the solve loop
waited for a prepared chunk.

``perf=PerfRecorder()`` times every chunk dispatch of every fit this
backend runs (the rescue pass's and both two-phase phases' included)
and attaches the recorder's cumulative report to each returned state
(``perf.get_perf``), as the JAX package's backend does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from tsspark_tpu_torch.backends.registry import (
    ForecastBackend,
    register_backend,
)
from tsspark_tpu_torch.models.prophet.design import (
    _indicator_reg_cols,
    changepoint_span_warning_suppressed,
    packable_batch,
    warn_out_of_span_changepoints,
)
from tsspark_tpu_torch.models.prophet.model import (
    KEEP_BEST_MARGIN,
    FitState,
    ProphetModel,
    select_better_state,
)
from tsspark_tpu_torch.ops import lbfgs
from tsspark_tpu_torch.parallel.sharding import next_pow2
from tsspark_tpu_torch.resilience.report import (
    ResilienceWarning,
    add_warning,
)

# One-time flag for the resilient gate's semantic-switch warning: every
# eligible fit after the first stays quiet (the note still rides each
# returned state's resilience report).
_RESILIENT_GATE_WARNED = False

# One-time flag for the opposite edge of the same gate: resilient=True
# was requested but the batch is INELIGIBLE for the worker path, so the
# fit loses process isolation and crash resume.  Announced once, naming
# the failed eligibility check(s).
_RESILIENT_FALLBACK_WARNED = False

#: Host threads preparing a multi-chunk fit's chunks ahead of their solves
#: (0, the tests' reference: each chunk on the calling thread just before
#: its solve).
PREP_WORKERS = 4


def _resilient_ineligibility(init, conditions, packable, mesh=None):
    """Human-readable list of the eligibility checks a resilient=True fit
    failed (empty = eligible for the worker path)."""
    failed = []
    if init is not None:
        failed.append("an explicit warm start (init=) was passed")
    if conditions is not None:
        failed.append("conditional-seasonality data (conditions=) was "
                      "passed")
    if mesh is not None:
        failed.append("the backend is mesh-sharded (mesh=)")
    if not packable:
        failed.append("the batch is not packable (needs a shared 1-D ds "
                      "grid and an exact 0/1 mask)")
    return failed


def _mesh_series_axis(mesh, shard_config=None) -> str:
    """The mesh axis that shards the series dimension: the config's
    declared name when given; else "series" wherever it appears, with
    only "time" named the first non-"time" axis, otherwise the first
    axis."""
    if shard_config is not None:
        return shard_config.series_axis
    names = mesh.axis_names
    if "series" in names:
        return "series"
    if "time" in names and len(names) > 1:
        return next(n for n in names if n != "time")
    return names[0]


def _slice_repeat_pad(a, lo: int, hi: int, c: int):
    """Batch-axis slice [lo:hi], padded to exactly ``c`` rows by repeating
    the first row (valid dummy data whose outputs are discarded).  There is
    no mask on the predict path to make zero rows inert."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a[lo:hi]
        if hi - lo < c:
            a = torch.cat([a, a[:1].expand((c - (hi - lo),) + a.shape[1:])])
        return a
    a = np.asarray(a)[lo:hi]
    if hi - lo < c:
        a = np.concatenate([a, np.repeat(a[:1], c - (hi - lo), axis=0)])
    return a


def _slice_state(state: FitState, lo: int, hi: int, c: int) -> FitState:
    sl = lambda a: _slice_repeat_pad(a, lo, hi, c)  # noqa: E731
    return FitState(
        theta=sl(state.theta),
        meta=type(state.meta)(*(sl(a) for a in state.meta)),
        loss=sl(state.loss),
        grad_norm=sl(state.grad_norm),
        converged=sl(state.converged),
        n_iters=sl(state.n_iters),
        status=sl(state.status),
    )


def _pad_batch(arr, b_pad):
    """Zero-padding along the batch axis: numpy on the host, and a tensor
    on its own device (a warm start on the card stays there)."""
    if arr is None:
        return None
    if isinstance(arr, torch.Tensor):
        if arr.shape[0] == b_pad:
            return arr
        return torch.cat([arr, arr.new_zeros(
            (b_pad - arr.shape[0],) + tuple(arr.shape[1:]))])
    arr = np.asarray(arr)
    if arr.shape[0] == b_pad:
        return arr
    pad = [(0, b_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _rows(a, idx):
    """Rows ``idx`` (an index array or a slice) of a tensor or array."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[idx if isinstance(idx, slice) else torch.as_tensor(idx)]
    return np.asarray(a)[idx]


def _take_rows(state: FitState, idx) -> FitState:
    """A FitState's rows ``idx`` (theta, diagnostics and meta alike)."""
    return FitState(
        theta=_rows(state.theta, idx),
        meta=type(state.meta)(*(_rows(a, idx) for a in state.meta)),
        loss=_rows(state.loss, idx),
        grad_norm=_rows(state.grad_norm, idx),
        converged=_rows(state.converged, idx),
        n_iters=_rows(state.n_iters, idx),
        status=_rows(state.status, idx),
    )


def _concat_states(states) -> FitState:
    """Concatenate chunk results along the series axis (theta as a
    tensor, the host float64 meta and diagnostics as numpy)."""
    def cat(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, dim=0)
        return np.concatenate([np.asarray(x) for x in xs], axis=0)

    meta = type(states[0].meta)(*(
        cat([st.meta[i] for st in states])
        for i in range(len(states[0].meta))
    ))
    return FitState(
        theta=cat([st.theta for st in states]),
        meta=meta,
        **{f: cat([getattr(st, f) for st in states])
           for f in ("loss", "grad_norm", "converged", "n_iters", "status")},
    )


def patch_state(state: FitState, idx: np.ndarray, sub: FitState) -> FitState:
    """Scatter a compacted follow-up fit back into the full-batch FitState.

    ``sub`` holds results for ``state``'s rows ``idx`` (same data, deeper
    solve).  Iteration counts accumulate across phases; scaling meta is
    recomputed deterministically from the same rows, so either copy works.
    """

    def scatter(full, part, accumulate=False):
        if full is None or part is None:
            return full
        is_tensor = isinstance(full, torch.Tensor)
        out = (full.detach().cpu().numpy() if is_tensor
               else np.asarray(full)).copy()
        part = (part.detach().cpu().numpy() if isinstance(part, torch.Tensor)
                else np.asarray(part))
        out[idx] = (out[idx] + part) if accumulate else part
        return torch.from_numpy(out) if is_tensor else out

    return FitState(
        theta=scatter(state.theta, sub.theta),
        meta=state.meta,
        loss=scatter(state.loss, sub.loss),
        grad_norm=scatter(state.grad_norm, sub.grad_norm),
        converged=scatter(state.converged, sub.converged),
        n_iters=scatter(state.n_iters, sub.n_iters, accumulate=True),
        status=scatter(state.status, sub.status),
    )


@register_backend
class CudaBackend(ForecastBackend):
    name = "cuda"

    # Memory bound for one chunk: a chunk's (S, B_chunk, T) sample count
    # stays under ~1 GB of float32, the JAX backend's budget (the
    # interval kernel stores no samples, but the plain version and
    # return_samples do).
    _PREDICT_ELEMS = 1 << 28

    def __init__(self, *args, chunk_size: int = 8192, device=None,
                 iter_segment: Optional[int] = None, on_segment=None,
                 length_buckets: Optional[int] = None, rescue: bool = True,
                 compact: bool = True, resilient: bool = False,
                 resilient_opts: Optional[dict] = None, perf=None,
                 mesh=None, shard_config=None, **kwargs):
        """``chunk_size`` bounds series per model call; ``device=None``
        is the card (and raises without one).

        ``iter_segment`` splits each chunk's solve into segments of at
        most that many iterations (the trajectory is identical);
        ``on_segment`` fires after each.  ``compact`` shrinks a segmented
        solve to its unconverged rows between segments (bitwise-identical
        per-series results).

        ``length_buckets``: ragged-length batches on a shared grid are
        split into up to this many buckets by observed window, each fitted
        on its own (128-aligned) slice of the time axis.  None = auto (up
        to 3 buckets, only when that saves >= 20% of the padded cells);
        1 disables.

        ``rescue``: a series can exit the lockstep solver STUCK (status
        FLOOR or STALLED) rather than solved.  When enabled, ``fit``
        follows the main solve with a GN-diagonal multi-start refit of
        those series (warm from their stuck point AND fresh from the ridge
        init) and keeps each series' best loss, original included, by
        more than ``KEEP_BEST_MARGIN`` — so the pass can only improve.

        ``resilient`` routes eligible ``fit`` calls through
        ``orchestrate.fit_resilient`` with ``resilient_opts`` (see the
        module docstring).

        ``perf`` (``perf.PerfRecorder``): per-dispatch telemetry over
        every chunk this backend fits; the cumulative report rides each
        returned FitState as ``state.perf``.  A timed dispatch waits for
        the device, so leave it None where latency matters.

        ``mesh`` (``parallel.mesh.Mesh``) routes every chunk's solve
        through the sharded fit (see the module docstring);
        ``shard_config`` (``ShardingConfig``) names its axes, by default
        taken from the mesh (series first, an axis named "time" or the
        other one for time).  Incompatible with ``iter_segment``.
        """
        if mesh is not None and iter_segment:
            raise ValueError(
                "CudaBackend(mesh=...) does not support iter_segment: the "
                "sharded solve runs as one solve per series shard"
            )
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.shard_config = shard_config
        self.perf = perf
        self.resilient = resilient
        self.resilient_opts = dict(resilient_opts or {})
        self.chunk_size = chunk_size
        self.iter_segment = iter_segment
        self.on_segment = on_segment
        self.length_buckets = length_buckets
        self.rescue = rescue
        self.compact = compact
        self._model = ProphetModel(self.config, self.solver_config,
                                   device=device)
        self.device = self._model.device
        self.stages = self._model.stages
        self.twophase: Optional[dict] = None

    def _sub_backend(self, solver_config=None, share_stages=False,
                     **kw) -> "CudaBackend":
        """A backend of the same settings; ``share_stages`` makes its fits
        count into this one's stage clock (the length buckets are the
        main fit; the rescue pass keeps its own clock and is timed whole
        as "rescue")."""
        opts = dict(
            chunk_size=self.chunk_size, device=self.device,
            iter_segment=self.iter_segment, on_segment=self.on_segment,
            length_buckets=self.length_buckets, rescue=self.rescue,
            compact=self.compact, perf=self.perf, mesh=self.mesh,
            shard_config=self.shard_config,
        )
        opts.update(kw)
        sub = CudaBackend(self.config, solver_config or self.solver_config,
                          **opts)
        if share_stages:
            sub._model.stages = sub.stages = self.stages
        return sub

    def _compact_multiple(self) -> int:
        """Series-axis shard count a compacted width must divide into (1
        off-mesh), the ``multiple`` of ``parallel.sharding.
        compacted_width``; the same axis ``_fit_sharded_chunk`` splits."""
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[_mesh_series_axis(
            self.mesh, self.shard_config
        )])

    def _segmented(self) -> bool:
        return bool(self.iter_segment
                    and self.iter_segment < self.solver_config.max_iters)

    def _plan_length_buckets(self, y, mask):
        """Bucket series by observed time window.

        Returns a list of (row_idx, lo_t, hi_t) covering every row exactly
        once, or None when bucketing is off / not worth it.  Buckets come
        from the sorted window-span order, their windows are aligned up
        to 128 columns, near-equal buckets are merged, and the plan is
        kept only if it saves >= 20% of the (B, T) cells the unbucketed
        fit would pay for.
        """
        if self.length_buckets == 1:
            return None
        b, t_len = y.shape
        if b < 32 or t_len < 256:
            return None  # too small for the extra shapes to pay
        m = (np.asarray(mask) > 0) if mask is not None else np.isfinite(y)
        any_obs = m.any(axis=1)
        first = np.where(any_obs, m.argmax(axis=1), 0)
        last = np.where(
            any_obs, t_len - 1 - m[:, ::-1].argmax(axis=1), -1
        )
        span = last - first + 1  # 0 for all-masked rows
        k = self.length_buckets or 3
        order = np.argsort(span, kind="stable")
        cuts = [round(i * b / k) for i in range(k + 1)]
        plan = []
        for i in range(k):
            idx = order[cuts[i]:cuts[i + 1]]
            if idx.size == 0:
                continue
            sel = idx[any_obs[idx]]
            lo = int(first[sel].min()) if sel.size else 0
            hi = int(last[sel].max()) + 1 if sel.size else 1
            # Align the window length up to 128 columns, extending toward
            # lo (keeps hi, the "now" edge, stable).
            length = min(t_len, -(-(hi - lo) // 128) * 128)
            lo = max(0, hi - length)
            hi = min(t_len, lo + length)
            if plan:
                prev_idx, prev_lo, prev_hi = plan[-1]
                union_lo = min(prev_lo, lo)
                union_hi = max(prev_hi, hi)
                # Merge only when the UNION window is barely bigger than
                # the SMALLER member.
                if union_hi - union_lo <= 1.15 * min(hi - lo,
                                                     prev_hi - prev_lo):
                    plan.pop()
                    idx = np.concatenate([prev_idx, idx])
                    lo, hi = union_lo, union_hi
            plan.append((idx, lo, hi))
        if len(plan) < 2:
            return None
        cost = sum(idx.size * (hi - lo) for idx, lo, hi in plan)
        if cost > 0.8 * b * t_len:
            return None
        return plan

    def fit(self, ds, y, mask=None, cap=None, floor=None, regressors=None,
            init=None, conditions=None, reg_u8_cols=None) -> FitState:
        """Fit a (B, T) batch of series; returns a FitState on the host."""
        if self.resilient:
            if (init is None and conditions is None and self.mesh is None
                    and packable_batch(ds, mask)):
                return self._attach_perf(self._fit_resilient(
                    ds, y, mask, cap, floor, regressors))
            # The gate declined this batch: the fit proceeds in-process,
            # WITHOUT process isolation or crash resume — announce once
            # which eligibility check failed.
            global _RESILIENT_FALLBACK_WARNED
            if not _RESILIENT_FALLBACK_WARNED:
                _RESILIENT_FALLBACK_WARNED = True
                failed = _resilient_ineligibility(
                    init, conditions, packable_batch(ds, mask), self.mesh)
                warnings.warn(
                    "CudaBackend(resilient=True): this fit is INELIGIBLE "
                    "for the process-isolated worker path and falls back "
                    "to the in-process fit (no crash isolation/resume). "
                    "Failed eligibility check(s): " + "; ".join(failed),
                    ResilienceWarning, stacklevel=2,
                )
        segmented = self._segmented()
        # Indicator-column split decided ONCE for the main fit and the
        # rescue pass (an O(B*T*R) host scan; unused when segmented).
        if (reg_u8_cols is None and regressors is not None
                and not segmented and np.asarray(ds).ndim == 1):
            reg_u8_cols = _indicator_reg_cols(np.asarray(regressors))
        # One full-batch out-of-span changepoint warning, not one per chunk.
        warn_out_of_span_changepoints(self.config, ds, y, mask)
        with changepoint_span_warning_suppressed():
            state = self._fit_main(
                ds, y, mask=mask, cap=cap, floor=floor,
                regressors=regressors, init=init, conditions=conditions,
                reg_u8_cols=reg_u8_cols,
            )
        # No rescue under segmented solves (bounded dispatches are the
        # caller's priority there).
        if not self.rescue or segmented:
            return self._attach_perf(state)
        with changepoint_span_warning_suppressed(), \
                self.stages.span("rescue"):
            return self._attach_perf(self._rescue_pass(
                state, ds, y, mask, cap, floor, regressors, conditions,
                reg_u8_cols,
            ))

    def _attach_perf(self, state):
        """Ride the recorder's cumulative report on the returned state
        (no-op without a recorder)."""
        if self.perf is None:
            return state
        from tsspark_tpu_torch.perf import attach_perf

        return attach_perf(state, self.perf.report())

    def _fit_resilient(self, ds, y, mask, cap, floor, regressors):
        """The process-isolated route (``orchestrate.fit_resilient``) on
        this backend's device and chunk width.  It serves fit_twophase
        semantics: no rescue pass, no length buckets.  With rescue on
        (the default) or length buckets set, two calls differing only in
        eligibility would return different-quality stuck tails with no
        signal, so the switch is announced once and noted on the state."""
        from tsspark_tpu_torch import orchestrate

        note = None
        if self.rescue or self.length_buckets not in (None, 1):
            note = (
                "CudaBackend(resilient=True): this fit is served by the "
                "two-phase worker path, which ignores "
                f"rescue={self.rescue!r} and length_buckets="
                f"{self.length_buckets!r}; ineligible batches (fractional "
                "mask, 2-D ds, conditions, init) fall back to the "
                "in-process fit WITH those features"
            )
            global _RESILIENT_GATE_WARNED
            if not _RESILIENT_GATE_WARNED:
                _RESILIENT_GATE_WARNED = True
                warnings.warn(note, ResilienceWarning, stacklevel=3)
        opts = dict(chunk=self.chunk_size, device=self.device.type)
        if self.iter_segment:
            opts["segment"] = self.iter_segment
        opts.update(self.resilient_opts)
        state = orchestrate.fit_resilient(
            self.config, self.solver_config, ds, y, mask=mask,
            regressors=regressors, cap=cap, floor=floor, **opts,
        )
        return add_warning(state, note) if note else state

    def _rescue_pass(self, state, ds, y, mask, cap, floor, regressors,
                     conditions, u8):
        """GN-diagonal multi-start refit of the stuck tail (see __init__)."""
        if state.status is None:
            return state
        idx = np.flatnonzero(np.isin(
            np.asarray(state.status),
            (lbfgs.STATUS_FLOOR, lbfgs.STATUS_STALLED),
        ))
        if idx.size == 0:
            return state
        bkr = self._sub_backend(
            dataclasses.replace(self.solver_config, precond="gn_diag"),
            length_buckets=1, rescue=False,
        )
        y = np.asarray(y)
        r = lambda a: None if a is None else np.asarray(a)[idx]  # noqa: E731
        ds2 = ds if np.asarray(ds).ndim == 1 else np.asarray(ds)[idx]
        kw = dict(
            mask=r(mask if mask is not None
                   else np.isfinite(y).astype(np.float32)),
            cap=r(cap), floor=r(floor), regressors=r(regressors),
            conditions=None if conditions is None else {
                k: r(v) for k, v in conditions.items()
            },
            reg_u8_cols=u8,
        )
        # Both starts on one prep and pack of the stuck rows: the warm
        # start from their stuck point, then the ridge init.
        warm, fresh = bkr._fit_main(ds2, y[idx], init=_rows(state.theta, idx),
                                    starts=(None,), **kw)
        # Keep-best with a margin, incumbents first: a restart that merely
        # ties on loss must not basin-hop the parameters.
        redo = select_better_state(warm, fresh, margin=KEEP_BEST_MARGIN)
        orig = _take_rows(state, idx)
        best = select_better_state(orig, redo, margin=KEEP_BEST_MARGIN)
        # n_iters reports work SPENT on the series (both starts ran).
        best = best._replace(
            n_iters=np.asarray(warm.n_iters) + np.asarray(fresh.n_iters))
        return patch_state(state, idx, best)

    def _fit_main(self, ds, y, mask=None, cap=None, floor=None,
                  regressors=None, init=None, conditions=None,
                  reg_u8_cols=None, starts=()):
        """The chunked fit.  ``starts``: further starts solved on each
        chunk's one prep after ``init``'s (``ProphetModel.fit``); with
        them the result is one FitState a start, and no length buckets."""
        # Host numpy end to end until each chunk's copy to the device.
        y = np.asarray(y)
        ds = np.asarray(ds)
        b = y.shape[0]
        # Pad chunks to a power of two with a 32-row floor: every batch of
        # at most 32 series shares one shape, and inert rows cost little.
        c = min(self.chunk_size, max(32, next_pow2(b)))
        u8 = reg_u8_cols
        if (u8 is None and regressors is not None and not self._segmented()
                and ds.ndim == 1):
            u8 = _indicator_reg_cols(np.asarray(regressors))
        # Ragged-length bucketing (shared-grid batches only).  Masked cells
        # are exact zeros in every reduction, so this changes results only
        # at float32 reduction-order level.
        if ds.ndim == 1 and not starts:
            plan = self._plan_length_buckets(y, mask)
            if plan is not None:
                sub = self._sub_backend(share_stages=True, length_buckets=1,
                                        rescue=False)
                states = []
                for idx, lo_t, hi_t in plan:
                    r2 = lambda a: None if a is None \
                        else np.asarray(a)[idx][:, lo_t:hi_t]  # noqa: E731
                    r1 = lambda a: _rows(a, idx)  # noqa: E731
                    rflex = lambda a: None if a is None else (  # noqa: E731
                        r2(a) if np.asarray(a).ndim >= 2 else r1(a)
                    )
                    states.append(sub.fit(
                        ds[lo_t:hi_t], r2(y), mask=r2(mask), cap=r2(cap),
                        floor=rflex(floor), regressors=r2(regressors),
                        init=r1(init),
                        conditions=None if conditions is None else {
                            k2: r2(v) for k2, v in conditions.items()
                        },
                        reg_u8_cols=u8,
                    ))
                inv = np.argsort(np.concatenate([p[0] for p in plan]))
                return _take_rows(_concat_states(states), inv)
        if b <= c:
            return self._fit_padded(
                ds, y, mask, cap, floor, regressors, init, conditions, c,
                u8, starts,
            )
        def chunk(lo, hi):
            sl = lambda a: _rows(a, slice(lo, hi))  # noqa: E731
            slc = lambda d: None if d is None else {  # noqa: E731
                k: np.asarray(v)[lo:hi] for k, v in d.items()
            }
            return (ds if ds.ndim == 1 else ds[lo:hi], y[lo:hi], sl(mask),
                    sl(cap), sl(floor), sl(regressors), sl(init),
                    slc(conditions), c, u8, tuple(sl(st) for st in starts))

        bounds = [(lo, min(lo + c, b)) for lo in range(0, b, c)]
        if self.mesh is not None or PREP_WORKERS < 1:
            states = [self._fit_padded(*chunk(lo, hi)) for lo, hi in bounds]
        else:
            states = self._fit_prefetched([chunk(lo, hi)
                                           for lo, hi in bounds])
        if starts:
            return [_concat_states(list(per)) for per in zip(*states)]
        return _concat_states(states)

    def _fit_prefetched(self, chunks) -> list:
        """Fit ``chunks`` (``_fit_padded``'s arguments) in order, each
        prepared on a worker thread (``_prep_padded``) while the chunks
        before it solve; at most ``PREP_WORKERS`` preparations in flight."""
        workers = min(PREP_WORKERS, len(chunks))
        todo = iter(chunks)
        pending: deque = deque()
        states = []
        with ThreadPoolExecutor(workers, thread_name_prefix="fit-prep") \
                as pool:
            def submit():
                args = next(todo, None)
                if args is not None:
                    pending.append(pool.submit(self._prep_padded, *args))

            for _ in range(workers):
                submit()
            for args in chunks:
                with self.stages.span("prep_wait"):
                    host, clock = pending.popleft().result()
                submit()
                total = self.stages
                for k, v in clock.seconds.items():
                    total.seconds[k] = total.seconds.get(k, 0.0) + v
                    total.calls[k] = total.calls.get(k, 0) + clock.calls[k]
                states.append(self._fit_padded(*args, host=host))
        return states

    def _prep_padded(self, ds, y, mask, cap, floor, regressors, init,
                     conditions, c, reg_u8_cols=None, starts=()):
        """The host half of ``_fit_padded`` (numpy only): the padding and
        ``ProphetModel.prepare_host``, timed on a clock of its own.
        Returns (the prepared batch, the clock)."""
        from tsspark_tpu_torch.utils.spans import StageClock

        ds, y, mask, cap, floor, regressors, _, conditions, _ = self._pad(
            ds, y, mask, cap, floor, regressors, None, conditions, c, ())
        clock = StageClock()
        host = self._model.prepare_host(
            ds, y, mask=mask, cap=cap, floor=floor, regressors=regressors,
            iter_segment=self.iter_segment, conditions=conditions,
            reg_u8_cols=reg_u8_cols, clock=clock,
        )
        return host, clock

    def _fit_padded(self, ds, y, mask, cap, floor, regressors, init,
                    conditions, c, reg_u8_cols=None, starts=(), host=None):
        """One chunk padded to ``c`` rows through the model (``host``: the
        padded chunk already prepared, ``_prep_padded``)."""
        b = y.shape[0]
        ds, y, mask, cap, floor, regressors, init, conditions, starts = \
            self._pad(ds, y, mask, cap, floor, regressors, init,
                      conditions, c, starts)
        # model.fit returns on the host, so the timed dispatch covers the
        # device work.
        timed = (self.perf.dispatch(c, live=b, kind="chunk")
                 if self.perf is not None else contextlib.nullcontext())
        if self.mesh is not None:
            with timed:
                out = [self._fit_sharded_chunk(
                    ds, y, mask, cap, floor, regressors, init_i, conditions,
                    reg_u8_cols) for init_i in (init, *starts)]
        else:
            with timed:
                out = self._model.fit(
                    ds, y, mask=mask, cap=cap, floor=floor,
                    regressors=regressors, init=init,
                    iter_segment=self.iter_segment,
                    on_segment=self.on_segment, conditions=conditions,
                    reg_u8_cols=reg_u8_cols, compact=self.compact,
                    starts=starts, host=host,
                )
            out = out if starts else [out]
        out = [_take_rows(st, slice(0, b)) for st in out]
        return out if starts else out[0]

    @staticmethod
    def _pad(ds, y, mask, cap, floor, regressors, init, conditions, c,
             starts):
        """A chunk of ``b < c`` rows padded to ``c`` with inert series."""
        b = y.shape[0]
        if b < c:
            if ds.ndim == 2:
                # Dummy rows reuse the first series' grid (inert: mask == 0).
                ds = np.concatenate(
                    [ds, np.broadcast_to(ds[:1], (c - b,) + ds.shape[1:])]
                )
            # Dummy series: all-masked, y=0.  Their loss is priors-only and
            # converges at once; results are sliced away below.
            y = _pad_batch(y, c)
            mask = _pad_batch(
                mask if mask is not None else np.isfinite(y), c
            ).astype(y.dtype).copy()
            mask[b:] = 0.0
            cap = _pad_batch(cap, c) if cap is not None else None
            if cap is not None:
                cap = cap.copy()
                cap[b:] = 1.0  # keep logistic cap positive
            floor = _pad_batch(floor, c) if floor is not None else None
            regressors = (_pad_batch(regressors, c)
                          if regressors is not None else None)
            init = _pad_batch(init, c)
            starts = tuple(_pad_batch(st, c) for st in starts)
            if conditions is not None:
                conditions = {
                    k: _pad_batch(v, c) for k, v in conditions.items()
                }
        return ds, y, mask, cap, floor, regressors, init, conditions, starts

    def _fit_sharded_chunk(self, ds, y, mask, cap, floor, regressors,
                           init, conditions, reg_u8_cols=None) -> FitState:
        """One padded chunk through the sharded fit.  Shared-grid batches
        with an exact 0/1 mask ride the packed transit
        (``fit_sharded_packed``), the rest the plain feed
        (``fit_sharded``); ``init`` is the warm start, else the ridge init
        runs inside each series shard's solve."""
        from tsspark_tpu_torch.config import ShardingConfig
        from tsspark_tpu_torch.models.prophet.design import (
            pack_fit_data,
            prepare_fit_data,
        )
        from tsspark_tpu_torch.parallel import sharding as sharding_mod

        with self.stages.span("prep"):
            data, meta = prepare_fit_data(
                ds, y, self.config, mask=mask, cap=cap, floor=floor,
                regressors=regressors, conditions=conditions,
            )
        if self.shard_config is not None:
            shard_cfg = self.shard_config
        else:
            series_ax = _mesh_series_axis(self.mesh)
            rest = [n for n in self.mesh.axis_names if n != series_ax]
            time_ax = "time" if "time" in rest else (rest[0] if rest
                                                     else None)
            shard_cfg = ShardingConfig(series_axis=series_ax,
                                       time_axis=time_ax)
        with self.stages.span("solve"):
            if packable_batch(ds, data.mask):
                packed, u8 = pack_fit_data(
                    data, meta, ds, reg_u8_cols=reg_u8_cols,
                    collapse_cap=self.config.growth != "logistic",
                )
                res = sharding_mod.fit_sharded_packed(
                    packed, u8, init, self.config, self.solver_config,
                    self.mesh, shard_cfg,
                )
            else:
                res = sharding_mod.fit_sharded(
                    data, init, self.config, self.solver_config,
                    self.mesh, shard_cfg,
                )
        if self.on_segment is not None:
            self.on_segment()
        return FitState(
            theta=res.theta, meta=meta, loss=res.f.numpy(),
            grad_norm=res.grad_norm.numpy(),
            converged=res.converged.numpy().astype(bool),
            n_iters=res.n_iters.numpy().astype(np.int32),
            status=res.status.numpy().astype(np.int32),
        )

    def fit_twophase(self, ds, y, mask=None, cap=None, floor=None,
                     regressors=None, init=None, conditions=None,
                     phase1_iters: int = 12) -> FitState:
        """Straggler-compacted fit: short lockstep phase, then finish only
        the unconverged tail.

        The batched solver advances every series in lockstep, so one slow
        series makes the whole chunk pay full depth.  Phase 1 fits
        everything with a ``phase1_iters`` cap and the plain metric;
        phase 2 gathers the unconverged series (hardest first,
        ``difficulty_order``) into a compacted batch padded with inert
        all-masked rows to a multiple of ``min(chunk_size,
        next_pow2(B))``, and continues only those, warm-started from
        their phase-1 parameters with the GN-diagonal metric, at the
        full ``max_iters`` depth.  Both phases run through this backend's
        own ``fit`` settings (chunking, length buckets) without the
        rescue pass; segmented solves take the derived phase backends
        (``_phase1``, ``_straggler_backend``: no length buckets).
        ``self.twophase`` holds the last call's counts (``rows``,
        ``phase1_converged``, ``stragglers``, ``phase2_rows`` padded) and
        ``order``, the stragglers' rows in phase 2's order.
        """
        segmented = self._segmented()
        # Indicator-column pinning: phase 2 refits a SUBSET of rows, where
        # a continuous column could look binary and flip the u8 split --
        # decide once on the full batch and thread it through both phases
        # (skipped where the packed path is unreachable: segmented solves).
        u8 = (
            _indicator_reg_cols(np.asarray(regressors))
            if (regressors is not None and not segmented
                and np.asarray(ds).ndim == 1) else None
        )
        with self.stages.span("phase1"):
            if segmented:
                phase1_state = self._phase1(phase1_iters).fit(
                    ds, y, mask=mask, cap=cap, floor=floor,
                    regressors=regressors, init=init, conditions=conditions,
                )
            else:
                p1 = phase1_dynamic_args(phase1_iters, init is not None,
                                         self.solver_config)
                phase1_state = self._phase_backend(p1["solver_config"]).fit(
                    ds, y, mask=mask, cap=cap, floor=floor,
                    regressors=regressors,
                    init=init if p1["use_init"] else None,
                    conditions=conditions, reg_u8_cols=u8,
                )
        state = phase1_state
        b = np.asarray(y).shape[0]
        # Stragglers = unconverged only (the speed-first entry point; the
        # stuck exits FLOOR / STALLED are plain ``fit``'s rescue pass's).
        idx = np.flatnonzero(~np.asarray(state.converged))
        self.twophase = {"rows": int(b),
                         "phase1_converged": int(b - idx.size),
                         "stragglers": int(idx.size), "phase2_rows": 0}
        if idx.size == 0:
            return self._attach_perf(state)
        idx = idx[difficulty_order(np.asarray(state.grad_norm)[idx])]
        c = min(self.chunk_size, next_pow2(b))
        pad = (-idx.size) % c
        self.twophase.update(phase2_rows=int(idx.size + pad), order=idx)

        def sub(a, fill=0.0):
            if a is None:
                return None
            a = _rows(a, idx)
            if isinstance(a, torch.Tensor):
                a = a.numpy()
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]
            ) if pad else a

        if segmented:
            fit2 = self._straggler_backend().fit
        else:
            p2 = phase2_dynamic_args(self.solver_config)
            fit2 = self._phase_backend(p2["solver_config"]).fit
        kwargs = dict(
            mask=sub(mask if mask is not None
                     else np.isfinite(np.asarray(y)).astype(np.float32)),
            cap=sub(cap, fill=1.0), floor=sub(floor),
            regressors=sub(regressors),
            init=sub(state.theta),
            conditions=None if conditions is None else {
                k: sub(v) for k, v in conditions.items()
            },
            reg_u8_cols=u8,
        )
        ds2 = ds if np.asarray(ds).ndim == 1 else sub(np.asarray(ds))
        # Phase 1 already emitted the one full-batch out-of-span
        # changepoint warning.
        with changepoint_span_warning_suppressed(), \
                self.stages.span("phase2"):
            state2 = fit2(ds2, sub(y), **kwargs)
        if pad:
            state2 = _take_rows(state2, slice(0, idx.size))
        return self._attach_perf(patch_state(state, idx, state2))

    def _phase_backend(self, solver_config) -> "CudaBackend":
        """This backend under a phase's solver config, its fits counted
        into this one's stage clock; no rescue pass (the two-phase flow
        owns the tail), its length-bucket setting kept."""
        return self._sub_backend(solver_config, share_stages=True,
                                 rescue=False)

    def _derived(self, **solver_overrides) -> "CudaBackend":
        """Same backend with SolverConfig fields replaced: an internal
        phase worker of a segmented solve (no length buckets, no rescue
        pass of its own)."""
        return self._sub_backend(
            dataclasses.replace(self.solver_config, **solver_overrides),
            share_stages=True, length_buckets=1, rescue=False,
        )

    def _phase1(self, phase1_iters: int) -> "CudaBackend":
        # The plain metric at phase 1's short depth (the GN default is
        # the full-depth choice), as ``phase1_dynamic_args`` pins it.
        return self._derived(max_iters=phase1_iters, precond="none")

    def _straggler_backend(self) -> "CudaBackend":
        """Full-depth backend for the compacted unconverged tail, with the
        GN-diagonal initial metric (stragglers are the ill-conditioned
        series the plain metric stalls on)."""
        return self._derived(precond="gn_diag")

    def _host(self, out: Dict[str, torch.Tensor],
              n: int) -> Dict[str, np.ndarray]:
        with self.stages.span("to_host"):
            return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def _chunk(self, b: int, per_series: int, least: int) -> int:
        # Round DOWN to a power of two: rounding up would let the chunk
        # overshoot the element budget by up to 2x.
        c = max(least, self._PREDICT_ELEMS // max(per_series, 1))
        return min(next_pow2(c + 1) // 2, self.chunk_size, next_pow2(b))

    def _chunked(self, call, state, ds, cap, regressors, conditions,
                 c: int):
        b = int(state.theta.shape[0])
        ds_np = np.asarray(ds)
        t_len = ds_np.shape[-1]
        # Scalar / shared-(T,) cap and condition inputs are normalized to
        # per-series (B, T) views first, so slicing cuts the series axis.
        bt = lambda a: None if a is None else np.broadcast_to(  # noqa: E731
            np.asarray(a), (b, t_len)
        )
        cap = bt(cap)
        conditions = None if conditions is None else {
            k: bt(v) for k, v in conditions.items()
        }
        outs = []
        for ci, lo in enumerate(range(0, b, c)):
            hi = min(lo + c, b)
            sl = lambda a: _slice_repeat_pad(a, lo, hi, c)  # noqa: E731
            out = call(
                ci, _slice_state(state, lo, hi, c),
                ds_np if ds_np.ndim == 1 else sl(ds_np),
                cap=sl(cap), regressors=sl(regressors),
                conditions=None if conditions is None else {
                    k: sl(v) for k, v in conditions.items()
                },
            )
            outs.append(self._host(out, hi - lo))
        return {
            k: np.concatenate([o[k] for o in outs], axis=0)
            for k in outs[0]
        }

    def predict(self, state, ds, cap=None, regressors=None, seed=0,
                num_samples=None, conditions=None) -> Dict[str, np.ndarray]:
        b = int(state.theta.shape[0])
        t_len = np.asarray(ds).shape[-1]
        n_s = (
            self.config.uncertainty_samples if num_samples is None
            else num_samples
        ) or 1
        c = self._chunk(b, n_s * t_len, 1)
        if b <= c:
            out = self._model.predict(
                state, ds, cap=cap, regressors=regressors, seed=seed,
                num_samples=num_samples, conditions=conditions,
            )
            return self._host(out, b)

        def call(ci, sub, ds_c, **kw):
            # Independent, well-mixed draws per chunk: integer seed
            # arithmetic (seed + lo) would collide across predict calls
            # whose user seeds differ by less than the batch.
            chunk_seed = int(
                np.random.SeedSequence((seed, ci)).generate_state(1)[0]
            )
            return self._model.predict(sub, ds_c, seed=chunk_seed,
                                       num_samples=num_samples, **kw)

        return self._chunked(call, state, ds, cap, regressors, conditions, c)

    def components(self, state, ds, cap=None, regressors=None,
                   conditions=None) -> Dict[str, np.ndarray]:
        b = int(state.theta.shape[0])
        t_len = np.asarray(ds).shape[-1]
        c = self._chunk(b, t_len, 64)
        if b <= c:
            out = self._model.components(
                state, ds, cap=cap, regressors=regressors,
                conditions=conditions,
            )
            return self._host(out, b)

        def call(ci, sub, ds_c, **kw):
            return self._model.components(sub, ds_c, **kw)

        return self._chunked(call, state, ds, cap, regressors, conditions, c)


def phase1_dynamic_args(phase1_iters: int, use_init: bool,
                        solver_config) -> dict:
    """THE shallow-phase policy, in the port's form: the reference's
    traced triple (depth ``phase1_iters``, plain metric, ridge init
    unless a warm start is supplied) as ``{"solver_config": ...,
    "use_init": ...}`` -- the solver config with ``max_iters`` clamped
    to ``min(phase1_iters, max_iters)`` and ``precond="none"``, and
    whether the caller's ``init`` is used."""
    return {
        "solver_config": dataclasses.replace(
            solver_config,
            max_iters=min(int(phase1_iters), int(solver_config.max_iters)),
            precond="none",
        ),
        "use_init": bool(use_init),
    }


def phase2_dynamic_args(solver_config) -> dict:
    """THE deep-phase policy (see ``phase1_dynamic_args``): full solver
    depth, GN-diagonal initial metric, warm-started from phase 1."""
    return {
        "solver_config": dataclasses.replace(solver_config,
                                             precond="gn_diag"),
        "use_init": True,
    }


def tune_phase1_depth(depth: int, frac_unconv: float,
                      max_iters: int) -> int:
    """THE adaptive phase-1 depth policy, applied once after a first
    chunk: deepen only on a pathological first chunk (a quarter still
    progressing), shallow out when virtually everything converges early.
    One definition for every chunked two-phase path."""
    if frac_unconv > 0.25:
        return min(int(depth) * 2, int(max_iters))
    if frac_unconv < 0.005 and int(depth) > 8:
        return max(8, int(depth) * 2 // 3)
    return int(depth)


def difficulty_order(grad_norm: np.ndarray) -> np.ndarray:
    """Argsort for compacting stragglers, hardest first.

    Each padded sub-chunk's lockstep solve runs until ITS slowest member
    converges, so grouping similar-difficulty series lets easy sub-chunks
    exit early.  Phase-1 exit grad-norm is the difficulty proxy; NaN grad
    norms (diverged series) count as hardest.  Callers patch results back
    by index, so the reorder never changes results."""
    g = np.asarray(grad_norm, np.float64)
    g = np.where(np.isnan(g), np.inf, g)
    return np.argsort(-g, kind="stable")
