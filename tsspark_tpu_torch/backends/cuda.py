"""CUDA backend: the batched fit and forecasts, chunked over series to
bound device memory.

The counterpart of the JAX package's ``TpuBackend`` (without its
process-isolated ``resilient`` route and its multi-chip ``mesh`` route):

* ``fit``: batches larger than one chunk (8,192 series by default) are
  fitted chunk by chunk, every chunk padded to a power of two (32-row
  floor) with inert all-masked series; ragged-length batches may be
  split into length buckets; then a rescue pass refits the series that
  exited the solver stuck (status FLOOR or STALLED) from two starts with
  the GN-diagonal metric and keeps each series' best loss.
* ``predict`` / ``components``: a batch larger than one chunk streams
  through the model in fixed-size chunks (the last padded by repeating a
  real row, whose outputs are discarded), each chunk seeded with its own
  ``SeedSequence((seed, chunk))`` draw.

Results come back on the host: numpy arrays, and the fitted ``theta`` as
a CPU tensor.  ``stages`` is the model's stage clock: the fit's prep,
pack, to_device, init, solve, to_host and (this backend's) rescue; the
forecast's prep, forecast and to_host.
"""

from __future__ import annotations

import dataclasses
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
                 compact: bool = True, **kwargs):
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
        """
        super().__init__(*args, **kwargs)
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
            compact=self.compact,
        )
        opts.update(kw)
        sub = CudaBackend(self.config, solver_config or self.solver_config,
                          **opts)
        if share_stages:
            sub._model.stages = sub.stages = self.stages
        return sub

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
            return state
        with changepoint_span_warning_suppressed(), \
                self.stages.span("rescue"):
            return self._rescue_pass(
                state, ds, y, mask, cap, floor, regressors, conditions,
                reg_u8_cols,
            )

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
        warm = bkr.fit(ds2, y[idx], init=_rows(state.theta, idx), **kw)
        fresh = bkr.fit(ds2, y[idx], **kw)
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
                  reg_u8_cols=None):
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
        if ds.ndim == 1:
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
                u8,
            )
        states = []
        for lo in range(0, b, c):
            hi = min(lo + c, b)
            sl = lambda a: _rows(a, slice(lo, hi))  # noqa: E731
            slc = lambda d: None if d is None else {  # noqa: E731
                k: np.asarray(v)[lo:hi] for k, v in d.items()
            }
            states.append(
                self._fit_padded(
                    ds if ds.ndim == 1 else ds[lo:hi],
                    y[lo:hi], sl(mask), sl(cap), sl(floor), sl(regressors),
                    sl(init), slc(conditions), c, u8,
                )
            )
        return _concat_states(states)

    def _fit_padded(self, ds, y, mask, cap, floor, regressors, init,
                    conditions, c, reg_u8_cols=None):
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
            if conditions is not None:
                conditions = {
                    k: _pad_batch(v, c) for k, v in conditions.items()
                }
        state = self._model.fit(
            ds, y, mask=mask, cap=cap, floor=floor, regressors=regressors,
            init=init, iter_segment=self.iter_segment,
            on_segment=self.on_segment, conditions=conditions,
            reg_u8_cols=reg_u8_cols, compact=self.compact,
        )
        return _take_rows(state, slice(0, b))

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
