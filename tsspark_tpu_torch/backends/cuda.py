"""CUDA backend: batched forecasts, chunked over series to bound memory.

The counterpart of the JAX package's ``TpuBackend.predict`` /
``components``: a batch larger than one chunk streams through the model
in fixed-size chunks (the last padded by repeating a real row, whose
outputs are discarded), each chunk seeded with its own
``SeedSequence((seed, chunk))`` draw.  Results come back as host numpy
arrays.  ``fit`` waits for the MAP-fit slice of the port.

``stages`` is the model's stage clock plus "to_host": the wait for the
device and the copy of each chunk's outputs back to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tsspark_tpu_torch.backends.registry import (
    ForecastBackend,
    register_backend,
)
from tsspark_tpu_torch.models.prophet.model import FitState, ProphetModel
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


@register_backend
class CudaBackend(ForecastBackend):
    name = "cuda"

    # Memory bound for one chunk: a chunk's (S, B_chunk, T) sample count
    # stays under ~1 GB of float32, the JAX backend's budget (the
    # interval kernel stores no samples, but the plain version and
    # return_samples do).
    _PREDICT_ELEMS = 1 << 28

    def __init__(self, *args, chunk_size: int = 8192, device=None,
                 **kwargs):
        """``chunk_size`` bounds series per model call; ``device=None``
        is the card (and raises without one)."""
        super().__init__(*args, **kwargs)
        self.chunk_size = chunk_size
        self._model = ProphetModel(self.config, self.solver_config,
                                   device=device)
        self.device = self._model.device
        self.stages = self._model.stages

    def fit(self, *args, **kwargs):
        raise NotImplementedError("MAP fit: next port slice")

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
