"""Parameter store: fitted params + scalings keyed by series id.

Backs the streaming incremental-refit path (eval config 5): each
micro-batch looks up prior parameters for the series it touches,
warm-starts the solver, and writes the refreshed parameters back.

Storage is the native ParamTable (``tsspark_tpu_torch.native``, C++):
one micro-batch update/lookup is two memcpy-bound bulk calls over
contiguous float64 rows, the Python layer only interns string series ids
to int64 codes.  The row layout is the JAX package's (theta, then
``_flatten_meta``'s columns, then the cadence), and persistence is the
shared checkpoint format (``utils.checkpoint``, atomic npz + sidecar), so
a store saved by either package loads in the other.  New series simply
miss and fall back to data-driven init.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tsspark_tpu_torch import native
from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.models.prophet.model import FitState
from tsspark_tpu_torch.utils import checkpoint as ckpt


def _meta_dim(config: ProphetConfig) -> int:
    # Row layout: y_scale, floor, ds_start, ds_span (4) + reg_mean (R) +
    # reg_std (R) + changepoints (n_cp); see _flatten_meta.
    return 4 + 2 * config.num_regressors + config.n_changepoints


def _flatten_meta(meta: ScalingMeta) -> np.ndarray:
    """(B, meta_dim) float64 row-block from a batched ScalingMeta.

    Float64 end-to-end: ``ds_start`` is in absolute epoch days (~2e4),
    where float32's ulp is ~5 minutes — enough to bias hourly-cadence
    warm-start time alignment (warmstart.transfer_theta takes the
    difference of two such starts).
    """
    cols = [
        np.asarray(meta.y_scale, np.float64)[:, None],
        np.asarray(meta.floor, np.float64)[:, None],
        np.asarray(meta.ds_start, np.float64)[:, None],
        np.asarray(meta.ds_span, np.float64)[:, None],
        np.asarray(meta.reg_mean, np.float64),
        np.asarray(meta.reg_std, np.float64),
        np.asarray(meta.changepoints, np.float64),
    ]
    return np.concatenate(cols, axis=1)


def _unflatten_meta(rows: np.ndarray, config: ProphetConfig) -> ScalingMeta:
    """Host numpy float64 fields (the port's ScalingMeta contract)."""
    r = config.num_regressors
    return ScalingMeta(
        y_scale=np.asarray(rows[:, 0]),
        floor=np.asarray(rows[:, 1]),
        ds_start=np.asarray(rows[:, 2]),
        ds_span=np.asarray(rows[:, 3]),
        reg_mean=np.asarray(rows[:, 4 : 4 + r]),
        reg_std=np.asarray(rows[:, 4 + r : 4 + 2 * r]),
        changepoints=np.asarray(rows[:, 4 + 2 * r :]),
    )


def _theta(rows: np.ndarray) -> torch.Tensor:
    """Stored float64 theta columns as the fit's float32 CPU tensor (the
    stored values are float32 values, so the cast is exact)."""
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32))


class ParamStore:
    """Per-series (theta row, scaling meta row, cadence) storage.

    The trailing row column is the series' observed median step in days
    (its cadence), recorded by the streaming driver at update time so
    the forecast read path can build every future grid with one
    vectorized broadcast.  Zero means "never recorded"; readers
    substitute the daily default.
    """

    def __init__(self, config: ProphetConfig):
        self.config = config
        # +1: the cadence column (see class docstring).
        self._table = native.ParamTable(
            config.num_params + _meta_dim(config) + 1
        )
        self._code_of: Dict[str, int] = {}
        self._id_of: List[str] = []

    def _codes(self, series_ids: Sequence, intern: bool) -> np.ndarray:
        codes = np.empty(len(series_ids), np.int64)
        for i, sid in enumerate(series_ids):
            s = str(sid)
            c = self._code_of.get(s)
            if c is None:
                if not intern:
                    c = -1  # never stored -> guaranteed miss
                else:
                    c = len(self._id_of)
                    self._code_of[s] = c
                    self._id_of.append(s)
            codes[i] = c
        return codes

    def __len__(self) -> int:
        return len(self._table)

    def __contains__(self, series_id: str) -> bool:
        return str(series_id) in self._code_of

    def update(self, series_ids: Sequence, state: FitState,
               step: Optional[np.ndarray] = None) -> None:
        """Upsert fitted rows.  ``step``: per-series median cadence in
        days (``None`` keeps each series' previously recorded value)."""
        if step is None:
            step = self._raw_steps(series_ids)
        theta = state.theta
        if isinstance(theta, torch.Tensor):
            theta = theta.detach().cpu().numpy()
        rows = np.concatenate(
            [np.asarray(theta, np.float64), _flatten_meta(state.meta),
             np.asarray(step, np.float64)[:, None]],
            axis=1,
        )
        self._table.update(self._codes(series_ids, intern=True), rows)

    def _raw_steps(self, series_ids: Sequence) -> np.ndarray:
        """Stored cadence column as-is (0.0 for unknown/unrecorded)."""
        rows, found = self._table.lookup(self._codes(series_ids,
                                                     intern=False))
        return np.where(found, rows[:, -1], 0.0)

    def lookup_step(self, series_ids: Sequence) -> np.ndarray:
        """Per-series median cadence in days, daily default for series
        whose cadence was never recorded."""
        raw = self._raw_steps(series_ids)
        return np.where(raw > 0, raw, 1.0)

    def lookup(
        self, series_ids: Sequence
    ) -> Tuple[Optional[torch.Tensor], Optional[ScalingMeta], np.ndarray]:
        """Fetch stored rows for the requested series.

        Returns (theta (B, P) float32 CPU tensor, meta, found-mask (B,)).
        Rows for unknown series are zero-filled and flagged False in the
        mask; callers blend them with a cold init.  Returns (None, None,
        all-False) when no requested series is known.
        """
        rows, found = self._table.lookup(self._codes(series_ids,
                                                     intern=False))
        if not found.any():
            return None, None, found
        p = self.config.num_params
        m = _meta_dim(self.config)
        return (
            _theta(rows[:, :p]),
            _unflatten_meta(rows[:, p:p + m], self.config),
            found,
        )

    # -- persistence / publication ---------------------------------------------

    def export_state(self):
        """Every stored series as one id-sorted batch: ``(state, ids,
        step)`` — a FitState with zero diagnostics (the store keeps
        parameters, not solver history), the series ids aligned to its
        rows, and the raw cadence column.  Shared by :meth:`save` and
        :meth:`publish`, so the checkpoint and the serve registry never
        disagree on row layout."""
        codes, rows = self._table.export()
        ids = np.asarray([self._id_of[c] for c in codes])
        order = np.argsort(ids)
        ids, rows = ids[order], rows[order]
        p = self.config.num_params
        m = _meta_dim(self.config)
        n = len(ids)
        state = FitState(
            theta=_theta(rows[:, :p]),
            meta=_unflatten_meta(rows[:, p:p + m], self.config),
            loss=np.zeros(n, np.float32), grad_norm=np.zeros(n, np.float32),
            converged=np.ones(n, bool),
            n_iters=np.zeros(n, np.int32),
        )
        return state, ids, rows[:, -1].copy()

    def save(self, path: str) -> None:
        state, ids, step = self.export_state()
        ckpt.save_state(path, state, self.config, series_ids=ids,
                        extras={"step": step})

    def publish(self, registry, activate: bool = True) -> int:
        """Publish the whole store as one new serve-registry version
        (``serve.registry.ParamRegistry``): the streaming side's write
        path into serving.  Returns the version."""
        state, ids, step = self.export_state()
        return registry.publish(state, ids, step=np.where(step > 0, step, 1.0),
                                activate=activate)

    @classmethod
    def load(cls, path: str, config: ProphetConfig, strict: bool = True
             ) -> "ParamStore":
        state, ids, extras = ckpt.load_state(path, config, strict=strict,
                                             return_extras=True)
        store = cls(config)
        if ids is not None:
            store.update(ids, state, step=extras.get("step"))
        return store
