"""The forecast plane's shared helpers: bucket ladder, future grid and the
publish-time point forecast.

The part of the JAX package's ``serve/fplane.py`` that the quantile plane
(``uncertainty/qplane.py``) builds on.  ``_predict_rows`` is the engine's
dispatch math in publish-width chunks: gather, future grid,
``backend.predict`` at ``num_samples=0`` (K1 on the card).  The point
plane itself (``write_plane`` … ``maybe_publish``) waits for the port's
serving-at-scale slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.parallel.sharding import compacted_width, next_pow2

#: The deterministic (num_samples=0) predict output keys.
POINT_KEYS = ("yhat", "trend", "additive", "multiplicative")

#: Horizons a plane covers by default; their bucket ladder is {8, 16, 32}.
DEFAULT_HOT_HORIZONS = (7, 14, 28)

#: CRC shard width (rows): what one torn write can hide behind a stale CRC.
DEFAULT_SHARD_ROWS = 65536

#: The engine's horizon floor (``PredictionEngine.horizon_floor``).
_HORIZON_FLOOR = 8

#: Publish-time batch width for the full-table compute.
_PUBLISH_CHUNK = 256


def bucket_ladder(horizons: Sequence[int],
                  floor: int = _HORIZON_FLOOR) -> Tuple[int, ...]:
    """The pow-2 horizon buckets ``horizons`` land in (the engine's
    ``max(floor, next_pow2(h))``), deduplicated and sorted."""
    return tuple(sorted({max(int(floor), next_pow2(int(h)))
                         for h in horizons}))


def future_grid(state, step: np.ndarray, hb: int) -> np.ndarray:
    """The engine's future grid: each series continues its own calendar
    at its recorded cadence, float64 throughout (a publish-time grid and
    a request-time grid over the same rows are the same bits)."""
    last = np.asarray(state.meta.ds_start + state.meta.ds_span,
                      np.float64)
    return last[:, None] + np.asarray(step, np.float64)[:, None] \
        * np.arange(1, int(hb) + 1)


def _predict_rows(snap, backend, idx: np.ndarray, hb: int,
                  chunk: int = _PUBLISH_CHUNK) -> Dict[str, np.ndarray]:
    """Deterministic point forecasts (data units) of snapshot rows ``idx``
    at bucket ``hb``, in chunks padded up the engine's width ladder
    (repeat-first-row padding).  Every predict op is row-local, so the
    chunking does not show in the bytes."""
    idx = np.asarray(idx, np.int64)
    outs: List[Dict[str, np.ndarray]] = []
    for lo in range(0, len(idx), int(chunk)):
        part = idx[lo:lo + int(chunk)]
        n_part = len(part)
        width = compacted_width(n_part, floor=_HORIZON_FLOOR, multiple=1)
        if width > n_part:
            part = np.concatenate(
                [part, np.repeat(part[:1], width - n_part)]
            )
        state, step = snap.take(part)
        grid = future_grid(state, step, hb)
        out = backend.predict(state, grid, num_samples=0, seed=0)
        outs.append({k: np.asarray(out[k])[:n_part] for k in POINT_KEYS})
    if not outs:
        return {k: np.empty((0, int(hb)), np.float32) for k in POINT_KEYS}
    return {k: np.ascontiguousarray(
                np.concatenate([o[k] for o in outs], axis=0))
            for k in POINT_KEYS}
