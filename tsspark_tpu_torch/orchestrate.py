"""Series-id normalization shared by the registry's publish and lookup
paths (the port's copy of the JAX package's ``orchestrate`` helper)."""

from __future__ import annotations

import numpy as np


def normalize_series_ids(series_ids) -> np.ndarray:
    """Series ids as a numpy unicode array — C-level conversion, no
    per-series Python pass."""
    ids = np.asarray(series_ids)
    if ids.ndim == 0:
        # A sized-less iterable (a generator, or a bare string) lands as a
        # 0-d array; materialize it by iteration.
        ids = np.asarray(list(series_ids))
    if ids.dtype.kind not in ("U", "S"):
        ids = ids.astype(np.str_)
    return ids
