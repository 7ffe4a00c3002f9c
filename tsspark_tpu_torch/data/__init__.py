"""Public data API: generators, loaders, and the columnar data plane.

Call sites import from here instead of deep-importing submodules::

    from tsspark_tpu_torch import data
    batch = data.m5_like(n_series=512)
    ddir = data.ensure(data.DatasetSpec("m5", 30490, 1941))

The port's copy of the JAX package's ``data`` export surface.  The CSV
loaders (pandas-backed) resolve lazily so importing the package in a
lean child process (the ingest driver and its pool) never pays the
pandas import; nothing here imports torch.
"""

from __future__ import annotations

from tsspark_tpu_torch.data.datasets import (
    SEED_BLOCK,
    SeriesBatch,
    dataset_ids,
    demo_weekly_rows,
    m4_hourly_like,
    m5_like,
    m5_rows,
    peyton_manning_like,
    wiki_logistic_like,
)
from tsspark_tpu_torch.data.plane import (
    DatasetSpec,
    GENERATORS,
    advanced_since,
    dataset_fingerprint,
    default_root,
    delta_seq,
    ensure,
    generate_rows,
    import_batch,
    land_delta,
    land_synthetic_delta,
    open_batch,
    ready_coverage,
)

__all__ = [
    "SEED_BLOCK", "SeriesBatch", "dataset_ids", "demo_weekly_rows",
    "m4_hourly_like", "m5_like", "m5_rows", "peyton_manning_like",
    "wiki_logistic_like",
    "DatasetSpec", "GENERATORS", "advanced_since",
    "dataset_fingerprint", "default_root", "delta_seq", "ensure",
    "generate_rows", "import_batch", "land_delta",
    "land_synthetic_delta", "open_batch", "ready_coverage",
    "load_m4", "load_m5",
]

_LAZY = {"load_m4", "load_m5"}


def __getattr__(name: str):
    if name in _LAZY:
        from tsspark_tpu_torch.data import loaders

        return getattr(loaders, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
