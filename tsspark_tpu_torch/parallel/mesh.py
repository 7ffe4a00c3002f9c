"""Device-mesh construction for sharded batch fitting (the port's copy of
the JAX package's ``parallel/mesh.py``).

The fit is data-parallel over series, with optional sequence parallelism
over the time axis for very long series: a 2-D ``(series, time)`` grid of
devices.  Where the JAX package hands XLA a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives, the port's ``Mesh`` is only the grid: the
sharded fit (``parallel.sharding``) places each shard's rows on its
device and adds the partial sums itself.

The default device list is every CUDA device.  ``force_virtual_host_mesh``
(tests and CLIs that ask for the CPU) makes it ``n`` CPU entries instead:
shards on CPU entries run one after another on the one CPU, which is
enough to exercise every sharding decision.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tsspark_tpu_torch.config import ShardingConfig

#: Environment variable holding the virtual host mesh's entry count;
#: children spawned by a CPU run inherit it.
HOST_MESH_ENV = "TSSPARK_HOST_MESH"


def force_virtual_host_mesh(n: int = 8) -> None:
    """Make the default device list ``n`` CPU entries (idempotent; an
    existing setting wins), for this process and the children it spawns.
    The counterpart of the JAX package's ``resident.force_virtual_host_mesh``
    (which forces ``n`` virtual XLA CPU devices)."""
    os.environ.setdefault(HOST_MESH_ENV, str(int(n)))


def default_devices() -> list:
    """The virtual host mesh's CPU entries when one was forced, else every
    CUDA device (none on a machine without a card)."""
    n_host = os.environ.get(HOST_MESH_ENV)
    if n_host:
        return [torch.device("cpu")] * max(int(n_host), 1)
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of ``torch.device`` entries.

    ``devices`` is the (n_series, n_time) object array, ``axis_names`` the
    two axis names, ``shape`` the axis name -> size mapping, as on a
    ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"mesh of rank {arr.ndim} needs {arr.ndim} axis names, got "
                f"{tuple(axis_names)}"
            )
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.ravel()]})")


def make_mesh(
    n_series_shards: Optional[int] = None,
    n_time_shards: int = 1,
    devices: Optional[Sequence] = None,
    config: ShardingConfig = ShardingConfig(),
) -> Mesh:
    """Build a (series, time) mesh over the available devices.

    Defaults put every device on the series axis, the layout for the
    many-short-series regime.  ``n_time_shards > 1`` trades series
    parallelism for sequence parallelism (long series)."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if n_series_shards is None:
        if n % n_time_shards:
            raise ValueError(f"{n} devices not divisible by time={n_time_shards}")
        n_series_shards = n // n_time_shards
    if n_series_shards * n_time_shards != n:
        raise ValueError(
            f"mesh {n_series_shards}x{n_time_shards} != {n} devices"
        )
    arr = np.empty((n_series_shards, n_time_shards), dtype=object)
    for i, d in enumerate(devices):
        arr[i // n_time_shards, i % n_time_shards] = torch.device(d)
    time_axis = config.time_axis or "time"
    return Mesh(arr, (config.series_axis, time_axis))
