"""``tsspark_tpu_torch.io`` — the storage fault domain's front door.

The port's copy of the JAX package's ``io`` package: one durable-I/O
layer (``durable``) the planes and the registry route through; typed
storage errors (``errors``) so a failing disk never reads as a missing
file; a per-root byte budget (``budget``) consulted before writes; and
the disk-pressure degradation ladder (``ladder``) the plane publishers
consult.
"""

from tsspark_tpu_torch.io.budget import DiskBudget
from tsspark_tpu_torch.io.durable import (
    IO_FSYNC,
    IO_LINK,
    IO_MMAP,
    IO_RENAME,
    IO_WRITE,
    append_line,
    atomic_write,
    atomic_write_text,
    attach_array,
    fsync_dir,
    hardlink,
    link_or_copy,
    open_memmap,
    sweep_stale_temps,
)
from tsspark_tpu_torch.io.errors import (
    BackpressureError,
    DiskFullError,
    DiskIOError,
    ReadOnlyError,
    ShortWriteError,
    StorageError,
    classify_os_error,
    is_missing,
    reraise_classified,
)
from tsspark_tpu_torch.io.ladder import (
    LADDER_STATES,
    DegradationLadder,
    active_ladder,
    current_state,
    gate_ingest,
    stale_serving,
)

__all__ = [
    "IO_FSYNC", "IO_LINK", "IO_MMAP", "IO_RENAME", "IO_WRITE",
    "append_line", "atomic_write", "atomic_write_text", "attach_array",
    "fsync_dir", "hardlink", "link_or_copy", "open_memmap",
    "sweep_stale_temps",
    "BackpressureError", "DiskFullError", "DiskIOError",
    "ReadOnlyError", "ShortWriteError", "StorageError",
    "classify_os_error", "is_missing", "reraise_classified",
    "DiskBudget",
    "LADDER_STATES", "DegradationLadder", "active_ladder",
    "current_state", "gate_ingest", "stale_serving",
]
