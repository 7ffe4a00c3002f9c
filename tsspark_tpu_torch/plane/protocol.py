"""The column-plane protocol: spec first, columns, CRC sentinel last.

The port's copy of the JAX package's ``plane/protocol.py``, the one
implementation the snapshot, forecast and quantile planes route through,
built on the durable-I/O layer (``io.durable``) so every plane inherits
its fault points, typed storage errors and disk-budget gate:

* ``write_spec``     — the identity record, FIRST.  A spec without its
  sentinel reads as a plane still being published.
* ``write_column``   — one atomic ``.npy`` per column.
* ``write_sentinel`` — the per-shard CRC32 record, LAST: the unit of
  visibility.  A reader trusts nothing the sentinel does not cover, so a
  torn or short-written column is refused at attach, never served.

``publish_plane`` is the one generic writer of that order.  The file
layout and the CRCs are the JAX package's, so a plane either package
publishes attaches in the other.  A write that fails for lack of space
raises ``io.errors.DiskFullError`` (other media failures their own typed
errors).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tsspark_tpu_torch.io import (
    atomic_write,
    attach_array,
    is_missing,
    link_or_copy,
    reraise_classified,
)

__all__ = [
    "shard_ranges", "shard_crcs", "read_json", "write_spec",
    "write_column", "write_sentinel", "publish_plane", "verify_crcs",
    "attach_column", "link_or_copy",
]


def shard_ranges(n: int, shard_rows: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` windows of ``shard_rows`` rows covering ``n``."""
    return [(lo, min(lo + shard_rows, n))
            for lo in range(0, n, shard_rows)]


def shard_crcs(cols: Dict[str, np.ndarray],
               lo: Optional[int] = None,
               hi: Optional[int] = None) -> Dict[str, int]:
    """Per-column CRC32 over rows ``[lo, hi)`` (whole columns when no
    range is given): the sentinel's payload and the verifier's
    recomputation."""
    if lo is None:
        return {k: zlib.crc32(np.ascontiguousarray(a).tobytes())
                for k, a in cols.items()}
    return {k: zlib.crc32(np.ascontiguousarray(a[lo:hi]).tobytes())
            for k, a in cols.items()}


def read_json(path: str) -> Optional[Dict]:
    """A protocol record as a dict, or None when it is absent or torn; a
    real disk failure raises its typed storage error."""
    try:
        with open(path) as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except ValueError:
        return None
    except OSError as e:
        if is_missing(e):
            return None
        reraise_classified(e)


def _write(path: str, write_fn, mode: str = "wb") -> None:
    try:
        atomic_write(path, write_fn, mode=mode)
    except OSError as e:
        reraise_classified(e)


def write_spec(path: str, spec: Dict) -> None:
    """Land a plane's identity record (step 1: spec FIRST)."""
    _write(path, lambda fh: json.dump(spec, fh, indent=1), mode="w")


def write_column(path: str, arr: np.ndarray) -> None:
    """Land one column payload atomically (step 2)."""
    _write(path, lambda fh: np.save(fh, arr))


def write_sentinel(path: str, sentinel: Dict) -> None:
    """Land the CRC sentinel (step 3, LAST)."""
    _write(path, lambda fh: json.dump(sentinel, fh), mode="w")


def publish_plane(dirpath: str, spec_name: str, spec: Dict,
                  columns: Dict[str, np.ndarray],
                  col_path: Callable[[str, str], str],
                  sentinel_name: str, sentinel: Dict) -> None:
    """The generic plane publish: spec first, every column payload, CRC
    sentinel LAST.  A crash after any prefix leaves the plane invisible
    (no sentinel) or complete."""
    write_spec(os.path.join(dirpath, spec_name), spec)
    for name, arr in columns.items():
        write_column(col_path(dirpath, name), arr)
    write_sentinel(os.path.join(dirpath, sentinel_name), sentinel)


def verify_crcs(cols: Dict[str, np.ndarray],
                shards) -> Optional[Tuple[str, int, int]]:
    """Recompute every shard CRC against the sentinel's records: None
    when all match, else ``(column, lo, hi)`` of the first mismatch."""
    for entry in shards or ():
        lo, hi, crcs = int(entry[0]), int(entry[1]), entry[2]
        got = shard_crcs(cols, lo, hi)
        for name, want in crcs.items():
            if got.get(name) != int(want):
                return (name, lo, hi)
    return None


def attach_column(path: str) -> np.ndarray:
    """One column as a read-only memmap (through the durable-I/O layer's
    ``io_mmap`` fault point)."""
    return attach_array(path, mmap_mode="r")
