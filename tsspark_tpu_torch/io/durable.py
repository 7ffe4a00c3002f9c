"""The durable-I/O choke point: every plane, registry and plan writer of
the port routes here.

The port's copy of the JAX package's ``io/durable.py``.  It wraps
``utils.atomic``'s write-temp-then-rename idiom with:

  * **Named fault injection** — the ``io_write`` / ``io_fsync`` /
    ``io_rename`` / ``io_link`` / ``io_mmap`` points of
    ``resilience/faults.py``, so ENOSPC, EIO, short writes, lost fsyncs
    and slow media are injectable once for every artifact family.
    Storage rules may be path-scoped (``path="manifest.json"``).
  * **Typed error classification** — real disk failures surface as
    ``io.errors`` subclasses (still ``OSError``s), never as missing
    files.
  * **Accounting** — ``io.*`` counters and histograms, and the
    environment-armed ``DiskBudget`` consulted before every write under
    its root.

``atomic_write`` here fsyncs the temp before the rename: the publish is a
durability barrier, and ``io_fsync`` sits where a lost fsync would bite.
"""

from __future__ import annotations

import errno as _errno
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np

from tsspark_tpu_torch.io import budget as _budget
from tsspark_tpu_torch.io.errors import classify_os_error
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.utils.atomic import (  # noqa: F401  (re-exported)
    STALE_TEMP_S,
    _tmp_path,
    sweep_stale_temps,
)
from tsspark_tpu_torch.utils.atomic import append_line as _raw_append_line

#: Named injection points (see resilience/faults.py).
IO_WRITE = "io_write"
IO_FSYNC = "io_fsync"
IO_RENAME = "io_rename"
IO_LINK = "io_link"
IO_MMAP = "io_mmap"

#: errnos where a hardlink legitimately degrades to a copy (filesystem
#: capability, not media failure); anything else propagates, or an
#: injected EIO would be silently healed by the fallback.
_LINK_FALLBACK_ERRNOS = frozenset(
    getattr(_errno, name)
    for name in ("EXDEV", "EPERM", "EMLINK", "EOPNOTSUPP", "ENOTSUP")
    if hasattr(_errno, name)
)

_m = {"init": False}


def _metrics():
    """Lazy ``io.*`` instrument cache (metrics never break I/O)."""
    if not _m["init"]:
        try:
            from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

            _m["writes"] = METRICS.counter("tsspark_io_writes_total")
            _m["bytes"] = METRICS.counter("tsspark_io_write_bytes_total")
            _m["write_s"] = METRICS.histogram("tsspark_io_write_seconds")
            _m["fsync_s"] = METRICS.histogram("tsspark_io_fsync_seconds")
        except Exception:
            _m["writes"] = _m["bytes"] = None
            _m["write_s"] = _m["fsync_s"] = None
        _m["init"] = True
    return _m


def _reraise_classified(e: OSError) -> None:
    """Re-raise ``e`` as its typed storage subclass (or as is).  Call
    only from an ``except OSError`` block."""
    ce = classify_os_error(e)
    if ce is e:
        raise
    raise ce from e


def _gate_budget(path: str) -> None:
    """Consult the environment-armed ``DiskBudget`` before a write under
    its root."""
    b = _budget.active()
    if b is not None and b.governs(path):
        b.check(0, what=os.path.basename(path))


def atomic_write(path: str, write_fn: Callable, mode: str = "wb") -> None:
    """Durable atomic publish of ``path``: budget gate, temp write, fsync
    barrier, rename, each step a named fault point.  The contract of
    ``utils.atomic.atomic_write`` plus durability and classified
    errors."""
    t0 = time.perf_counter()
    tmp = _tmp_path(path)
    nbytes = 0
    try:
        try:
            _gate_budget(path)
            faults.inject(IO_WRITE, path=path)
            with open(tmp, mode) as fh:
                write_fn(fh)
                fh.flush()
                frac = faults.short_write(IO_WRITE, path)
                if frac is not None:
                    # The torn artifact still publishes: an unchecked
                    # write(2) return looks exactly like success, and
                    # only the CRC-sentinel read path may catch it.
                    fh.truncate(max(0, int(fh.tell() * frac)))
                t1 = time.perf_counter()
                faults.inject(IO_FSYNC, path=path)
                os.fsync(fh.fileno())
                m = _metrics()
                if m["fsync_s"] is not None:
                    m["fsync_s"].observe(time.perf_counter() - t1)
            nbytes = os.path.getsize(tmp)
            faults.inject(IO_RENAME, path=path)
            faults.lost_fsync(IO_FSYNC, path)
            os.replace(tmp, path)
        except OSError as e:
            _reraise_classified(e)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    m = _metrics()
    if m["writes"] is not None:
        m["writes"].inc()
        m["bytes"].inc(nbytes)
        m["write_s"].observe(time.perf_counter() - t0)


def atomic_write_text(path: str, text: str) -> None:
    """Durable atomic text-file write (sentinels, manifests)."""
    atomic_write(path, lambda fh: fh.write(text), mode="w")


def append_line(path: str, line: str) -> None:
    """Crash-safe single-``os.write`` append (``utils.atomic``'s
    contract) behind the ``io_write`` fault point and classified
    errors."""
    try:
        faults.inject(IO_WRITE, path=path)
        _raw_append_line(path, line)
    except OSError as e:
        _reraise_classified(e)


def hardlink(src: str, dst: str) -> None:
    """``os.link`` behind the ``io_link`` fault point; classified errors."""
    try:
        faults.inject(IO_LINK, path=dst)
        os.link(src, dst)
    except OSError as e:
        _reraise_classified(e)


def link_or_copy(src: str, dst: str) -> None:
    """Hardlink ``src`` -> ``dst``, degrading to a byte copy only for
    capability errnos (cross-device, no-hardlink filesystems).  Real
    media failures, injected ones included, propagate."""
    try:
        hardlink(src, dst)
    except OSError as e:
        if getattr(e, "errno", None) not in _LINK_FALLBACK_ERRNOS:
            raise
        try:
            shutil.copy2(src, dst)
        except OSError as e2:
            _reraise_classified(e2)


def open_memmap(path: str, *, mode: str = "r", dtype=None, shape=None,
                lo: Optional[int] = None, hi: Optional[int] = None):
    """``np.lib.format.open_memmap`` behind the ``io_mmap`` fault point
    (attach and create); ``lo``/``hi``: the row range the caller writes
    (series-scoped fault rules match it); classified errors."""
    try:
        faults.inject(IO_MMAP, lo=lo, hi=hi, path=path)
        if mode in ("w+",):
            _gate_budget(path)
        if dtype is None and shape is None:
            return np.lib.format.open_memmap(path, mode=mode)
        return np.lib.format.open_memmap(
            path, mode=mode, dtype=dtype, shape=shape)
    except OSError as e:
        _reraise_classified(e)


def attach_array(path: str, *, mmap_mode: str = "r"):
    """``np.load(..., mmap_mode=...)`` behind the ``io_mmap`` fault point:
    the read-side attach every plane viewer uses."""
    try:
        faults.inject(IO_MMAP, path=path)
        return np.load(path, mmap_mode=mmap_mode)
    except OSError as e:
        _reraise_classified(e)


def fsync_dir(dirpath: str) -> None:
    """Directory-entry durability barrier; best effort on filesystems
    that refuse an O_RDONLY directory fsync."""
    faults.inject(IO_FSYNC, path=dirpath)
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
