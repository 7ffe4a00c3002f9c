"""Typed storage errors: a failing disk must never look like a missing file.

The port's copy of the JAX package's ``io/errors.py``.  A plane reader
treats absence (the ENOENT family) as "not landed yet"; a real media
failure surfaces as a typed ``OSError`` subclass (``DiskFullError`` for
ENOSPC / EDQUOT, ...), with the original errno, that a publisher can
refuse on, and is counted (``tsspark_io_disk_errors_total``).  Every
storage error is still an ``OSError``, so ``except OSError`` sites keep
working.  ``BackpressureError`` is flow control, deliberately not an
``OSError``.
"""

from __future__ import annotations

import errno
import os

_MISSING_ERRNOS = frozenset({errno.ENOENT, errno.ENOTDIR, errno.ESTALE})


class StorageError(OSError):
    """A durable-I/O operation failed for a reason that is not absence."""


class DiskFullError(StorageError):
    """ENOSPC / EDQUOT: no space (or quota) left on the device."""


class DiskIOError(StorageError):
    """EIO: the device reported a hard I/O error."""


class ReadOnlyError(StorageError):
    """EROFS: the filesystem went read-only."""


class ShortWriteError(StorageError):
    """A write persisted fewer bytes than were handed to it and the site
    detected the tear before publishing."""


class BackpressureError(RuntimeError):
    """A degradation ladder refused new work (disk headroom below its
    pause threshold)."""

    def __init__(self, state: str, headroom: float):
        super().__init__(
            f"delta ingestion paused by degradation ladder "
            f"(state={state}, headroom={headroom:.3f})"
        )
        self.state = state
        self.headroom = headroom


_ERRNO_CLASS = {
    errno.ENOSPC: DiskFullError,
    errno.EDQUOT: DiskFullError,
    errno.EIO: DiskIOError,
    errno.EROFS: ReadOnlyError,
}


def is_missing(e: BaseException) -> bool:
    """True when ``e`` means "the file is not there"."""
    return isinstance(e, OSError) and e.errno in _MISSING_ERRNOS


def classify_os_error(e: OSError) -> OSError:
    """``e`` as its typed storage subclass (ENOSPC -> ``DiskFullError``,
    EIO -> ``DiskIOError``, EROFS -> ``ReadOnlyError``); anything else,
    the ENOENT family included, comes back unchanged.  The typed error
    keeps the errno and message and chains ``e`` as its cause."""
    if isinstance(e, StorageError):
        return e
    cls = _ERRNO_CLASS.get(e.errno)
    if cls is None:
        return e
    err = cls(e.errno, os.strerror(e.errno) if e.errno else str(e))
    err.filename = getattr(e, "filename", None)
    err.__cause__ = e
    try:
        from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

        METRICS.counter("tsspark_io_disk_errors_total").inc()
        METRICS.counter(
            f"tsspark_io_disk_error_{cls.__name__}_total").inc()
    except Exception:
        pass
    return err


def reraise_classified(e: OSError):
    """Raise ``e`` as its typed storage subclass, or as itself when it
    needs no mapping (the errno and message are kept)."""
    ce = classify_os_error(e)
    if ce is e:
        raise e
    raise ce from e
