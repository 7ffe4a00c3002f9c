"""Typed storage errors: a failing disk must never look like a missing file.

The part of the JAX package's ``io/errors.py`` that the quantile plane
catches.  A plane reader treats absence (the ENOENT family) as "not landed
yet"; a real media failure surfaces as a typed ``OSError`` subclass
(``DiskFullError`` for ENOSPC / EDQUOT, ...), with the original errno,
that a publisher can refuse on.  ``BackpressureError`` is flow control,
deliberately not an ``OSError``.
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


def reraise_classified(e: OSError):
    """Raise ``e`` as its typed storage subclass, or as itself when it
    needs no mapping (the errno and message are kept)."""
    cls = None if isinstance(e, StorageError) else _ERRNO_CLASS.get(e.errno)
    if cls is None:
        raise e
    err = cls(e.errno, os.strerror(e.errno))
    err.filename = getattr(e, "filename", None)
    raise err from e
