"""Atomic write-temp-then-rename for every durable artifact of the port.

The full payload goes to a dot-prefixed, pid-suffixed temp file in the
TARGET directory (same filesystem, so the rename is atomic) and is then
``os.replace``-d into place: a reader sees the old file, the new file,
or no file — never a torn one.  Same naming as the JAX package's helper,
so either package's sweep reaps the other's orphans.
"""

from __future__ import annotations

import os
import time
from typing import Callable

#: A live writer keeps its temp's mtime moving; 10 minutes of silence
#: means the writer is dead.
STALE_TEMP_S = 600.0


def _tmp_path(path: str) -> str:
    d, base = os.path.split(os.path.abspath(path))
    return os.path.join(d, f".{base}.tmp.{os.getpid()}")


def atomic_write(path: str, write_fn: Callable, mode: str = "wb") -> None:
    """Write ``path`` atomically: ``write_fn(fh)`` fills a temp file which
    is closed and renamed into place."""
    tmp = _tmp_path(path)
    try:
        with open(tmp, mode) as fh:
            write_fn(fh)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def append_line(path: str, line: str) -> None:
    """Crash-safe append of ONE line to a shared JSONL log: the whole line
    (newline included) goes down in a single ``os.write`` on an
    ``O_APPEND`` descriptor, so concurrent writer processes never
    interleave bytes mid-line; a writer killed mid-write tears at most
    its own last line, which every reader of these logs tolerates."""
    data = (line if line.endswith("\n") else line + "\n").encode()
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Atomic text-file write (sentinels, fingerprints, heartbeats)."""
    atomic_write(path, lambda fh: fh.write(text), mode="w")


def sweep_stale_temps(dirpath: str, max_age_s: float = STALE_TEMP_S,
                      recursive: bool = False) -> int:
    """Remove dead writers' orphaned ``.*.tmp.<pid>`` files in ``dirpath``
    (age-gated so a live writer's temp is never yanked).  ``recursive``
    walks subdirectories too: the registry keeps one directory per
    version, and a publisher killed mid-snapshot orphans its temp inside
    one.  Returns the count removed."""
    removed = 0
    if recursive:
        listing = ((d, names) for d, _sub, names in os.walk(dirpath))
    else:
        try:
            listing = [(dirpath, os.listdir(dirpath))]
        except OSError:
            return 0
    now = time.time()
    for d, names in listing:
        for name in names:
            if not (name.startswith(".") and ".tmp." in name):
                continue
            p = os.path.join(d, name)
            try:
                if now - os.path.getmtime(p) > max_age_s:
                    os.remove(p)
                    removed += 1
            except OSError:
                continue  # already gone / racing writer won its rename
    return removed
