"""Checkpoint integrity: a CRC32 of an npz payload, stamped in the file,
and the quarantine of files that fail it.

The same stamp as the JAX package's (``integrity_crc``, a CRC32 over the
name, dtype, shape and bytes of every array in name order), so each
package verifies snapshots and chunk files the other wrote.  Files
without a stamp pass: np.load's zip CRCs already vouch for their bytes.

A chunk file that fails (torn, truncated, or read but mismatched) is
QUARANTINED: renamed ``*.corrupt`` (kept for forensics, outside the
resume globs), so its range reappears in the orchestrator's
``missing_ranges`` and is fitted again instead of assembled.
"""

from __future__ import annotations

import glob
import os
import zlib
from typing import Dict, List, Tuple

import numpy as np

INTEGRITY_KEY = "integrity_crc"


class ChunkIntegrityError(RuntimeError):
    """Corrupt/torn chunk files were found and quarantined; the caller
    should re-queue the attached ranges (they are now missing)."""

    def __init__(self, out_dir: str, ranges: List[Tuple[int, int]]):
        super().__init__(
            f"{len(ranges)} corrupt chunk file(s) quarantined in "
            f"{out_dir}: {ranges} — ranges re-queued for refit"
        )
        self.out_dir = out_dir
        self.ranges = ranges


def payload_crc(arrays: Dict) -> int:
    """CRC32 over every array's name, dtype, shape, and raw bytes, in
    name-sorted order."""
    crc = 0
    for name in sorted(arrays):
        if name == INTEGRITY_KEY:
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        for token in (name, str(a.dtype), str(a.shape)):
            crc = zlib.crc32(token.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def stamp(arrays: Dict) -> Dict:
    """Return ``arrays`` plus its ``integrity_crc`` entry (uint32)."""
    out = dict(arrays)
    out[INTEGRITY_KEY] = np.uint32(payload_crc(arrays))
    return out


def verify_arrays(z) -> bool:
    """Verify a loaded npz (or dict of arrays) against its stamp."""
    try:
        keys = list(getattr(z, "files", None) or z.keys())
        # Read the FULL payload before deciding: corruption can drop the
        # stamp entry from the key list itself.
        arrays = {k: z[k] for k in keys if k != INTEGRITY_KEY}
        if INTEGRITY_KEY not in keys:
            return True
        return int(np.asarray(z[INTEGRITY_KEY])) == payload_crc(arrays)
    except Exception:
        return False  # a payload that cannot even be read is corrupt


def verify_file(path: str) -> bool:
    """True when ``path`` loads cleanly and matches its stamp."""
    try:
        with np.load(path) as z:
            return verify_arrays(z)
    except Exception:
        return False  # torn/truncated/garbage file


def quarantine(path: str) -> str:
    """Rename a corrupt file out of the resume globs (kept for
    forensics); returns the new path.  A repeat offender at the same
    range overwrites the previous quarantined copy."""
    dest = path + ".corrupt"
    os.replace(path, dest)
    return dest


def sweep_chunks(out_dir: str, pattern: str = "chunk_*.npz"
                 ) -> List[Tuple[int, int]]:
    """Verify every chunk file in ``out_dir``; quarantine failures.

    Returns the (lo, hi) ranges quarantined: each is now missing from
    coverage and is fitted again by the orchestrator's retry loop.
    """
    bad: List[Tuple[int, int]] = []
    for path in sorted(glob.glob(os.path.join(out_dir, pattern))):
        if verify_file(path):
            continue
        quarantine(path)
        base = os.path.basename(path)
        stem = base[base.index("_") + 1:-len(".npz")]
        try:
            lo_s, hi_s = stem.split("_")
            bad.append((int(lo_s), int(hi_s)))
        except ValueError:
            continue  # foreign file name matched the glob; just renamed
    return sorted(bad)
