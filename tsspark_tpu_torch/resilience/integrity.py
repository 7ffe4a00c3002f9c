"""Checkpoint integrity: a CRC32 of an npz payload, stamped in the file.

The same stamp as the JAX package's (``integrity_crc``, a CRC32 over the
name, dtype, shape and bytes of every array in name order), so each
package verifies snapshots the other wrote.  Files without a stamp pass:
np.load's zip CRCs already vouch for their bytes.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

INTEGRITY_KEY = "integrity_crc"


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
