"""Process-memory introspection for the one-physical-copy accounting (the
port's copy of the JAX package's ``utils/procmem.py``).

The snapshot plane's whole claim is that N serving processes map ONE
page-cache copy of the active version instead of N private heaps —
plain ``VmRSS`` cannot show that (shared file-backed pages count fully
in every mapper's RSS), so ``ReplicaPool.stats``
reads the kernel's sharing-aware counters instead:

* ``RssAnon`` (``/proc/<pid>/status``) — private anonymous heap: where
  an npz snapshot lives, per process;
* ``Pss`` (``/proc/<pid>/smaps_rollup``) — proportional set size:
  shared pages divided by their mapper count, so the pool-wide sum
  counts each physical page once;
* per-mapping ``Rss``/``Pss`` filtered by path fragment
  (``/proc/<pid>/smaps``) — the resident cost attributable to the
  snapshot plane's ``snapcol_`` mappings specifically.

Where ``/proc/<pid>/status`` has no ``RssAnon`` / ``RssFile`` or there is
no ``smaps_rollup`` (a sandboxed kernel's procfs may keep only ``VmRSS``
and the per-mapping ``smaps``), ``proc_mem`` sums the same counters over
``/proc/<pid>/smaps``: ``Anonymous`` for the anonymous resident bytes,
``Rss`` less ``Anonymous`` for the file-backed ones, and ``Pss``.

Device-free and dependency-free (reads procfs only); every reader
degrades to ``None`` fields off-Linux.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def _kb_fields(path: str, wanted) -> Dict[str, float]:
    out: Dict[str, float] = {}
    try:
        with open(path) as fh:
            for line in fh:
                key = line.split(":", 1)[0]
                if key in wanted:
                    out[key] = float(line.split()[1]) / 1024.0  # kB->MB
    except (OSError, ValueError, IndexError):
        pass
    return out


def proc_mem(pid: Optional[int] = None) -> Dict[str, Optional[float]]:
    """{"rss_mb", "rss_anon_mb", "rss_file_mb", "pss_mb"} for ``pid``
    (default: this process), in MB; missing counters are None."""
    pid = os.getpid() if pid is None else int(pid)
    status = _kb_fields(f"/proc/{pid}/status",
                        ("VmRSS", "RssAnon", "RssFile"))
    rollup = _kb_fields(f"/proc/{pid}/smaps_rollup", ("Pss",))
    if "RssAnon" not in status or "Pss" not in rollup:
        summed = _smaps_sums(pid)
        if "Anonymous" in summed and "RssAnon" not in status:
            status["RssAnon"] = summed["Anonymous"]
            if "Rss" in summed:
                status.setdefault(
                    "RssFile", max(0.0, summed["Rss"] - summed["Anonymous"]))
        if "Pss" in summed:
            rollup.setdefault("Pss", summed["Pss"])
    return {
        "rss_mb": status.get("VmRSS"),
        "rss_anon_mb": status.get("RssAnon"),
        "rss_file_mb": status.get("RssFile"),
        "pss_mb": rollup.get("Pss"),
    }


def _smaps_sums(pid: int) -> Dict[str, float]:
    """{"Rss", "Pss", "Anonymous"} summed over every mapping of
    ``/proc/<pid>/smaps``, in MB; a counter the file lacks is absent."""
    wanted = ("Rss", "Pss", "Anonymous")
    out: Dict[str, float] = {}
    try:
        with open(f"/proc/{pid}/smaps") as fh:
            for line in fh:
                key = line.split(":", 1)[0]
                if key in wanted:
                    out[key] = out.get(key, 0.0) + float(
                        line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        return {}
    return out


def mapped_file_mem(pid: Optional[int] = None,
                    marker: str = "snapcol_"
                    ) -> Dict[str, Optional[float]]:
    """Resident cost of ``pid``'s file mappings whose path contains
    ``marker``: {"rss_mb", "pss_mb", "n_mappings"}.  Summing ``pss_mb``
    across a pool counts every shared physical page exactly once — the
    measured numerator of the snapshot plane's RSS-reduction claim."""
    pid = os.getpid() if pid is None else int(pid)
    rss = pss = 0.0
    n = 0
    seen_any = False
    current_match = False
    try:
        with open(f"/proc/{pid}/smaps") as fh:
            for line in fh:
                if "-" in line.split(" ", 1)[0] and ":" not in \
                        line.split(" ", 1)[0]:
                    # Mapping header line ("<lo>-<hi> perms off dev ...").
                    current_match = marker in line
                    n += current_match
                    continue
                if not current_match:
                    continue
                if line.startswith("Rss:"):
                    rss += float(line.split()[1]) / 1024.0
                    seen_any = True
                elif line.startswith("Pss:"):
                    pss += float(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        return {"rss_mb": None, "pss_mb": None, "n_mappings": 0}
    return {
        "rss_mb": round(rss, 3) if seen_any or n == 0 else None,
        "pss_mb": round(pss, 3) if seen_any or n == 0 else None,
        "n_mappings": n,
    }
