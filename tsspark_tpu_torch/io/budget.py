"""``DiskBudget``: byte accounting per storage root, consulted before
every version-producing write.

The port's copy of the JAX package's module of the same name; its
planes consult it today, the scheduler and pool of later slices will.

The always-on refit loop publishes versions forever; on a real
deployment the first fault it meets is a full disk.  A budget bounds
one storage root (a registry, a scratch dir) to a byte ceiling and
reports *headroom* — the fraction of room left, taking the tighter of
the configured budget and the filesystem's real free space — which the
degradation ladder (``tsspark_tpu_torch.io.ladder``) turns into shed/reap/
pause/stale decisions.

Arming is environment-driven so child processes (refit publishers,
replicas) inherit the same budget the parent armed, exactly like
``TSSPARK_FAULTS``:

  TSSPARK_DISK_BUDGET_BYTES  byte ceiling for the budgeted root
  TSSPARK_DISK_BUDGET_ROOT   the root it governs (required with BYTES)

Unarmed, ``active()`` is a single environ lookup returning None and the
durable-I/O layer skips the gate entirely.
"""

from __future__ import annotations

import errno as _errno
import os
from typing import Dict, Optional

from tsspark_tpu_torch.io.errors import DiskFullError

ENV_BUDGET_BYTES = "TSSPARK_DISK_BUDGET_BYTES"
ENV_BUDGET_ROOT = "TSSPARK_DISK_BUDGET_ROOT"


class DiskBudget:
    """Byte budget for one storage root.

    ``headroom()`` is the governing gauge: fraction of room left in
    [0, 1], the min of budget headroom (1 - used/budget) and the
    filesystem's real free fraction.  ``check(nbytes)`` raises
    ``DiskFullError`` when a prospective write of ``nbytes`` would
    overrun — same errno a real ENOSPC carries, so callers classify
    both identically."""

    def __init__(self, root: str, budget_bytes: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self._m_headroom = None
        self._m_used = None

    # -- accounting --------------------------------------------------------

    def used_bytes(self) -> int:
        """Bytes currently under the root (hardlinked copy-forward
        columns count once per inode would be ideal; the walk counts
        per-path, which over-counts links — the CONSERVATIVE direction
        for a budget)."""
        total = 0
        for d, _sub, names in os.walk(self.root):
            for name in names:
                try:
                    total += os.lstat(os.path.join(d, name)).st_size
                except OSError:
                    continue  # racing unlink (a reaper, a temp sweep)
        return total

    def fs_headroom(self) -> float:
        """The filesystem's own free fraction under the root."""
        try:
            st = os.statvfs(self.root)
        except OSError:
            return 1.0  # root not there yet: nothing written, all room
        if st.f_blocks <= 0:
            return 1.0
        return max(0.0, min(1.0, st.f_bavail / st.f_blocks))

    def headroom(self) -> float:
        """Fraction of room left in [0, 1] — min of budget and real
        filesystem headroom.  Also publishes the ``io.*`` gauges."""
        fs = self.fs_headroom()
        if self.budget_bytes and self.budget_bytes > 0:
            used = self.used_bytes()
            frac = max(0.0, min(1.0, 1.0 - used / self.budget_bytes))
        else:
            used = None
            frac = 1.0
        h = min(fs, frac)
        self._publish_gauges(h, used)
        return h

    def check(self, nbytes: int = 0, what: str = "") -> None:
        """Gate a prospective write of ``nbytes`` under this root;
        raises ``DiskFullError`` (errno ENOSPC) on overrun."""
        if not self.budget_bytes or self.budget_bytes <= 0:
            return
        used = self.used_bytes()
        if used + max(0, int(nbytes)) > self.budget_bytes:
            self._publish_gauges(
                max(0.0, 1.0 - used / self.budget_bytes), used)
            raise DiskFullError(
                _errno.ENOSPC,
                f"disk budget exhausted for {self.root} "
                f"({used}+{nbytes} > {self.budget_bytes} bytes"
                + (f"; {what}" if what else "") + ")",
            )

    def governs(self, path: str) -> bool:
        """True when ``path`` lives under the budgeted root."""
        p = os.path.abspath(path)
        return p == self.root or p.startswith(self.root + os.sep)

    # -- obs ----------------------------------------------------------------

    def _publish_gauges(self, headroom: float,
                        used: Optional[int]) -> None:
        try:
            from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

            if self._m_headroom is None:
                self._m_headroom = METRICS.gauge(
                    "tsspark_io_budget_headroom")
                self._m_used = METRICS.gauge(
                    "tsspark_io_budget_used_bytes")
            self._m_headroom.set(float(headroom))
            if used is not None:
                self._m_used.set(float(used))
        except Exception:
            pass  # obs must never break an I/O path


_active_cache: Dict[str, Optional[DiskBudget]] = {}


def active() -> Optional[DiskBudget]:
    """The environment-armed budget for this process tree, or None.
    Cached per (root, bytes) env pair — the unarmed path is one
    environ lookup."""
    spec = os.environ.get(ENV_BUDGET_BYTES)
    if not spec:
        return None
    root = os.environ.get(ENV_BUDGET_ROOT)
    if not root:
        return None
    key = f"{root}\x00{spec}"
    if key not in _active_cache:
        try:
            _active_cache[key] = DiskBudget(root, int(spec))
        except (ValueError, TypeError):
            _active_cache[key] = None  # malformed: fail open
    return _active_cache[key]


def arm(root: str, budget_bytes: int,
        env: Optional[Dict[str, str]] = None) -> DiskBudget:
    """Arm a budget for this process tree (``os.environ`` default) —
    the test/chaos entry point, mirroring ``FaultPlan.install``."""
    target = os.environ if env is None else env
    target[ENV_BUDGET_BYTES] = str(int(budget_bytes))
    target[ENV_BUDGET_ROOT] = os.path.abspath(root)
    return DiskBudget(root, budget_bytes)
