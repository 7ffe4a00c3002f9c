"""Disk-pressure degradation ladder: shed → reap → pause → stale-serve.

The port's copy of the JAX package's module of the same name; its
planes consult it today, the scheduler and pool of later slices will.

A service meeting disk pressure must degrade in the order that
sacrifices the least first.  Driven by ``DiskBudget.headroom()``:

  state          enter below   gives up
  -----          -----------   --------
  normal         —             nothing
  shed_spec      0.40          speculative warm refit prep (sched skips
                               ``_refresh_speculation``; cheapest, pure
                               cache loss)
  reap           0.25          retained history beyond the safety floor
                               (``refit.reap_cycles`` runs eagerly; never
                               the active version or a pinned plan's base
                               — see tests/test_retention.py)
  pause_ingest   0.10          freshness: ``land_delta`` raises
                               ``BackpressureError``, upstream sources
                               hold their deltas
  stale_serve    0.05          recency honesty: the pool keeps serving
                               the last good version but flags responses
                               and ``stats()`` as stale

Transitions are recomputed from headroom on every ``state()`` call with
upward hysteresis (climbing back toward normal requires clearing the
entry threshold by ``hysteresis``), so a root oscillating around one
threshold does not flap the ladder.

Module-level helpers (``current_state``, ``gate_ingest``,
``stale_serving``) resolve the environment-armed budget so call sites in
``data/plane.py`` / ``sched.py`` / ``serve/pool.py`` stay one-liners and
cost one environ lookup when no budget is armed.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tsspark_tpu_torch.io import budget as _budget
from tsspark_tpu_torch.io.errors import BackpressureError

#: Ladder states, mildest first; index = severity rank.
LADDER_STATES = ("normal", "shed_spec", "reap", "pause_ingest",
                 "stale_serve")

#: Default entry thresholds (headroom fraction BELOW which the state is
#: entered), aligned with LADDER_STATES[1:].
DEFAULT_THRESHOLDS = (0.40, 0.25, 0.10, 0.05)


class DegradationLadder:
    """Headroom → ladder state, with upward hysteresis."""

    def __init__(self, budget: _budget.DiskBudget, *,
                 thresholds=DEFAULT_THRESHOLDS,
                 hysteresis: float = 0.02):
        if len(thresholds) != len(LADDER_STATES) - 1:
            raise ValueError("one threshold per non-normal state")
        if list(thresholds) != sorted(thresholds, reverse=True):
            raise ValueError("thresholds must descend with severity")
        self.budget = budget
        self.thresholds = tuple(float(t) for t in thresholds)
        self.hysteresis = float(hysteresis)
        self._rank = 0
        self._lock = threading.Lock()
        self._m_state = None

    def _rank_for(self, headroom: float) -> int:
        rank = 0
        for i, t in enumerate(self.thresholds):
            if headroom < t:
                rank = i + 1
        return rank

    def state(self) -> str:
        """Recompute and return the current state.  Worsening applies
        immediately; improving requires clearing the previous state's
        entry threshold by the hysteresis margin."""
        h = self.budget.headroom()
        raw = self._rank_for(h)
        with self._lock:
            if raw >= self._rank:
                self._rank = raw
            else:
                # Improving: only step down when headroom clears the
                # CURRENT state's entry threshold with margin.
                enter = self.thresholds[self._rank - 1]
                if h >= enter + self.hysteresis:
                    self._rank = raw
            rank = self._rank
        self._publish_gauge(rank)
        return LADDER_STATES[rank]

    def rank(self) -> int:
        """Severity index of ``state()`` (0 = normal)."""
        return LADDER_STATES.index(self.state())

    def allows(self, action: str) -> bool:
        """Flow-control queries the wired subsystems ask:
        ``speculate`` (sched warm prep), ``ingest`` (delta landing)."""
        r = self.rank()
        if action == "speculate":
            return r < LADDER_STATES.index("shed_spec")
        if action == "ingest":
            return r < LADDER_STATES.index("pause_ingest")
        raise ValueError(f"unknown ladder action {action!r}")

    def should_reap(self) -> bool:
        return self.rank() >= LADDER_STATES.index("reap")

    def stale_serve(self) -> bool:
        return self.rank() >= LADDER_STATES.index("stale_serve")

    def _publish_gauge(self, rank: int) -> None:
        try:
            from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

            if self._m_state is None:
                self._m_state = METRICS.gauge("tsspark_io_ladder_state")
            self._m_state.set(float(rank))
        except Exception:
            pass


_ladders: Dict[str, DegradationLadder] = {}
_ladders_lock = threading.Lock()


def active_ladder(root: Optional[str] = None
                  ) -> Optional[DegradationLadder]:
    """The ladder over the environment-armed budget, or None when no
    budget is armed (the common, zero-cost case).  ``root``: when
    given, only return the ladder if the budget governs that path —
    pressure on the registry root must not pause an unrelated data
    root."""
    b = _budget.active()
    if b is None:
        return None
    if root is not None and not b.governs(root):
        return None
    key = f"{b.root}\x00{b.budget_bytes}"
    with _ladders_lock:
        lad = _ladders.get(key)
        if lad is None:
            lad = DegradationLadder(b)
            _ladders[key] = lad
    return lad


def current_state(root: Optional[str] = None) -> str:
    """Ladder state for ``root`` ("normal" when nothing is armed)."""
    lad = active_ladder(root)
    return "normal" if lad is None else lad.state()


def gate_ingest(root: str) -> None:
    """Backpressure gate for delta landing: raises
    ``BackpressureError`` at ``pause_ingest`` or worse."""
    lad = active_ladder(root)
    if lad is None:
        return
    if not lad.allows("ingest"):
        raise BackpressureError(lad.state(), lad.budget.headroom())


def stale_serving(root: Optional[str] = None) -> bool:
    """True when responses from ``root``'s registry should carry the
    staleness flag."""
    lad = active_ladder(root)
    return lad is not None and lad.stale_serve()
