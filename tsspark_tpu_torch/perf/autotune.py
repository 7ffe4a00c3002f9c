"""Online chunk-size autotuner: find the throughput-optimal batch width
(a copy of the JAX package's ``perf/autotune.py``).

The right chunk size is a property of the runtime, one the parent cannot
observe up front, so it is learned online:

  * start SMALL (``floor``, default 128) so the first chunk file lands
    within seconds;
  * after each chunk, record series/s for its size and hill-climb along
    the power-of-2 ladder: explore the next size up once the current
    one has a warm measurement, move toward whichever neighbour measures
    better, stay put at a local optimum;
  * samples taken while the kernel library loaded or built never drive a
    decision (``perf.CompileWatch``: the port's stand-in for the JAX
    package's compile misses);
  * persist the learned state (``autotune.json``, atomic) next to the
    run's chunk files so a resumed run, or the streaming driver via
    ``load_learned_chunk``, starts at the learned width.

Chunk width only regroups series into lockstep batches (row-local math),
so tuning is throughput-only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from tsspark_tpu_torch.utils.atomic import atomic_write_text

# A neighbor must beat the incumbent by this factor to pull the tuner
# over: chunk-to-chunk throughput noise (data-dependent convergence,
# host jitter) is well above 1%, and oscillating between two near-equal
# sizes would pay gratuitous compile churn on any new runtime.
_HYSTERESIS = 1.05
# Per-size sample window for the throughput estimate: recent samples
# only, so a one-off slow chunk (GC pause, probe overlap) ages out.
_WINDOW = 4


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ChunkAutotuner:
    """Hill-climbing pow-2 chunk-size tuner (see module docstring).

    ``cap`` is the largest size the caller trusts (the fixed chunk);
    ``floor`` the smallest worth dispatching.  ``state_path=None`` keeps
    the tuner in-memory (tests, streaming).

    ``multiple``: every size the tuner emits is at least this and (for
    a power-of-two multiple) divisible by it — the shard-width hook of a
    mesh-resident path: a wave must divide evenly across the series
    shards.  The ladder stays pow-2, so a pow-2 ``multiple`` composes
    exactly; a non-pow-2 one only floors the ladder.
    """

    def __init__(self, cap: int, floor: int = 128,
                 state_path: Optional[str] = None,
                 start: Optional[int] = None,
                 multiple: int = 1):
        self.cap = max(1, int(cap))
        self.multiple = max(1, int(multiple))
        self.floor = max(1, min(max(int(floor), self.multiple), self.cap))
        self.state_path = state_path
        self._samples: Dict[int, List[float]] = {}
        size = self.floor if start is None else int(start)
        self._cur = min(max(_next_pow2(size), self.floor), self.cap)

    # -- persistence -------------------------------------------------------

    @classmethod
    def load(cls, state_path: str, cap: int,
             floor: int = 128, multiple: int = 1) -> "ChunkAutotuner":
        """Tuner warm-started from a persisted state file (fresh tuner
        when the file is absent/corrupt — the state is pure cache)."""
        start = None
        samples: Dict[int, List[float]] = {}
        try:
            with open(state_path) as fh:
                d = json.load(fh)
            # AttributeError covers valid-JSON-but-not-a-dict payloads
            # (d.get on a list/str): the state is pure cache, and ANY
            # unreadable form must yield a fresh tuner, never a
            # crash-looping fit worker.
            # A resumed tuner continues from the exploration CURSOR when
            # recorded (older files carry only the measured-best
            # "chunk", which is the right fallback).
            start = int(d.get("cursor", 0) or d.get("chunk", 0)) or None
            samples = {
                int(k): [float(x) for x in v][-_WINDOW:]
                for k, v in d.get("series_per_s", {}).items()
            }
        except (OSError, ValueError, TypeError, AttributeError):
            pass
        tuner = cls(cap=cap, floor=floor, state_path=state_path,
                    start=start, multiple=multiple)
        tuner._samples = {
            k: v for k, v in samples.items()
            if tuner.floor <= k <= tuner.cap
        }
        return tuner

    def save(self) -> None:
        if self.state_path is None:
            return
        payload = json.dumps({
            # "chunk" is the MEASURED-BEST width — what every external
            # consumer (streaming warm start, load_learned_chunk) wants;
            # "cursor" is the hill-climber's
            # own next-dispatch position, which may be an unexplored
            # rung mid-exploration.
            "chunk": self.best_size,
            "cursor": self._cur,
            "series_per_s": {
                str(k): [round(x, 3) for x in v]
                for k, v in sorted(self._samples.items())
            },
            "updated": time.time(),
        })
        try:
            atomic_write_text(self.state_path, payload + "\n")
        except OSError:
            pass  # the state is cache; a full disk must not kill the fit

    # -- the online loop ---------------------------------------------------

    def next_size(self) -> int:
        """The chunk size the next dispatch should use."""
        return self._cur

    def throughput(self, size: int) -> Optional[float]:
        """Mean warm series/s for ``size`` (None until warm-sampled)."""
        v = self._samples.get(size)
        return sum(v) / len(v) if v else None

    @property
    def best_size(self) -> int:
        """Highest-throughput warm-sampled size (current size when none
        is warm yet) — what phase-2 style followers should dispatch at."""
        if not self._samples:
            return self._cur
        return max(self._samples, key=lambda k: self.throughput(k) or 0.0)

    def record(self, size: int, n_series: int, wall_s: float,
               compile_miss: bool = False) -> None:
        """Fold one chunk's measurement in and re-decide the next size."""
        size = int(size)
        if wall_s <= 0 or n_series <= 0:
            return
        if not compile_miss:
            window = self._samples.setdefault(size, [])
            window.append(n_series / wall_s)
            del window[:-_WINDOW]
            self._decide()
        self.save()

    def _decide(self) -> None:
        cur_tp = self.throughput(self._cur)
        if cur_tp is None:
            return  # no warm sample at the current size yet: hold
        up, down = self._cur * 2, self._cur // 2
        up_tp = self.throughput(up) if up <= self.cap else None
        down_tp = self.throughput(down) if down >= self.floor else None
        if (up <= self.cap and up_tp is None
                and (down_tp is None or cur_tp >= down_tp)):
            # Explore upward while the climb is still paying: the ladder
            # starts at the floor, so the unexplored direction with
            # headroom is always up — but a size that already measures
            # worse than its lower neighbor must not climb further.
            self._cur = up
        elif up_tp is not None and up_tp > cur_tp * _HYSTERESIS:
            self._cur = up
        elif down_tp is not None and down_tp > cur_tp * _HYSTERESIS:
            self._cur = down


def load_learned_chunk(state_path: str) -> Optional[int]:
    """The persisted learned chunk size, or None (absent/corrupt file).
    The streaming driver's warm start: a driver pointed at a completed
    run's ``autotune.json`` sizes its refit chunks from measured
    throughput instead of a static default."""
    try:
        with open(state_path) as fh:
            return int(json.load(fh)["chunk"]) or None
    except (OSError, ValueError, TypeError, KeyError):
        return None
