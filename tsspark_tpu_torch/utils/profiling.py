"""Profiling hooks: ``torch.profiler`` trace capture and wall-clock timers
(the port's copy of the JAX package's ``utils/profiling.py``).

``trace(logdir)`` records the CPU and, where there is a card, the CUDA
activity of a block into a Chrome trace under ``logdir``; ``annotate``
names a region on that timeline (``torch.profiler.record_function``).
``Timers`` aggregate named wall-clock sections (the host's view; device
work is in the trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a profiler trace of the block into ``logdir`` (no-op when
    None): ``logdir/trace_<pid>.json``, readable by chrome://tracing or
    Perfetto."""
    if logdir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)


class Timers:
    """Accumulating named wall-clock timers (host side)."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        # Monotonic: a wall-clock adjustment mid-section must not land a
        # negative (or inflated) duration in the aggregate.
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._total[name] += time.monotonic() - t0
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self._total[k], 4),
                "count": self._count[k],
                "mean_s": round(self._total[k] / max(self._count[k], 1), 4),
            }
            for k in sorted(self._total)
        }
