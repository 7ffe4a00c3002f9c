"""Wall-clock spans per named stage, summed over calls.

The serving path's layers time their own stages with one of these, so a
profile reads where a request's host time went from the code that ran,
not from a copy of it::

    clock = StageClock()
    with clock.span("prep"):
        ...
    clock.seconds   # {"prep": 0.0123}

A span costs two ``time.perf_counter`` calls.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class StageClock:
    """Seconds and call counts per stage since the last ``reset``."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
