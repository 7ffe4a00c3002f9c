"""The learned chunk width of the JAX package's online chunk autotuner.

The streaming driver's one use of ``perf/autotune.py``: a driver pointed
at a completed run's ``autotune.json`` (``{"chunk": N, ...}``) sizes its
refit chunks from that run's measured throughput instead of a static
default.  The tuner itself (``ChunkAutotuner``) comes with the port's
orchestrator.
"""

from __future__ import annotations

import json
from typing import Optional


def load_learned_chunk(state_path: str) -> Optional[int]:
    """The persisted learned chunk size, or None (absent/corrupt file)."""
    try:
        with open(state_path) as fh:
            return int(json.load(fh)["chunk"]) or None
    except (OSError, ValueError, TypeError, KeyError):
        return None
