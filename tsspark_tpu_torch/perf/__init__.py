"""Perf telemetry and online tuning of the port (copies of the JAX
package's ``perf`` modules).

* ``recorder`` — per-dispatch telemetry (wall, width, kernel-library
  load/build, series/s) attached to ``FitState`` like the resilience
  report, and ``summarize_times`` over the orchestrator's ``times.jsonl``.
* ``autotune`` — online pow-2 chunk-size hill climber with persisted
  state, consumed by ``orchestrate.fit_worker`` and the streaming
  driver's warm start.

Importing this package stays light (stdlib only); the kernel build
module loads only when ``CompileWatch.default()`` is called.
"""

from tsspark_tpu_torch.perf.autotune import (
    ChunkAutotuner,
    load_learned_chunk,
)
from tsspark_tpu_torch.perf.recorder import (
    CompileWatch,
    PerfRecorder,
    PerfReport,
    SegmentRecord,
    attach_perf,
    get_perf,
    summarize_times,
)

__all__ = [
    "ChunkAutotuner",
    "CompileWatch",
    "PerfRecorder",
    "PerfReport",
    "SegmentRecord",
    "attach_perf",
    "get_perf",
    "load_learned_chunk",
    "summarize_times",
]
