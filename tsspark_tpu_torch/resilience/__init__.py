"""Resilience subsystem of the port: the retry policy, deterministic fault
injection, checkpoint integrity and quarantine reporting (copies of the
JAX package's modules, with its names).

  policy.py    — ``RetryPolicy`` (attempts, backoff with deterministic
                 jitter, per-attempt deadlines, a total budget) and
                 ``CircuitBreaker``; the orchestrator's ``WORKER_RETRY``
                 and ``PROBE`` schedules.
  faults.py    — ``FaultPlan`` / ``inject``: env-driven, deterministic
                 fault injection at named points (worker spawn, device
                 probe, chunk save, chunk fit, the io layer, the
                 streaming poll), so every recovery path runs on the CPU.
  integrity.py — CRC32 payload stamps in every chunk/prep npz; corrupt or
                 torn files are quarantined (``*.corrupt``) and their
                 ranges re-queued.
  report.py    — ``ResilienceReport`` attached to the ``FitState`` a
                 resilient fit returns.
"""

from tsspark_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    inject,
)
from tsspark_tpu_torch.resilience.integrity import ChunkIntegrityError
from tsspark_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpen,
    RetryPolicy,
)
from tsspark_tpu_torch.resilience.report import (
    STATUS_QUARANTINED,
    QuarantineRecord,
    ResilienceReport,
    ResilienceWarning,
    add_warning,
    attach_report,
    get_report,
)

__all__ = [
    "ChunkIntegrityError",
    "CircuitBreaker",
    "CircuitOpen",
    "FaultInjected",
    "FaultPlan",
    "QuarantineRecord",
    "ResilienceReport",
    "ResilienceWarning",
    "RetryPolicy",
    "STATUS_QUARANTINED",
    "add_warning",
    "attach_report",
    "get_report",
    "inject",
]
