"""Resilience reporting: what a resilient fit survived, on the FitState
(a copy of the JAX package's ``resilience/report.py``).

A million-series resilient fit can complete while still having a story
to tell: series quarantined as poison, chunk files quarantined as
corrupt, a degradation to the CPU backend, semantic-switch warnings from
the resilient gate.  That story rides the returned ``FitState`` as a
``.resilience`` attribute (``get_report``/``attach_report``) — a plain
subclass trick: the annotated state IS a ``FitState`` (same tuple, same
tuple), and the attribute is best-effort metadata that a rebuilt tuple
(``_replace``, a row slice) drops.

``STATUS_QUARANTINED`` extends the solver's per-series termination codes
(ops/lbfgs.STATUS_*, 0-4): a quarantined series carries NaN parameters,
``converged=False``, and this status, so downstream consumers can mask
it without parsing the report.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Per-series status code for quarantined rows.  Deliberately far from
#: the solver's own 0-4 range (ops/lbfgs.STATUS_*): it marks a series
#: the solver never (successfully) ran on.
STATUS_QUARANTINED = 100


class ResilienceWarning(UserWarning):
    """Loud-but-nonfatal resilience events: CPU degradation, the
    resilient gate overriding rescue/length_buckets semantics."""


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One quarantined series: its batch row index and why."""

    index: int
    reason: str


@dataclasses.dataclass(frozen=True)
class ResilienceReport:
    """What a resilient fit survived (attached via ``attach_report``)."""

    quarantined: Tuple[QuarantineRecord, ...] = ()
    corrupt_chunks: Tuple[Tuple[int, int], ...] = ()
    warnings: Tuple[str, ...] = ()
    degraded_to_cpu: bool = False
    retries: int = 0

    def with_warning(self, msg: str) -> "ResilienceReport":
        return dataclasses.replace(self, warnings=self.warnings + (msg,))

    @property
    def quarantined_indices(self) -> Tuple[int, ...]:
        return tuple(r.index for r in self.quarantined)


def annotate_state(state, attr: str, value):
    """Return ``state`` annotated with ``value`` as attribute ``attr``.

    The result is a dynamically-derived instance of ``type(state)`` —
    field-for-field the same tuple (NamedTuple subclasses keep
    ``_replace``/``_fields``), plus the attribute.  Rebuilding the tuple
    drops the attribute; callers who need it keep the original
    reference.

    The annotation machinery is shared: the resilience report rides as
    ``.resilience`` (``attach_report``) and the perf telemetry as
    ``.perf`` (``tsspark_tpu_torch.perf.attach_perf``) on the SAME generated
    class, so attaching one never drops the other.
    """
    # Re-annotating an annotated state (add_warning on a fit_resilient
    # result, attach_perf on an annotated state) must reuse the SAME
    # generated class, never subclass it again — hence the
    # _resilience_base marker.
    base = getattr(type(state), "_resilience_base", type(state))
    annotated_cls = _annotated_types.get(base)
    if annotated_cls is None:
        annotated_cls = type(base.__name__, (base,), {
            "_resilience_base": base,
            # The generated class is not an importable module attribute,
            # so pickle must rebuild the BASE type (a Spark transfer or
            # multiprocessing queue of the state keeps working; the
            # report is dropped).
            "__reduce__": lambda self: (
                type(self)._resilience_base, tuple(self)
            ),
        })
        _annotated_types[base] = annotated_cls
    out = annotated_cls(*state)
    # Carry annotations already riding ``state`` forward so attaching a
    # second kind (perf after resilience, or vice versa) composes.
    for k, v in vars(state).items() if hasattr(state, "__dict__") else ():
        setattr(out, k, v)
    setattr(out, attr, value)
    return out


def attach_report(state, report: ResilienceReport):
    """Return ``state`` annotated with ``report`` (see annotate_state)."""
    return annotate_state(state, "resilience", report)


_annotated_types: dict = {}


def get_report(state) -> Optional[ResilienceReport]:
    """The ``ResilienceReport`` attached to ``state``, or None."""
    return getattr(state, "resilience", None)


def add_warning(state, msg: str):
    """Annotate ``state`` with one more warning (creating or extending
    its report)."""
    report = get_report(state) or ResilienceReport()
    return attach_report(state, report.with_warning(msg))
