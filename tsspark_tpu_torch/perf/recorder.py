"""Perf telemetry: where the milliseconds of a batched fit go (a copy of
the JAX package's ``perf/recorder.py``).

  * per-dispatch wall time (one ``SegmentRecord`` per dispatch: a solver
    segment, a packed chunk fit, or one full solve);
  * load-vs-execute attribution: ``CompileWatch`` counts what stands in
    for the JAX package's trace compiles in PyTorch, the loads and
    builds of the kernel library (``kernels/build.py`` ``library()``):
    a dispatch that loaded or built it is tainted by that wall time;
  * the live-set width trajectory (``width`` is the dispatched batch
    width, ``live`` the series still unconverged inside it);
  * series/s throughput once a caller supplies the completed count.

The report rides the returned ``FitState`` like ``ResilienceReport``
(``attach_perf``/``get_perf``, the same ``annotate_state`` machinery),
and ``summarize_times`` folds the orchestrator's ``times.jsonl`` rows
into one summary.  Host-side only: recording a segment costs two
``time.perf_counter`` calls and two integer reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SegmentRecord:
    """One recorded dispatch."""

    index: int          # arrival order within the recorder
    kind: str           # "segment" | "chunk" | "fit"
    width: int          # dispatched (padded) batch width
    live: int           # series still unconverged in the dispatch
    wall_s: float       # host wall time around the blocking dispatch
    compile_miss: bool  # the kernel library loaded or built during it

    def to_dict(self) -> Dict:
        return {
            "i": self.index, "kind": self.kind, "width": self.width,
            "live": self.live, "wall_s": round(self.wall_s, 4),
            "compile_miss": self.compile_miss,
        }


class CompileWatch:
    """Kernel-library load/build detector: the port's counterpart of the
    JAX package's compile-cache watch.

    ``size()`` is the number of loads plus builds of the kernel library
    in this process (``kernels/build.py``'s ``loads`` and ``builds``);
    a dispatch that grew it paid the library's load (a few ms) or its
    ``nvcc`` build (a minute or more).  On the CPU nothing loads, so
    nothing is ever tainted.  Unknown or missing counters read as "no
    miss observed": the recorder must never take a fit down.
    """

    def __init__(self, modules: Sequence = (),
                 names: Sequence[str] = ("loads", "builds")):
        self._modules = tuple(modules)
        self._names = tuple(names)

    @classmethod
    def default(cls) -> "CompileWatch":
        """Watch the kernel library every card fit path launches through."""
        from tsspark_tpu_torch.kernels import build

        return cls((build,))

    @classmethod
    def builds_only(cls) -> "CompileWatch":
        """Watch only the library's ``nvcc`` builds (a load from a built
        library, the kernel bank's included, does not count)."""
        from tsspark_tpu_torch.kernels import build

        return cls((build,), names=("builds",))

    def size(self) -> int:
        total = 0
        for mod in self._modules:
            for name in self._names:
                try:
                    total += int(getattr(mod, name, 0))
                except Exception:
                    pass
        return total


@dataclasses.dataclass(frozen=True)
class PerfReport:
    """Aggregated telemetry for one fit (or one recorder lifetime)."""

    segments: Tuple[SegmentRecord, ...] = ()

    @property
    def total_s(self) -> float:
        return sum(s.wall_s for s in self.segments)

    @property
    def compile_s(self) -> float:
        """Wall time of compile-tainted dispatches (upper bound on the
        compile share: the dispatch's execute time is inside it too)."""
        return sum(s.wall_s for s in self.segments if s.compile_miss)

    @property
    def execute_s(self) -> float:
        return sum(s.wall_s for s in self.segments if not s.compile_miss)

    @property
    def compile_misses(self) -> int:
        return sum(1 for s in self.segments if s.compile_miss)

    @property
    def widths(self) -> Tuple[int, ...]:
        """Dispatched width trajectory (the compaction ladder, in order)."""
        return tuple(s.width for s in self.segments)

    def series_per_s(self, n_series: int) -> float:
        t = self.total_s
        return n_series / t if t > 0 else 0.0

    def to_dict(self, n_series: Optional[int] = None) -> Dict:
        d = {
            "segments": [s.to_dict() for s in self.segments],
            "n_dispatches": len(self.segments),
            "total_s": round(self.total_s, 4),
            "compile_s": round(self.compile_s, 4),
            "execute_s": round(self.execute_s, 4),
            "compile_misses": self.compile_misses,
            "width_min": min(self.widths) if self.segments else 0,
            "width_max": max(self.widths) if self.segments else 0,
        }
        if n_series is not None:
            d["series_per_s"] = round(self.series_per_s(n_series), 2)
        return d


class PerfRecorder:
    """Accumulates SegmentRecords across dispatches (and across chunks:
    one recorder on a backend sees every chunk of every fit it serves)."""

    def __init__(self, watch: Optional[CompileWatch] = None):
        self._watch = watch if watch is not None else CompileWatch.default()
        self._segments: List[SegmentRecord] = []

    @contextlib.contextmanager
    def dispatch(self, width: int, live: Optional[int] = None,
                 kind: str = "segment") -> Iterator[None]:
        """Time one blocking dispatch (the body must wait for the device,
        or the wall time measures only the enqueue)."""
        snap = self._watch.size()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            self._segments.append(SegmentRecord(
                index=len(self._segments), kind=kind, width=int(width),
                live=int(width if live is None else live),
                wall_s=wall, compile_miss=self._watch.size() > snap,
            ))

    def record(self, width: int, wall_s: float, live: Optional[int] = None,
               kind: str = "segment", compile_miss: bool = False) -> None:
        """Append a pre-timed record (for callers that already own the
        clock, e.g. the orchestrator's per-chunk timing)."""
        self._segments.append(SegmentRecord(
            index=len(self._segments), kind=kind, width=int(width),
            live=int(width if live is None else live),
            wall_s=float(wall_s), compile_miss=bool(compile_miss),
        ))

    def report(self) -> PerfReport:
        return PerfReport(segments=tuple(self._segments))


# ---------------------------------------------------------------------------
# FitState annotation (the ResilienceReport pattern)
# ---------------------------------------------------------------------------

def attach_perf(state, report: PerfReport):
    """Annotate ``state`` with ``report`` as a ``.perf`` attribute (same
    derived-class trick as ``resilience.report.attach_report``; composes
    with an attached resilience report — both attributes survive)."""
    from tsspark_tpu_torch.resilience.report import annotate_state

    return annotate_state(state, "perf", report)


def get_perf(state) -> Optional[PerfReport]:
    """The ``PerfReport`` attached to ``state``, or None."""
    return getattr(state, "perf", None)


# ---------------------------------------------------------------------------
# times.jsonl -> one summary block
# ---------------------------------------------------------------------------

def summarize_times(times: Sequence[Dict],
                    autotune: Optional[Dict] = None) -> Dict:
    """A run's perf summary from the orchestrator's fit workers'
    ``times.jsonl`` rows (tolerates rows that lack the telemetry
    fields).

    ``autotune``: the persisted ``autotune.json`` payload, embedded
    verbatim so the summary carries the learned chunk size alongside
    the throughput it bought.
    """
    chunks = [t for t in times if "fit_s" in t]
    per_size: Dict[int, List[float]] = {}
    for t in chunks:
        size = int(t.get("width", t.get("chunk", 0)) or 0)
        sps = t.get("series_per_s")
        if sps is None and t.get("fit_s"):
            sps = (t["hi"] - t["lo"]) / t["fit_s"]
        if size and sps:
            per_size.setdefault(size, []).append(float(sps))
    out = {
        "n_chunks": len(chunks),
        "first_flush_s": next(
            (round(float(t["t"]), 2) for t in chunks if "t" in t), None
        ),
        "compile_misses": sum(
            1 for t in chunks if t.get("compile_miss")
        ),
        "chunk_sizes": sorted(per_size),
        "series_per_s_by_size": {
            str(k): round(sum(v) / len(v), 2)
            for k, v in sorted(per_size.items())
        },
        "segments": [
            {k: t[k] for k in
             ("lo", "hi", "width", "live", "fit_s", "series_per_s",
              "compile_miss", "t") if k in t}
            for t in chunks
        ],
    }
    if autotune:
        out["autotune"] = autotune
    return out
