"""Always-on refit scheduler: the ingest -> fit -> publish -> serve loop as
a daemon with a data-to-forecast freshness measure (the port's copy of the
JAX package's ``sched.py``, with its freshness bench
``run_freshness_bench``).

* **The loop**: ``RefitScheduler`` watches the data plane's ``delta_seq``
  and triggers cycles continuously under a debounce / backoff policy.
  Every cycle rides the refit plan protocol (``refit_plan.json`` pinned at
  detect, chunk flushes landed under leases, copy-forward publish,
  manifest flip), so a scheduler killed at any stage is succeeded by one
  that resumes the pinned plan.  ``sched_state.json`` is advisory
  telemetry, not correctness state.
* **Pipelining**: cycle N+1's detect, spill and warm-cache merge (mmap
  reads) run on the main thread while cycle N's copy-forward publish and
  flip run on the publisher thread (the forecast-plane delta through K1,
  the posterior advance through K3's draw stack and K7).  The fit waits
  for cycle N's publish and for nothing else.  Both threads launch on the
  same device's current stream, so the card runs their kernels in the
  order they were enqueued; a host read of a result synchronizes first.
  Cycle N+1's warm init for rows refit in N comes from N's in-memory
  solution (bitwise what N's plane holds).  A cycle's detect and spill
  hold the landers' lock (``plane.delta_lock``), so the spill is the
  plane exactly at the plan's stamp, whenever deltas land.
* **Speculation**: during idle ticks the scheduler pre-gathers theta for
  the series its arrival model predicts advance next (a per-series
  inter-arrival EWMA off the landed patch stream).  A speculative init is
  bitwise the plane gather it replaces: a latency lever, never a numerics
  input.
* **Freshness**: wall time from a delta's ``deltaok_`` sentinel landing to
  the first request served from a version containing it (or to the flip,
  without a probe), as ``refit.freshness`` spans and
  ``tsspark_sched_freshness*`` metrics.

``device`` and ``mesh`` go to ``refit.fit_changed`` / ``publish_plan`` as
``refit.run_refit`` takes them: ``device`` None is the card (raising
without one), ``"cpu"`` on request; ``mesh`` None takes the default mesh
(every CUDA device; on one card ``run_resident`` falls back to the file
protocol, one worker process a cycle), an explicit ``Mesh`` runs each
cycle's fit resident in this process.
"""


from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch import refit
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.io import (
    StorageError,
    active_ladder,
    atomic_write,
    current_state,
)

#: Advisory scheduler telemetry (cycles, freshness summary, backoff
#: state) — replaced atomically after every cycle so ``obs watch`` and
#: operators never parse a torn record.  Correctness state lives in the
#: refit plan protocol, NOT here: a successor ignores a missing file.
SCHED_STATE_FILE = "sched_state.json"

#: Bounded freshness sample window (the daemon runs indefinitely).
FRESHNESS_WINDOW = 4096

#: A series is data-overdue when no delta arrived for more than this
#: multiple of its EWMA inter-arrival (the ``tsspark_sched_overdue_series``
#: gauge and the alert stream's data-liveness kind share this default).
OVERDUE_K = 3.0


class ArrivalModel:
    """Per-series inter-arrival EWMA off the landed patch stream.

    Every landed delta's (unix, changed rows) updates one EWMA of the
    inter-arrival gap per series; prediction returns the rows most
    OVERDUE (smallest predicted next-arrival time) — the likely-stale
    set the scheduler pre-gathers during idle.  Bounded: the tracked
    set is capped by least-recently-advanced eviction so a million-row
    fleet with uniform churn cannot grow the dicts without bound."""

    def __init__(self, alpha: float = 0.3, max_tracked: int = 65536):
        self.alpha = float(alpha)
        self.max_tracked = int(max_tracked)
        self._last: Dict[int, float] = {}
        self._ewma: Dict[int, float] = {}
        self._seen_seq = 0

    def seen_seq(self) -> int:
        """Highest delta seq already folded in — callers gate their
        patch reads on this so an always-on daemon never re-opens every
        historical patch zip per detect (O(T^2) over its lifetime)."""
        return self._seen_seq

    def note_delta(self, seq: int, unix: float, rows) -> None:
        """Fold one landed delta into the model (idempotent by seq)."""
        if rows is None or int(seq) <= self._seen_seq:
            return
        self._seen_seq = int(seq)
        a = self.alpha
        for r in np.asarray(rows, np.int64).tolist():
            last = self._last.get(r)
            if last is not None:
                dt = max(float(unix) - last, 1e-3)
                prev = self._ewma.get(r)
                self._ewma[r] = (dt if prev is None
                                 else (1.0 - a) * prev + a * dt)
            self._last[r] = float(unix)
        if len(self._last) > self.max_tracked:
            drop = sorted(self._last, key=self._last.get)[
                : len(self._last) - self.max_tracked
            ]
            for r in drop:
                self._last.pop(r, None)
                self._ewma.pop(r, None)

    def predicted_rows(self, cap: int) -> np.ndarray:
        """Up to ``cap`` rows most overdue to advance (smallest
        predicted next-arrival), sorted by row index (the claim-set
        order a refit plan uses).  Only rows with a LEARNED cadence
        (seen advancing at least twice) are predictable — a one-shot
        row has no inter-arrival estimate, and ranking it by the global
        fallback would make every fresh arrival look overdue, burning
        the speculation budget on series that may never recur."""
        if not self._ewma or cap <= 0:
            return np.empty(0, np.int64)
        rows = np.fromiter(self._ewma.keys(), np.int64,
                           count=len(self._ewma))
        dts = np.fromiter(self._ewma.values(), np.float64,
                          count=len(self._ewma))
        last = np.asarray([self._last[int(r)] for r in rows],
                          np.float64)
        due = last + dts
        order = np.argsort(due, kind="stable")
        return np.sort(rows[order[: int(cap)]])

    def overdue_rows(self, now: float, k: float = 3.0) -> Dict[int, float]:
        """Rows whose learned cadence says a delta is OVERDUE: no
        arrival for more than ``k``x the series' EWMA inter-arrival.
        Returns ``{row: seconds overdue beyond the threshold}`` — the
        data-liveness complement to value anomalies (a series that
        stops arriving pages just like one that breaches its interval).
        Like :meth:`predicted_rows`, only rows with a LEARNED cadence
        qualify; a one-shot row has no baseline to be overdue against."""
        out: Dict[int, float] = {}
        now = float(now)
        for r, dt in self._ewma.items():
            gap = now - self._last[r] - float(k) * dt
            if gap > 0.0:
                out[int(r)] = gap
        return out

    def tracked(self) -> int:
        return len(self._last)


def _pct(samples: Sequence[float], q: float) -> Optional[float]:
    if not samples:
        return None
    return round(float(np.percentile(np.asarray(samples, np.float64),
                                     q)), 4)


def _merge_busy(intervals: List[Tuple[float, float]]) -> float:
    """Union length of (t0, t1) wall intervals — the loop's busy time
    with pipeline overlap counted ONCE (two overlapped stages are one
    busy window, not two)."""
    total = 0.0
    cur_hi: Optional[float] = None
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if cur_hi is None or t0 > cur_hi:
            total += t1 - t0
            cur_hi = t1
        elif t1 > cur_hi:
            total += t1 - cur_hi
            cur_hi = t1
    return total


class RefitScheduler:
    """The always-on loop: watch ``delta_seq``, run pipelined refit
    cycles, track freshness.  One instance per (data_dir, registry,
    scratch) — crash recovery is a NEW instance over the same scratch.

    Flip routing mirrors ``refit.run_refit``: ``pool.activate`` when a
    pool is attached, else ``flip_fn(version)``, else
    ``registry.activate`` (``activate=False`` publishes without
    flipping — a front elsewhere owns the flip).

    ``freshness_probe(version) -> served_version`` closes the loop on
    the serving side: after each flip the scheduler probes until a
    request is served at (or past) the new version, and THAT wall time
    stamps the freshness of every delta the version covers.  Without a
    probe (the bare CLI daemon), freshness is measured to flip
    completion and the span says so (``probe="flip"``).

    ``device`` / ``mesh``: where each cycle's fit and publish run (see the
    module docstring); the run summary's ``fit_path`` names the path the
    last cycle's fit took (``"resident"`` or the file-protocol fallback)."""

    def __init__(
        self,
        data_dir: str,
        registry,
        scratch: str,
        *,
        chunk: int = 512,
        solver_config=None,
        phase1_iters: int = 0,
        no_phase1_tune: bool = True,
        warm_start: bool = True,
        pool=None,
        flip_fn: Optional[Callable[[int], None]] = None,
        activate: bool = True,
        hot_series: Optional[Sequence[str]] = None,
        horizons: Sequence[int] = (7, 14),
        poll_s: float = 0.05,
        debounce_s: float = 0.1,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        pipeline: bool = True,
        speculate: bool = True,
        spec_refresh_s: float = 0.5,
        spec_cap: Optional[int] = None,
        freshness_probe: Optional[Callable[[int], Optional[int]]] = None,
        probe_timeout_s: float = 10.0,
        device=None,
        mesh=None,
    ):
        from tsspark_tpu_torch.config import SolverConfig

        self.data_dir = data_dir
        self.registry = registry
        self.scratch = scratch
        self.chunk = int(chunk)
        self.solver_config = solver_config or SolverConfig()
        self.phase1_iters = int(phase1_iters)
        self.no_phase1_tune = bool(no_phase1_tune)
        self.warm_start = bool(warm_start)
        self.pool = pool
        self.flip_fn = flip_fn
        self.activate = bool(activate)
        self.hot_series = list(hot_series or ())
        self.horizons = tuple(horizons)
        self.poll_s = float(poll_s)
        self.debounce_s = float(debounce_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.pipeline = bool(pipeline)
        self.speculate = bool(speculate)
        self.spec_refresh_s = float(spec_refresh_s)
        self.spec_cap = spec_cap
        self.freshness_probe = freshness_probe
        self.probe_timeout_s = float(probe_timeout_s)
        self.device = device
        self.mesh = mesh
        self.fit_path: Optional[str] = None

        self.model = ArrivalModel()
        self.freshness: "collections.deque" = collections.deque(
            maxlen=FRESHNESS_WINDOW
        )
        self.cycles = 0
        self.resumed_cycles = 0
        self.failures = 0
        self.probe_failures = 0
        self.probe_errors = 0
        self.wrong_version = 0
        self.spec_predicted = 0
        self.spec_hits = 0
        self.spec_cycles = 0
        self._fail_streak = 0
        self._pending: Dict[int, float] = {}
        self._recent_changed: "collections.deque" = collections.deque(
            maxlen=8
        )
        self._head_version: Optional[int] = None
        self._head_stamp: Optional[int] = None
        self._carry: Optional[Dict] = None
        self._spec: Optional[Dict] = None
        self._spec_rows: Optional[np.ndarray] = None
        self._last_spec = 0.0
        self._last_reprobe = 0.0
        self._max_served = 0
        self._seq_seen = 0
        self._busy: List[Tuple[float, float]] = []
        self._pub_thread: Optional[threading.Thread] = None
        self._pub_result: Optional[Dict] = None
        # The cycle handed to the publisher, kept until its publish
        # SUCCEEDS: a transient publish/flip failure is retried from
        # here (under backoff) — without it the daemon would idle on a
        # completed fit until the next delta happened to land.
        self._inflight: Optional[Tuple[Dict, Optional[Dict]]] = None
        self._stop = threading.Event()
        self._m_fresh = METRICS.gauge(
            "tsspark_sched_freshness_last_seconds"
        )
        self._m_fresh_hist = METRICS.histogram(
            "tsspark_sched_freshness_seconds"
        )
        self._m_cycles = METRICS.counter("tsspark_sched_cycles_total")
        self._m_backlog = METRICS.gauge("tsspark_sched_backlog_deltas")
        self._m_spec_pred = METRICS.counter(
            "tsspark_sched_spec_predicted_total"
        )
        self._m_spec_hit = METRICS.counter(
            "tsspark_sched_spec_hits_total"
        )
        self._m_overdue = METRICS.gauge("tsspark_sched_overdue_series")
        self._m_spec_fail = METRICS.counter(
            "tsspark_sched_spec_attach_failures_total"
        )
        self._last_overdue_probe = 0.0

    # -- lifecycle -------------------------------------------------------------

    def stop(self) -> None:
        """Ask the loop to exit after the current tick (thread-safe)."""
        self._stop.set()

    def run(self, *, duration_s: Optional[float] = None,
            max_cycles: Optional[int] = None,
            until_stamp: Optional[int] = None) -> Dict:
        """Drive the loop until a bound is hit: ``duration_s`` of wall,
        ``max_cycles`` completed cycles, or ``until_stamp`` — exit once
        a version covering that delta seq has published AND its
        freshness resolved (the bench's drain condition).  With no
        bound, runs until :meth:`stop` (the daemon mode).  Returns the
        run summary (also printed by the CLI as its one JSON line)."""
        t_start = time.monotonic()
        t_wall0 = time.time()
        self._busy = []  # busy/overhead accounting is per-run
        os.makedirs(self.scratch, exist_ok=True)
        self._startup_resume()
        while not self._stop.is_set():
            if duration_s is not None and \
                    time.monotonic() - t_start >= duration_s:
                break
            if max_cycles is not None and self.cycles >= max_cycles:
                break
            if until_stamp is not None \
                    and (self._head_stamp or 0) >= int(until_stamp) \
                    and self._pub_thread is None \
                    and self._inflight is None \
                    and not self._pending:
                break
            self._tick()
        if not self._join_publisher(block=True):
            # Exiting with the last publish failed: count it so the
            # summary (and exit code) reflect the unpublished cycle —
            # the plan stays pinned for the successor.
            self.failures += 1
            self._fail_streak += 1
        wall = time.time() - t_wall0
        busy = _merge_busy(self._busy)
        summary = {
            "kind": "sched-summary",
            "cycles": self.cycles,
            "resumed_cycles": self.resumed_cycles,
            "failures": self.failures,
            "head_version": self._head_version,
            "head_stamp": self._head_stamp,
            "pending_deltas": len(self._pending),
            "wall_s": round(wall, 3),
            "busy_s": round(busy, 3),
            "cycle_overhead_frac": (round(busy / wall, 4) if wall
                                    else None),
            "freshness": self.freshness_summary(),
            "spec": self.spec_summary(),
            "wrong_version": self.wrong_version,
            "probe_failures": self.probe_failures,
            "probe_errors": self.probe_errors,
            "pipeline": self.pipeline,
            "fit_path": self.fit_path,
            "disk_ladder": current_state(self.scratch),
            "ok": self._fail_streak == 0,
        }
        self._write_sched_state(summary)
        return summary

    def freshness_summary(self) -> Dict:
        vals = [fr for _seq, fr in self.freshness]
        return {
            "n": len(vals),
            "p50_s": _pct(vals, 50),
            "p95_s": _pct(vals, 95),
            "mean_s": (round(float(np.mean(vals)), 4) if vals
                       else None),
            "max_s": (round(float(np.max(vals)), 4) if vals else None),
        }

    def spec_summary(self) -> Dict:
        return {
            "enabled": self.speculate,
            "predicted": self.spec_predicted,
            "hits": self.spec_hits,
            "cycles_with_speculation": self.spec_cycles,
            "hit_rate": (round(self.spec_hits / self.spec_predicted, 4)
                         if self.spec_predicted else None),
            "tracked_series": self.model.tracked(),
        }

    # -- startup ---------------------------------------------------------------

    def _startup_resume(self) -> None:
        """Adopt the world as a successor: seed the pending-delta map
        from the landed records, resume any pinned incomplete plan
        through ``run_refit`` (zero fit dispatches when the waves
        already landed), and only then reap stale cycle dirs."""
        from tsspark_tpu_torch.data import plane

        active = self.registry.active_version()
        stamp = (0 if active is None
                 else self.registry.version_stamp(int(active)))
        self._head_version = active
        self._head_stamp = stamp
        for rec in plane.delta_records(self.data_dir):
            self._seq_seen = max(self._seq_seen, int(rec["seq"]))
            if rec["seq"] > stamp:
                self._pending.setdefault(
                    rec["seq"], float(rec.get("unix") or time.time())
                )
            if rec["seq"] > self.model.seen_seq():
                self.model.note_delta(
                    rec["seq"], float(rec.get("unix") or time.time()),
                    plane.delta_rows(self.data_dir, rec["seq"]),
                )
        plan = refit.read_refit_plan(self.scratch)
        if plan is not None and not plan.get("complete"):
            t0 = time.time()
            res = refit.run_refit(
                data_dir=self.data_dir, registry=self.registry,
                scratch=self.scratch, chunk=self.chunk,
                solver_config=self.solver_config,
                phase1_iters=self.phase1_iters,
                no_phase1_tune=self.no_phase1_tune,
                warm_start=self.warm_start, flip_fn=self._flip,
                device=self.device, mesh=self.mesh,
            )
            self._busy.append((t0, time.time()))
            if res.get("fit_path"):
                self.fit_path = res["fit_path"]
            if res.get("complete"):
                self.cycles += 1
                self.resumed_cycles += int(bool(res.get("resumed")))
                self._m_cycles.inc()
                # Advance the frontier BEFORE resolving freshness: a
                # stale head here would make the first tick re-detect
                # (and re-fit) the set this publish just covered, and
                # re-seed its pending seqs for a double-counted
                # freshness sample.
                self._head_version = int(res["version"])
                self._head_stamp = int(res["plan_stamp"])
                self._after_publish(int(res["version"]),
                                    int(res["plan_stamp"]))
            else:
                self._note_failure("resume")
        else:
            refit.reap_cycles(self.scratch)

    # -- the loop --------------------------------------------------------------

    def _frontier(self) -> int:
        """The stamp the NEXT detect diffs against: the last drafted
        cycle's plan_stamp (every delta at or below it is already owned
        by a cycle in flight or published)."""
        return int(self._head_stamp or 0)

    def _tick(self) -> None:
        from tsspark_tpu_torch.data import plane

        if self._pub_thread is None and self._inflight is not None:
            # A previous publish failed: re-drive the stashed cycle
            # (the backoff already slept) before looking for new work.
            plan, fit_res = self._inflight
            self._spawn_publisher(plan, fit_res)
            if not self._join_publisher(block=True):
                self._note_failure("publish")
            return
        # Incremental poll: O(new deltas) per tick, not a full scan of
        # every historical visibility record (delta_seq_since walks up
        # from the highest seq this daemon has already observed).
        self._seq_seen = plane.delta_seq_since(self.data_dir,
                                               self._seq_seen)
        seq = self._seq_seen
        frontier = self._frontier()
        self._m_backlog.set(float(max(0, seq - frontier)))
        if seq <= frontier:
            if not self._join_publisher(block=False):
                # The overlapped publish failed while the loop idled:
                # back off, then the retry branch above re-drives it.
                self._note_failure("publish")
                return
            self._idle_tick()
            return
        lad = active_ladder(self.scratch)
        if lad is not None and not lad.allows("ingest"):
            # Ladder rung 3 (pause_ingest): the cycle's spill + fit
            # would grow scratch at the worst possible moment.  New
            # deltas stay pending (freshness pays, by design); the
            # idle tick keeps reaping, and relief resumes intake.
            self._idle_tick()
            return
        if self.debounce_s > 0:
            # Debounce: let a landing burst settle so one cycle owns
            # the whole batch instead of one cycle per delta.
            time.sleep(self.debounce_s)

        faults.inject("sched_detect")
        t_work0 = time.time()
        cache = None
        spill_failed = False
        # Detect and spill under the landers' lock, held shared: a delta
        # landing between the two would scatter its rows into the memmaps
        # (before its record) and so into a spill whose plan stamp does
        # not cover it.  Landers wait for the spill, a fraction of a
        # second; the reference takes no lock here.
        with plane.delta_lock(self.data_dir, shared=True):
            plan = refit.draft_plan(self.data_dir, frontier)
            self._note_deltas(frontier, plan["plan_stamp"])
            obs.record("sched.detect", t_work0, time.time() - t_work0,
                       n_changed=plan["n_changed"],
                       plan_stamp=plan["plan_stamp"])
            if plan["n_changed"]:
                try:
                    # Overlapped stages: spill + warm-cache merge are
                    # mmap reads; cycle N's publish may still be running.
                    refit.ensure_spill(self.data_dir, plan, self.scratch)
                    cache = self._warm_cache_for(plan)
                except StorageError:
                    spill_failed = True
        if spill_failed:
            # A typed disk refusal (budget tripped between the ladder gate
            # and the spill, or a real ENOSPC/EIO) is a cycle failure like
            # any other: back off and retry — the draft is idempotent —
            # instead of crashing the daemon.
            self._busy.append((t_work0, time.time()))
            self._note_failure("storage")
            return
        if not self._join_publisher(block=True):
            self._busy.append((t_work0, time.time()))
            self._note_failure("publish")
            return
        head = (self._head_version
                if self._head_version is not None
                else self.registry.active_version())
        if head is None:
            raise RuntimeError(
                "scheduler needs a published base version"
            )
        if self.registry.version_stamp(int(head)) \
                != plan["base_stamp"]:
            # The world moved under the draft (an out-of-band
            # publisher): drop it and re-detect against the new head.
            self._head_stamp = self.registry.version_stamp(int(head))
            self._busy.append((t_work0, time.time()))
            return
        plan = refit.pin_drafted(self.scratch, plan, int(head))

        fit_res = None
        if plan["n_changed"]:
            self._score_speculation(plan)
            fit_res = refit.fit_changed(
                self.data_dir, self.registry, plan, self.scratch,
                chunk=self.chunk, solver_config=self.solver_config,
                phase1_iters=self.phase1_iters,
                no_phase1_tune=self.no_phase1_tune,
                warm_start=self.warm_start, theta_cache=cache,
                device=self.device, mesh=self.mesh,
            )
            self.fit_path = fit_res.get("fit_path") or self.fit_path
            if not fit_res["complete"]:
                self._busy.append((t_work0, time.time()))
                self._note_failure("fit")
                return
        self._busy.append((t_work0, time.time()))
        self._spawn_publisher(plan, fit_res)
        self._head_stamp = int(plan["plan_stamp"])
        self._carry = self._carry_from(plan, fit_res)
        self._spec = None  # consumed (or stale) either way
        if not self.pipeline:
            self._join_publisher(block=True)

    def _idle_tick(self) -> None:
        """No new deltas: re-probe any stranded freshness, refresh the
        speculative warm prep, then sleep.  NEVER publishes — a
        zero-delta idle tick must not grow the registry, the snapshot
        dir, or RUNHISTORY (no durable or raw write is reachable from here outside the
        spill / reap / re-probe cut points, so mispredicted speculation
        is free to abandon)."""
        if (self._pending and self._pub_thread is None
                and self._head_version is not None
                and min(self._pending) <= (self._head_stamp or 0)
                and time.monotonic() - self._last_reprobe >= 1.0):
            # A probe timeout left resolved-but-unconfirmed seqs
            # pending; without this, nothing re-probes until the NEXT
            # publish — which may never come on a paused stream.
            self._last_reprobe = time.monotonic()
            self._after_publish(int(self._head_version),
                                int(self._head_stamp or 0))
        if time.monotonic() - self._last_overdue_probe >= 1.0:
            # Data-liveness: series overdue by >k× their EWMA
            # inter-arrival (the alert stream reads the same model for
            # its data-liveness alert kind; the gauge is the fleet-wide
            # at-a-glance view).
            self._last_overdue_probe = time.monotonic()
            self._m_overdue.set(
                float(len(self.model.overdue_rows(time.time(),
                                                  k=OVERDUE_K)))
            )
        lad = active_ladder(self.scratch)
        if lad is not None and lad.should_reap():
            # Ladder rung 2 (reap): shrinking headroom — drop retained
            # cycle history down to the safety floor NOW instead of at
            # the next publish, sparing the in-flight plan's dir (its
            # spill is the publisher's input).
            keep = ()
            if self._inflight is not None:
                keep = (refit.cycle_paths(self.scratch,
                                          self._inflight[0])[0],)
            refit.reap_cycles(self.scratch, keep=keep)
        if (self.speculate and self._pub_thread is None
                and self.warm_start
                and (lad is None or lad.allows("speculate"))
                and time.monotonic() - self._last_spec
                >= self.spec_refresh_s):
            self._last_spec = time.monotonic()
            self._refresh_speculation()
        time.sleep(self.poll_s)

    # -- speculation -----------------------------------------------------------

    def _spec_budget(self) -> int:
        if self.spec_cap is not None:
            return int(self.spec_cap)
        recent = [n for n in self._recent_changed]
        base = int(np.mean(recent)) if recent else 0
        return max(32, 2 * base)

    def _refresh_speculation(self) -> None:
        """Pre-gather theta + pre-compact the claim set for the rows
        the arrival model predicts advance next.  Valid only against
        the CURRENT head stamp; a publish invalidates it (the cache is
        stamp-checked at consume time, so staleness is harmless)."""
        from tsspark_tpu_torch.serve import snapplane

        head = self._head_version
        if head is None:
            return
        rows = self.model.predicted_rows(self._spec_budget())
        if not len(rows):
            return
        try:
            view = snapplane.attach(
                self.registry.version_dir(int(head)), verify=False
            )
        except (snapplane.SnapshotPlaneError, StorageError,
                OSError, ValueError):
            # No attachable plane (absent version dir, torn/partial
            # snapshot, classified disk fault): speculation is moot,
            # but count it — a version that NEVER attaches is a publish
            # bug this counter surfaces.
            self._m_spec_fail.inc()
            return
        t0 = time.time()
        theta = refit.warm_theta_gather(view.state.theta, rows)
        self._spec = {
            "base_stamp": int(self._head_stamp or 0),
            "rows": rows,
            "theta": np.asarray(theta, np.float32),
        }
        self._spec_rows = rows
        obs.record("sched.speculate", t0, time.time() - t0,
                   rows=int(len(rows)))

    def _score_speculation(self, plan: Dict) -> None:
        """Hit accounting: predicted ∩ actual over actual — the
        spec_hit_rate the SLO budgets.  Mispredicted rows cost only
        their pre-gather (discarded like a rejected draft token)."""
        if self._spec_rows is None:
            return
        changed = np.asarray(plan["changed_rows"], np.int64)
        hits = int(np.intersect1d(self._spec_rows, changed).size)
        self.spec_predicted += int(len(self._spec_rows))
        self.spec_hits += hits
        self.spec_cycles += 1
        self._m_spec_pred.inc(int(len(self._spec_rows)))
        self._m_spec_hit.inc(hits)
        self._spec_rows = None

    def _warm_cache_for(self, plan: Dict) -> Optional[Dict]:
        """Merge the carry buffer (cycle N's in-memory refit rows) and
        the speculative pre-gather into one theta cache for cycle N+1,
        both stamp-checked against the plan's base.  Rows covered by
        neither fall back to fit_changed's per-wave plane gather."""
        if not self.warm_start:
            return None
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        for src in (self._carry, self._spec):
            if (src is not None
                    and int(src["base_stamp"])
                    == int(plan["base_stamp"])
                    and len(src["rows"])):
                parts.append((np.asarray(src["rows"], np.int64),
                              np.asarray(src["theta"], np.float32)))
        if not parts:
            return None
        if len(parts) == 1:
            rows, theta = parts[0]
        else:
            # Carry wins on overlap: its rows are the just-refit ones,
            # bitwise what the new base plane will hold.
            rows_c, theta_c = parts[0]
            rows_s, theta_s = parts[1]
            keep = ~np.isin(rows_s, rows_c)
            rows = np.concatenate([rows_c, rows_s[keep]])
            theta = np.concatenate([theta_c, theta_s[keep]])
            order = np.argsort(rows, kind="stable")
            rows, theta = rows[order], theta[order]
        return {"base_stamp": int(plan["base_stamp"]),
                "rows": rows, "theta": theta}

    def _carry_from(self, plan: Dict,
                    fit_res: Optional[Dict]) -> Optional[Dict]:
        if fit_res is None or fit_res.get("state_sub") is None:
            return None
        theta = np.nan_to_num(
            np.asarray(fit_res["state_sub"].theta, np.float32)
        )
        return {"base_stamp": int(plan["plan_stamp"]),
                "rows": np.asarray(plan["changed_rows"], np.int64),
                "theta": theta}

    # -- publish / flip / freshness --------------------------------------------

    def _flip(self, version: int) -> None:
        faults.inject("sched_flip")
        if self.pool is not None:
            self.pool.activate(version, hot_series=self.hot_series,
                               horizons=self.horizons)
        elif self.flip_fn is not None:
            self.flip_fn(int(version))
        elif self.activate:
            self.registry.activate(int(version))

    def _spawn_publisher(self, plan: Dict,
                         fit_res: Optional[Dict]) -> None:
        assert self._pub_thread is None
        self._pub_result = None
        self._inflight = (plan, fit_res)
        state_sub = fit_res["state_sub"] if fit_res else None
        step_sub = fit_res["step_sub"] if fit_res else None

        def _publish_worker():
            t0 = time.time()
            try:
                pub = refit.publish_plan(
                    self.registry, plan, state_sub, step_sub,
                    self.scratch, flip_fn=self._flip, reap=False,
                    horizons=self.horizons, device=self.device,
                )
                self._pub_result = dict(pub, ok=True, plan=plan,
                                        t0=t0, t1=time.time())
            except BaseException as e:  # surfaced at join
                self._pub_result = {"ok": False, "error": e,
                                    "plan": plan, "t0": t0,
                                    "t1": time.time()}

        t = threading.Thread(target=_publish_worker,
                             name="sched-publish", daemon=True)
        self._pub_thread = t
        t.start()

    def _join_publisher(self, block: bool) -> bool:
        """Collect the publisher thread's outcome.  ``block=False``
        returns True while it is still running (nothing to collect
        yet); ``block=True`` waits.  False = the publish failed (the
        plan stays pinned for a resume)."""
        t = self._pub_thread
        if t is None:
            return True
        if not block and t.is_alive():
            return True
        t.join()
        self._pub_thread = None
        res = self._pub_result
        self._pub_result = None
        if res is None:
            return True
        self._busy.append((res["t0"], res["t1"]))
        if not res.get("ok"):
            err = res.get("error")
            obs.event("sched.publish_failed", error=repr(err))
            print(f"[sched] publish failed: {err!r}", file=sys.stderr)
            return False  # _inflight keeps the cycle for the retry
        self._inflight = None
        plan = res["plan"]
        self.cycles += 1
        self._m_cycles.inc()
        self._recent_changed.append(int(plan["n_changed"]))
        self._head_version = int(res["version"])
        self._after_publish(int(res["version"]),
                            int(plan["plan_stamp"]))
        # Reap ONLY the published cycle's dir: the next cycle's
        # prefetched spill may already exist beside it.
        cycle_dir, _d, _o = refit.cycle_paths(self.scratch, plan)
        shutil.rmtree(cycle_dir, ignore_errors=True)
        self._fail_streak = 0
        self._write_sched_state()
        return True

    def _after_publish(self, version: int, stamp: int) -> None:
        """Resolve freshness for every delta the new version covers:
        probe the serving side until a request is served at (or past)
        the version, then stamp land->served for each pending seq."""
        t_served: Optional[float] = None
        probe_src = "flip"
        if self.freshness_probe is not None:
            probe_src = "serve"
            deadline = time.monotonic() + self.probe_timeout_s
            while time.monotonic() < deadline:
                try:
                    served = self.freshness_probe(int(version))
                except Exception:  # broad by design: the probe
                    # invokes caller-supplied serve-side code (engine
                    # forecast, HTTP shim, test stubs) whose failure
                    # surface is unbounded; ANY probe failure means
                    # only "not confirmed yet" and is retried until the
                    # deadline, where the counted probe_failures path
                    # records the episode; probe_errors counts the raw
                    # raising attempts.
                    served = None
                    self.probe_errors += 1
                if served is not None:
                    # A served version going BACKWARDS (below one
                    # already confirmed) is the wrong-version signal
                    # the summary reports; an answer merely from
                    # before this flip settled is retried.
                    if int(served) < self._max_served:
                        self.wrong_version += 1
                    self._max_served = max(self._max_served,
                                           int(served))
                    if int(served) >= int(version):
                        t_served = time.time()
                        break
                time.sleep(0.02)
            if t_served is None:
                self.probe_failures += 1
                return  # seqs stay pending; idle ticks re-probe
        else:
            t_served = time.time()
        for seq in sorted(self._pending):
            if seq > int(stamp):
                continue
            fr = max(0.0, t_served - self._pending.pop(seq))
            self.freshness.append((seq, fr))
            self._m_fresh.set(fr)
            self._m_fresh_hist.observe(fr)
            obs.record("refit.freshness", t_served - fr, fr, seq=seq,
                       version=int(version), probe=probe_src)

    # -- bookkeeping -----------------------------------------------------------

    def _note_deltas(self, frontier: int, plan_stamp: int) -> None:
        from tsspark_tpu_torch.data import plane

        for rec in plane.delta_records(self.data_dir):
            seq = rec["seq"]
            if frontier < seq <= plan_stamp:
                self._pending.setdefault(
                    seq, float(rec.get("unix") or time.time())
                )
            # Gate the patch read on the model's frontier: only NEW
            # seqs need their rows loaded (note_delta would drop an
            # already-seen seq anyway, but only after the zip read).
            if seq > self.model.seen_seq():
                self.model.note_delta(
                    seq, float(rec.get("unix") or time.time()),
                    plane.delta_rows(self.data_dir, seq),
                )

    def _note_failure(self, stage: str) -> None:
        self.failures += 1
        self._fail_streak += 1
        delay = min(self.backoff_base_s * (2 ** (self._fail_streak - 1)),
                    self.backoff_max_s)
        obs.event("sched.backoff", stage=stage,
                  streak=self._fail_streak, delay_s=round(delay, 3))
        print(f"[sched] {stage} failed (streak {self._fail_streak}); "
              f"backing off {delay:.1f}s", file=sys.stderr)
        self._write_sched_state()
        self._stop.wait(delay)

    def _write_sched_state(self, summary: Optional[Dict] = None) -> None:
        state = {
            "unix": round(time.time(), 3),
            "pid": os.getpid(),
            "cycles": self.cycles,
            "resumed_cycles": self.resumed_cycles,
            "failures": self.failures,
            "fail_streak": self._fail_streak,
            "head_version": self._head_version,
            "head_stamp": self._head_stamp,
            "pending_deltas": len(self._pending),
            "freshness": self.freshness_summary(),
            "spec": self.spec_summary(),
            "disk_ladder": current_state(self.scratch),
        }
        if summary is not None:
            state["last_summary"] = {
                k: v for k, v in summary.items() if k != "kind"
            }
        try:
            atomic_write(
                os.path.join(self.scratch, SCHED_STATE_FILE),
                lambda fh: json.dump(state, fh, indent=1), mode="w",
            )
        except StorageError:
            # Advisory observability, never fatal: under an exhausted
            # budget the daemon must keep running its ladder (reap,
            # pause) rather than die writing the file that REPORTS the
            # pressure.
            pass


def read_sched_state(scratch: str) -> Optional[Dict]:
    """The advisory scheduler state, or None (absent/torn)."""
    try:
        with open(os.path.join(scratch, SCHED_STATE_FILE)) as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# the freshness bench: the sustained churn stream
# ---------------------------------------------------------------------------

#: Default churn fraction per landed delta (the 1–10% band production
#: late-arriving data lives in).
DEFAULT_FRESHNESS_CHURN = 0.05

#: Deltas per measured stream.
DEFAULT_FRESHNESS_DELTAS = 6

#: Fraction of each delta drawn from a persistent hot pool (real
#: late-arriving data is cadenced — the same stores report daily — and
#: the hot bias is what gives the arrival model a learnable signal; the
#: rest stays uniform so mispredictions exist to discard).
HOT_BIAS = 0.7


def _hot_biased_rows(rng, n: int, k: int,
                     hot_pool: np.ndarray) -> np.ndarray:
    k = max(1, min(int(k), n))
    n_hot = min(int(round(HOT_BIAS * k)), len(hot_pool))
    hot = rng.choice(hot_pool, size=n_hot, replace=False) \
        if n_hot else np.empty(0, np.int64)
    rest = np.setdiff1d(np.arange(n, dtype=np.int64), hot,
                        assume_unique=False)
    cold = rng.choice(rest, size=max(0, k - n_hot), replace=False)
    return np.unique(np.concatenate([hot, cold]).astype(np.int64))


def _write_freshness_report(rep: Dict) -> str:
    path = (f"BENCH_freshness_{rep['rung']}_{rep['mode']}"
            f"_{int(rep['unix'])}.json")
    atomic_write(path, lambda fh: json.dump(rep, fh, indent=1),
                 mode="w")
    return path


def _freshness_report(rung, mode: str, churn: float, n_deltas: int,
                      interval_s: float, cold: Dict, summary: Dict,
                      wrong_version: int, cfg, device=None) -> Dict:
    from tsspark_tpu_torch.bench_scale import device_name
    from tsspark_tpu_torch.config import NUMERICS_REV
    from tsspark_tpu_torch.obs.history import git_rev
    from tsspark_tpu_torch.utils import checkpoint as ckpt

    fresh = summary["freshness"]
    cold_wall = float(cold["fit_s"]) + float(cold["publish_s"])
    p95 = fresh.get("p95_s")
    spec = summary["spec"]
    return {
        "kind": "freshness-bench",
        "unix": round(time.time(), 3),
        "trace_id": obs.trace_id(),
        "numerics_rev": NUMERICS_REV,
        "git_rev": git_rev(),
        "config_fingerprint": ckpt.config_fingerprint(cfg),
        "device": device_name(device),
        "rung": rung.name,
        "series": rung.series,
        "timesteps": rung.timesteps,
        "mode": mode,
        "churn": churn,
        "deltas": n_deltas,
        "interval_s": round(interval_s, 3),
        "complete": bool(fresh["n"] >= n_deltas
                         and summary["failures"] == 0),
        "cold_fit_s": round(float(cold["fit_s"]), 3),
        "cold_publish_s": round(float(cold["publish_s"]), 3),
        "cold_wall_s": round(cold_wall, 3),
        "cold_reused": bool(cold.get("reused")),
        "freshness_n": fresh["n"],
        "freshness_p50_s": fresh["p50_s"],
        "freshness_p95_s": p95,
        "freshness_mean_s": fresh["mean_s"],
        "freshness_max_s": fresh["max_s"],
        "freshness_vs_cold_frac": (round(p95 / cold_wall, 4)
                                   if p95 is not None and cold_wall
                                   else None),
        "cycle_overhead_frac": summary["cycle_overhead_frac"],
        "cycles": summary["cycles"],
        "spec_hit_rate": spec["hit_rate"],
        "spec_predicted": spec["predicted"],
        "wrong_version": wrong_version,
        "probe_failures": summary["probe_failures"],
        "wall_s": summary["wall_s"],
    }


def run_freshness_bench(rung="smoke", *,
                        churn: float = DEFAULT_FRESHNESS_CHURN,
                        n_deltas: int = DEFAULT_FRESHNESS_DELTAS,
                        interval_s: Optional[float] = None,
                        modes: Sequence[str] = ("serialized",
                                                "pipelined"),
                        reuse_cold: Optional[str] = None,
                        scratch_root: Optional[str] = None,
                        sentinel: Optional[bool] = None,
                        device=None, mesh=None) -> List[Dict]:
    """The freshness bench: a sustained churn stream through the
    always-on loop, measuring steady-state data-to-forecast freshness
    (land of a row's ``deltaok_`` sentinel -> first request SERVED from
    a version containing it, probed through a live in-process engine).

    Runs the same stream twice — serialized back-to-back cycles, then
    pipelined — so the report pair shows exactly what the overlap buys
    on p95 freshness.  Both modes share one cold base (the warm-base
    amortization ``--reuse-cold`` gives churn sweeps); the plane lives
    under a private root because deltas mutate landed rows.  One
    ``BENCH_freshness_*`` artifact per mode (in the working directory),
    each judged by the regression sentinel under
    ``[tool.tsspark.slo.freshness]``.  ``device`` / ``mesh`` go to every
    fit, publish and the engine as ``RefitScheduler`` takes them (None:
    the card, on the default mesh)."""
    import tempfile

    from tsspark_tpu_torch import bench_scale
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.serve.cache import ForecastCache
    from tsspark_tpu_torch.serve.engine import PredictionEngine

    if isinstance(rung, str):
        rung = bench_scale.RUNGS[rung]
    cfg = bench_scale._config()
    solver = SolverConfig(max_iters=rung.max_iters)
    scratch = os.path.join(
        scratch_root or tempfile.gettempdir(),
        f"tsfresh_{rung.name}_{rung.series}x{rung.timesteps}"
        f"_{plane.dataset_fingerprint()}",
    )
    os.makedirs(scratch, exist_ok=True)
    # The freshness bench always amortizes its cold base (internally
    # when no --reuse-cold dir was named): the measurement is the
    # STREAM, the cold fit is only its denominator.
    base_dir = reuse_cold or os.path.join(scratch, "coldbase")
    os.makedirs(base_dir, exist_ok=True)
    prev_run = obs.start_run(os.path.join(scratch, "spans.jsonl"))
    reports: List[Dict] = []
    try:
        spec = plane.DatasetSpec(
            generator="demo_weekly", n_series=rung.series,
            n_timesteps=rung.timesteps, seed=2,
        )
        dset_dir = plane.ensure(spec, root=os.path.join(base_dir,
                                                        "plane"))
        ids = plane.series_ids(spec)
        pool_rng = np.random.default_rng(7)
        hot_pool = np.sort(pool_rng.choice(
            rung.series,
            size=max(2, int(round(2 * churn * rung.series))),
            replace=False,
        )).astype(np.int64)

        p95_by_mode: Dict[str, Optional[float]] = {}
        for mode in modes:
            run_dir = os.path.join(scratch,
                                   f"run_{int(time.time())}_{mode}")
            # Same reaper as the delta bench: the scratch is
            # deliberately persistent (coldbase amortization), so
            # without an age-gated sweep every invocation strands two
            # rung-sized registry trees forever.
            refit._sweep_stale_runs(scratch, keep=run_dir)
            registry, cold, _catchup = refit.prepare_cold_registry(
                rung, cfg, solver, run_dir, dset_dir, ids,
                reuse_cold=base_dir, device=device, mesh=mesh,
            )
            if registry is None:
                print("[freshness] cold fit incomplete; aborting",
                      file=sys.stderr)
                reports.append({"complete": False,
                                "stage": "cold-fit", "mode": mode})
                break
            cold_wall = float(cold["fit_s"]) + float(cold["publish_s"])
            gap = interval_s if interval_s is not None else \
                min(10.0, max(0.3, 0.15 * cold_wall))

            sample, _ = bench_scale._request_mix(rung, ids)
            hot = [str(s) for s in sample[:rung.hot]]
            engine = PredictionEngine(registry, cache=ForecastCache(),
                                      device=device)
            engine.materialize(hot, bench_scale.HORIZONS)
            probe_sid = str(ids[int(hot_pool[0])])

            def flip_fn(v, _e=engine, _r=registry, _h=hot):
                _e.prefetch(v)
                _e.materialize(_h, bench_scale.HORIZONS, version=v)
                _r.activate(v)

            def probe(version, _e=engine, _sid=probe_sid):
                # The scheduler judges the answer (freshness AND the
                # backwards-version wrong_version signal).
                res = _e.forecast([_sid], bench_scale.HORIZONS[0])
                return res.version

            sched = RefitScheduler(
                dset_dir, registry,
                os.path.join(run_dir, "sched"),
                chunk=rung.chunk, solver_config=solver,
                warm_start=True, flip_fn=flip_fn,
                pipeline=(mode == "pipelined"), speculate=True,
                poll_s=0.02, debounce_s=0.05, spec_refresh_s=0.2,
                freshness_probe=probe, device=device, mesh=mesh,
            )
            seq0 = plane.delta_seq(dset_dir)
            target = seq0 + int(n_deltas)

            def _land_stream(_seq0=seq0, _gap=gap):
                rng = np.random.default_rng([11, _seq0])
                k = max(1, int(round(churn * rung.series)))
                for i in range(int(n_deltas)):
                    rows = _hot_biased_rows(rng, rung.series, k,
                                            hot_pool)
                    try:
                        plane.land_synthetic_delta(dset_dir, churn,
                                                   rows=rows)
                    except Exception as e:
                        print(f"[freshness] land failed: {e!r}",
                              file=sys.stderr)
                        return
                    time.sleep(_gap)

            lander = threading.Thread(target=_land_stream,
                                      name="freshness-lander",
                                      daemon=True)
            t_mode0 = time.time()
            lander.start()
            summary = sched.run(
                until_stamp=target,
                duration_s=max(60.0, n_deltas * gap + 20 * cold_wall),
            )
            lander.join(timeout=10.0)
            rep = _freshness_report(rung, mode, churn, int(n_deltas),
                                    gap, cold, summary,
                                    int(summary["wrong_version"]),
                                    cfg, device=device)
            rep["stream_wall_s"] = round(time.time() - t_mode0, 3)
            path = _write_freshness_report(rep)
            rep["path"] = path
            p95_by_mode[mode] = rep["freshness_p95_s"]
            print(json.dumps({
                "rung": rung.name, "mode": mode, "churn": churn,
                "deltas": n_deltas,
                "freshness_p50_s": rep["freshness_p50_s"],
                "freshness_p95_s": rep["freshness_p95_s"],
                "freshness_vs_cold_frac":
                    rep["freshness_vs_cold_frac"],
                "cycle_overhead_frac": rep["cycle_overhead_frac"],
                "spec_hit_rate": rep["spec_hit_rate"],
                "wrong_version": rep["wrong_version"],
                "report": path,
            }), flush=True)
            if sentinel is None:
                sentinel_on = (os.environ.get("TSSPARK_SENTINEL", "1")
                               != "0")
            else:
                sentinel_on = sentinel
            if sentinel_on:
                try:
                    from tsspark_tpu_torch.obs import regress

                    verdict = regress.sentinel_report(rep, source=path)
                    if verdict is not None:
                        print(
                            f"[freshness] {regress.summarize(verdict)}",
                            file=sys.stderr,
                        )
                        rep["sentinel_ok"] = verdict["ok"]
                except Exception as e:  # never mask the report
                    print(f"[freshness] sentinel skipped: {e!r}",
                          file=sys.stderr)
            reports.append(rep)
        if len([m for m in p95_by_mode.values()
                if m is not None]) == 2:
            ser, pip = (p95_by_mode.get("serialized"),
                        p95_by_mode.get("pipelined"))
            print(json.dumps({
                "freshness_pipeline_gain":
                    (round(1.0 - pip / ser, 4) if ser else None),
                "serialized_p95_s": ser, "pipelined_p95_s": pip,
            }), flush=True)
        return reports
    finally:
        obs.end_run(prev_run)


# ---------------------------------------------------------------------------
# CLI (python -m tsspark_tpu_torch.sched): the killable daemon
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the always-on scheduler (or the freshness bench) as its own
    process (the unit a chaos run kills at every stage).  Adopts the spawner's trace; prints ONE
    JSON summary line at exit.  ``--device cpu`` asks for the CPU and
    forces the virtual host mesh, so each cycle's fit runs resident in
    this process, as the reference's daemon does on its virtual CPU mesh;
    with no ``--device`` the daemon runs on the card, on the default mesh
    (one card: the file-protocol fallback, named in the summary's
    ``fit_path``)."""
    ap = argparse.ArgumentParser(prog="python -m tsspark_tpu_torch.sched")
    ap.add_argument("--data", help="plane dataset dir")
    ap.add_argument("--registry", help="serve registry root")
    ap.add_argument("--scratch", help="scheduler scratch dir")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--max-iters", type=int, default=20)
    ap.add_argument("--poll", type=float, default=0.05)
    ap.add_argument("--debounce", type=float, default=0.1)
    ap.add_argument("--duration", type=float, default=None,
                    help="exit after this many seconds (default: run "
                         "until killed)")
    ap.add_argument("--max-cycles", type=int, default=None)
    ap.add_argument("--until-stamp", type=int, default=None,
                    help="exit once a version covering this delta seq "
                         "has published")
    ap.add_argument("--serialized", action="store_true",
                    help="disable the cycle pipeline (back-to-back "
                         "cycles)")
    ap.add_argument("--no-speculate", action="store_true",
                    help="disable idle-time speculative warm prep")
    ap.add_argument("--cold", action="store_true",
                    help="disable the warm start")
    ap.add_argument("--no-activate", action="store_true",
                    help="publish without flipping (a pool front owns "
                         "the flip)")
    ap.add_argument("--freshness-bench", default=None, metavar="RUNG",
                    help="run the freshness stream bench at a scale "
                         "rung instead of the daemon")
    ap.add_argument("--reuse-cold", default=None, metavar="DIR")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        from tsspark_tpu_torch.parallel.mesh import force_virtual_host_mesh

        force_virtual_host_mesh()
    obs.adopt_env()
    if args.freshness_bench:
        reports = run_freshness_bench(args.freshness_bench,
                                      reuse_cold=args.reuse_cold,
                                      device=args.device)
        return 0 if refit.sweep_ok(reports) else 1
    if not (args.data and args.registry and args.scratch):
        ap.error("--data, --registry and --scratch are required for "
                 "the daemon")
    from tsspark_tpu_torch.config import SolverConfig
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    registry = ParamRegistry.open(args.registry)
    sched = RefitScheduler(
        args.data, registry, args.scratch, chunk=args.chunk,
        solver_config=SolverConfig(max_iters=args.max_iters),
        warm_start=not args.cold, activate=not args.no_activate,
        poll_s=args.poll, debounce_s=args.debounce,
        pipeline=not args.serialized,
        speculate=not args.no_speculate,
        device=args.device,
    )
    summary = sched.run(duration_s=args.duration,
                        max_cycles=args.max_cycles,
                        until_stamp=args.until_stamp)
    print(json.dumps(summary), flush=True)
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
