"""Unified retry policy and circuit breaker: a copy of the JAX package's
``resilience/policy.py``, field for field, with the same schedules.

``RetryPolicy`` expresses a retry loop as data (attempts, exponential
backoff with deterministic jitter, per-attempt deadlines, a total
budget), so call sites accept a policy and tests and operators tune
recovery without editing control flow.  ``CircuitBreaker`` remembers
failures across calls.  The named schedules below are the reference's:
``WORKER_RETRY`` (the orchestrator's respawns), ``PROBE`` (its
accelerator probe) and ``STREAM_POLL`` (the streaming poll).

Jitter is deterministic: it is derived from ``(seed, attempt)``, never
from global RNG state or wall-clock entropy, so a replayed run sleeps
the same intervals, which the fault-injection harness (``faults.py``)
relies on to make recovery paths reproducible.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type


class CircuitOpen(RuntimeError):
    """Raised when a call is refused because its circuit breaker is open:
    the dependency has failed enough in a row that retrying it before the
    reset window elapses only burns the caller's deadline."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit for {name!r} is open; retry in {retry_after_s:.2f}s"
        )
        self.name = name
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Closed / open / half-open failure gate for one dependency.

    A ``RetryPolicy`` bounds how long ONE call keeps trying; a breaker
    remembers failures ACROSS calls, so a dead dependency (wedged
    accelerator client, corrupt registry, downed broker) is shed fast —
    ``allow()`` returns False for ``reset_timeout_s`` after
    ``failure_threshold`` consecutive failures — instead of every caller
    independently retrying to its deadline.  After the window one
    half-open trial call probes the dependency: its success closes the
    circuit, its failure re-opens it for another window.

    Thread-safe (the serving engine's pump and a publisher thread may
    race it).  ``clock`` injects a fake time source for tests; state is
    derived from the clock on demand, so an idle breaker transitions
    open -> half-open without a background timer.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, name: str = "dependency",
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.name = name
        # Observability counters (pool stats, engine stats).
        self.opens = 0
        self.fast_fails = 0
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._trial_inflight = False

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return self.CLOSED
        if self._clock() - self._opened_at >= self.reset_timeout_s:
            return self.HALF_OPEN
        return self.OPEN

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """May a call proceed right now?  Half-open admits exactly one
        trial at a time; refusals are counted in ``fast_fails``."""
        with self._lock:
            st = self._state_locked()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            self.fast_fails += 1
            return False

    def retry_after_s(self) -> float:
        """Seconds until the next half-open trial would be admitted."""
        with self._lock:
            if self._opened_at is None:
                return 0.0
            return max(
                0.0,
                self.reset_timeout_s - (self._clock() - self._opened_at),
            )

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._trial_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            st = self._state_locked()
            self._failures += 1
            if st == self.HALF_OPEN or (
                st == self.CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._trial_inflight = False
                self.opens += 1

    def snapshot(self) -> dict:
        """JSON-able state for reports."""
        with self._lock:
            return {
                "name": self.name,
                "state": self._state_locked(),
                "failures": self._failures,
                "opens": self.opens,
                "fast_fails": self.fast_fails,
            }


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How many times to try, how long to wait, and when to give up.

    ``max_attempts``: total attempts allowed (``None`` = unbounded; the
    probe loop uses this — a wedged runtime recovers on its own
    schedule).  ``allows(n)`` answers "may attempt number ``n`` (0-based
    count of attempts already made) start?".

    ``base_delay_s`` / ``backoff`` / ``max_delay_s`` / ``jitter``: the
    sleep before retry ``k`` (0-based) is
    ``min(base * backoff**k, max_delay)``, scaled by a deterministic
    jitter factor in ``[1 - jitter, 1 + jitter]`` drawn from
    ``(seed, k)``.

    ``attempt_timeout_s`` (+ ``attempt_timeout_step_s``, capped at
    ``attempt_timeout_max_s``): per-attempt deadline, escalating with
    consecutive failures — a healthy-but-slow dependency must not fail
    every probe forever, so each failure buys the next attempt more
    patience.

    ``total_budget_s``: overall wall budget across all attempts
    (``deadline_from(start)`` converts it to an absolute deadline).
    """

    max_attempts: Optional[int] = 9
    base_delay_s: float = 10.0
    backoff: float = 1.0
    max_delay_s: float = 30.0
    jitter: float = 0.0
    attempt_timeout_s: Optional[float] = None
    attempt_timeout_step_s: float = 0.0
    attempt_timeout_max_s: Optional[float] = None
    total_budget_s: Optional[float] = None
    seed: int = 0

    def allows(self, attempts_made: int) -> bool:
        """True if another attempt may start after ``attempts_made``."""
        return self.max_attempts is None or attempts_made < self.max_attempts

    def delay_s(self, retry: int) -> float:
        """Sleep before 0-based retry number ``retry`` (deterministic)."""
        d = min(
            self.base_delay_s * (self.backoff ** max(0, retry)),
            self.max_delay_s,
        )
        if self.jitter:
            # String seeding: deterministic across processes and Python
            # versions (tuple seeds are hash-based and deprecated).
            u = random.Random(f"{self.seed}:{retry}").uniform(-1.0, 1.0)
            d *= 1.0 + self.jitter * u
        return max(0.0, d)

    def attempt_timeout(self, consecutive_failures: int = 0
                        ) -> Optional[float]:
        """Per-attempt deadline after ``consecutive_failures`` failures."""
        if self.attempt_timeout_s is None:
            return None
        t = (self.attempt_timeout_s
             + self.attempt_timeout_step_s * max(0, consecutive_failures))
        if self.attempt_timeout_max_s is not None:
            t = min(t, self.attempt_timeout_max_s)
        return t

    def deadline_from(self, start: float) -> Optional[float]:
        """Absolute deadline for the whole retry loop, or None."""
        if self.total_budget_s is None:
            return None
        return start + self.total_budget_s

    def sleep(self, retry: int, deadline: Optional[float] = None) -> float:
        """Sleep ``delay_s(retry)``, clamped to ``deadline``; returns the
        seconds actually slept."""
        d = self.delay_s(retry)
        if deadline is not None:
            d = max(0.0, min(d, deadline - time.time()))
        if d > 0:
            time.sleep(d)
        return d

    def call(self, fn: Callable, *,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             breaker: Optional["CircuitBreaker"] = None):
        """Run ``fn()`` under this policy: retry on ``retry_on`` with the
        backoff schedule until an attempt succeeds, the attempt budget is
        exhausted, or the total budget runs out — then re-raise the last
        error.  The streaming poll loops ride this helper.

        ``breaker``: a ``CircuitBreaker`` consulted before EVERY attempt
        and fed every outcome.  A call that starts against an open
        breaker raises ``CircuitOpen`` without attempting anything — a
        dependency that has been failing across calls is shed fast
        instead of retried to the deadline.  A breaker that OPENS
        mid-call stops the retry loop but re-raises the underlying
        error (the real failure must not be masked by the gate that
        merely reacted to it)."""
        deadline = self.deadline_from(time.time())
        for attempt in itertools.count():
            if breaker is not None and not breaker.allow():
                raise CircuitOpen(breaker.name, breaker.retry_after_s())
            try:
                result = fn()
            except retry_on as e:
                if breaker is not None:
                    breaker.record_failure()
                out_of_attempts = not self.allows(attempt + 1)
                out_of_budget = (
                    deadline is not None and time.time() >= deadline
                )
                breaker_tripped = (
                    breaker is not None
                    and breaker.state != CircuitBreaker.CLOSED
                )
                if out_of_attempts or out_of_budget or breaker_tripped:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(attempt, deadline)
            except BaseException:
                # Non-retryable escape (caller bug, KeyboardInterrupt):
                # the attempt still has to resolve the breaker's
                # half-open trial slot, or the breaker wedges with the
                # trial marked in flight and never admits another call.
                if breaker is not None:
                    breaker.record_failure()
                raise
            else:
                if breaker is not None:
                    breaker.record_success()
                return result


# The pre-existing schedules, named.  Call sites default to these so the
# refactor preserves behavior exactly; callers override per run.

#: orchestrate.run_resilient's post-crash schedule: fixed 10 s sleep
#: between worker respawns, give up after 9 consecutive zero-progress
#: deaths (the old ``max_fruitless_retries=8`` semantics: raise when the
#: count EXCEEDS 8).
WORKER_RETRY = RetryPolicy(
    max_attempts=9, base_delay_s=10.0, backoff=1.0, max_delay_s=10.0,
)

#: The accelerator probe loop: 5 s sleeps escalating x1.5 to a 30 s cap
#: between failed probes (reset on success), per-probe patience
#: 30 + 15*consec capped at 90 s, never giving up (a wedged runtime
#: recovers on its own schedule).
PROBE = RetryPolicy(
    max_attempts=None, base_delay_s=5.0, backoff=1.5, max_delay_s=30.0,
    attempt_timeout_s=30.0, attempt_timeout_step_s=15.0,
    attempt_timeout_max_s=90.0,
)

#: Streaming micro-batch poll: transient source errors (broker hiccup,
#: network blip) retried with 1 s -> x2 -> 30 s backoff, five attempts.
STREAM_POLL = RetryPolicy(
    max_attempts=5, base_delay_s=1.0, backoff=2.0, max_delay_s=30.0,
)
