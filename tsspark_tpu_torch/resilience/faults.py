"""Deterministic fault injection: make the port's recovery paths testable
on the CPU.

The raise mode of the JAX package's harness (``resilience/faults.py``):
the same plan layout, the same ``TSSPARK_FAULTS`` environment variable
and the same claim files, so a raise-mode plan armed for either package
fires the same way in both.  A ``FaultPlan`` arms named injection
points; the plan travels through the environment so child processes see
the plan the test armed in the parent.  A plan that asks for anything
else the JAX package's harness offers (another mode, a series or path
scope) is refused, never ignored.

Each armed rule carries a fixed call window (``after`` skipped calls,
then ``attempts`` firings).  Call slots are claimed by atomic
``O_CREAT|O_EXCL`` file creation under the plan's ``state_dir``, so the
N-th matching call fires the same way no matter which process makes it.

Named points wired in the port so far:

  stream_poll       streaming source poll
  qplane_publish    quantile plane publish, once per column

With ``TSSPARK_FAULTS`` unset, ``inject`` is one dict lookup.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

ENV_VAR = "TSSPARK_FAULTS"

# Guard against a runaway call counter chewing the state dir: no test
# plan legitimately sees this many calls at one point.
_MAX_CALLS = 100_000

# A rule's keys that may hold something other than their inert value
# (the JAX package's plans carry series/path/tag scopes and mode knobs).
_INERT = {"mode": "raise", "series": None, "path": None}


class FaultInjected(RuntimeError):
    """Raised by an armed injection point."""

    def __init__(self, point: str, rule_id: str):
        super().__init__(
            f"fault injected at {point!r} (rule {rule_id}); this error is "
            f"deliberate — a FaultPlan armed this point"
        )
        self.point = point
        self.rule_id = rule_id


class FaultPlan:
    """A serializable set of armed failure rules.

    Usage (tests)::

        plan = FaultPlan(state_dir=tmp).fail("stream_poll", attempts=2)
        monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    """

    def __init__(self, state_dir: Optional[str] = None):
        self.state_dir = state_dir or tempfile.mkdtemp(
            prefix="tsspark_faults_"
        )
        self.rules: List[dict] = []

    def fail(self, point: str, *, attempts: int = 1,
             after: int = 0) -> "FaultPlan":
        """Arm ``point``: let ``after`` matching calls through, then raise
        ``FaultInjected`` on the next ``attempts``."""
        if attempts < 1 or after < 0:
            raise ValueError("attempts must be >= 1 and after >= 0")
        self.rules.append({
            "id": f"r{len(self.rules)}_{point}", "point": point,
            "attempts": int(attempts), "after": int(after), "mode": "raise",
        })
        return self

    def to_env(self) -> str:
        os.makedirs(self.state_dir, exist_ok=True)
        return json.dumps({"state_dir": self.state_dir, "rules": self.rules})

    @classmethod
    def from_env(cls, spec: str) -> "FaultPlan":
        """The plan ``spec`` holds; ``ValueError`` for a rule that asks for
        more than a raise at a call window."""
        d = json.loads(spec)
        plan = cls(state_dir=d["state_dir"])
        for rule in d["rules"]:
            odd = {k: rule[k] for k, v in _INERT.items()
                   if rule.get(k, v) != v}
            if odd:
                raise ValueError(f"fault rule {rule.get('id')}: the port "
                                 f"injects raise-mode rules only, not {odd}")
            plan.rules.append(rule)
        return plan


_plan_cache: Dict[str, FaultPlan] = {}


def _active_plan() -> Optional[FaultPlan]:
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return None
    plan = _plan_cache.get(spec)
    if plan is None:
        plan = _plan_cache[spec] = FaultPlan.from_env(spec)
    return plan


def _claim_call(state_dir: str, rule: dict) -> Optional[int]:
    """Atomically claim this call's global 0-based sequence number for
    ``rule`` (cross-process: first O_CREAT|O_EXCL success wins a slot)."""
    for n in range(_MAX_CALLS):
        path = os.path.join(state_dir, f"{rule['id']}.{n}")
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return n
        except FileExistsError:
            continue
        except OSError:
            return None  # unwritable state dir: fail open
    return None


def inject(point: str) -> None:
    """Fault injection point: raises ``FaultInjected`` when the active
    plan arms ``point`` and this call falls in a rule's window."""
    plan = _active_plan()
    if plan is None:
        return
    for rule in plan.rules:
        if rule["point"] != point:
            continue
        n = _claim_call(plan.state_dir, rule)
        if n is not None and rule["after"] <= n < rule["after"] + \
                rule["attempts"]:
            raise FaultInjected(point, rule["id"])
