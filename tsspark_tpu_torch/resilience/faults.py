"""Deterministic fault injection: make the port's recovery paths testable
on the CPU.

A copy of the JAX package's harness (``resilience/faults.py``): the same
modes, the same plan layout, the same ``TSSPARK_FAULTS`` environment
variable and the same claim files, so a plan armed for either package
fires the same way in both.  A ``FaultPlan`` arms named injection points;
the plan travels through the environment so the orchestrator's CHILD
PROCESSES see the plan the test armed in the parent.  A plan that asks
for a mode the harness does not know is refused, never ignored.

Each armed rule carries a fixed call window (``after`` skipped calls,
then ``attempts`` firings).  Call slots are claimed by atomic
``O_CREAT|O_EXCL`` file creation under the plan's ``state_dir``, so the
N-th matching call fires the same way no matter which process makes it,
and a respawned worker does not reset the count.

Named points wired in the port:

  worker_spawn      orchestrator parent, before a child    (flag)
  device_probe      ``orchestrate.tunnel_preflight``       (flag)
  fit_worker_start  fit worker entry                       (exit/raise)
  kernel_build      fit worker, loading the kernel library (sleep/raise)
  fit_chunk         fit worker, before a chunk's solve     (exit/raise)
  fit_worker_chunk  fit worker, after a chunk save         (exit/raise)
  chunk_save        after ``save_chunk_atomic``'s rename   (corrupt)
  prep_save         after ``save_prep_atomic``'s rename    (corrupt)
  stream_poll       streaming source poll                  (raise)
  qplane_publish    quantile plane publish, once per column (raise)
  fplane_publish    forecast plane publish, once per column (raise)
  delta_publish     snapshot plane delta publish, per column (raise)
  io_write          ``io.durable`` payload write           (enospc/eio/
                                                            shortwrite/sleep)
  io_rename         ``io.durable`` publish rename          (enospc/eio)
  io_fsync          ``io.durable`` durability barrier      (lost_fsync/eio)
  io_link           ``io.durable`` hardlink copy-forward   (enospc/eio)
  io_mmap           ``io.durable`` memmap attach           (eio/sleep)

Process modes:

  "raise"         — ``inject`` raises ``FaultInjected``.
  "exit"          — ``inject`` kills the process (``os._exit(rc)``), a
                    worker death; recorded lost fsyncs are replayed first.
  "flag"          — ``inject`` returns True and the site fails soft (a
                    probe returning False, a spawn that never started).
  "corrupt"       — ``corrupt_file`` flips bytes in the file the site
                    just wrote (silent media corruption of a checkpoint).

Storage modes (the disk misbehaving, not the process):

  "enospc"/"eio"  — ``inject`` raises ``OSError`` with the real errno so
                    the site's error classification runs.
  "shortwrite"    — ``short_write`` returns a fraction; the durable-I/O
                    layer truncates the payload it just wrote to that
                    fraction and then reports success, the way an
                    unchecked ``write(2)`` return tears a file.  Only the
                    CRC-sentinel read path can catch it.
  "lost_fsync"    — ``lost_fsync`` snapshots the target's pre-write
                    state; the write proceeds and the caller sees
                    success; ``_replay_lost_fsyncs`` rolls the file back,
                    as the crash that lost the rename would.
  "sleep"         — ``inject`` stalls ``delay_s`` seconds, then lets the
                    call proceed (slow media).

Rules may carry ``path=<substring>`` to scope a storage rule to one
artifact family (the io layer passes every call's target path), and
``series=<row>`` to fire only on calls whose ``(lo, hi)`` series range
covers that row (the data plane's shard writes pass theirs).

With ``TSSPARK_FAULTS`` unset, ``inject`` is one dict lookup.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

ENV_VAR = "TSSPARK_FAULTS"

_MODES = ("raise", "exit", "flag", "corrupt", "sleep",
          "enospc", "eio", "shortwrite", "lost_fsync")

# Modes that never fire from the generic ``inject`` gate: each has its
# own hook (``corrupt_file``, ``short_write``, ``lost_fsync``) because
# firing needs the artifact path.
_HOOK_MODES = ("corrupt", "shortwrite", "lost_fsync")

# Subdirectory of the plan's state_dir holding lost-fsync rollback
# records (pre-write snapshots awaiting replay).
_LOST_DIR = "lostfsync"

# Guard against a runaway call counter chewing the state dir: no test
# plan legitimately sees this many calls at one point.
_MAX_CALLS = 100_000


class FaultInjected(RuntimeError):
    """Raised by an armed raise-mode injection point."""

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

        plan = (FaultPlan(state_dir=tmp)
                .fail("fit_worker_chunk", after=1, attempts=2, mode="exit")
                .fail("chunk_save", series=40, mode="corrupt"))
        monkeypatch.setenv(faults.ENV_VAR, plan.to_env())

    ``fail(point, ...)``: ``attempts`` matching calls fire after
    ``after`` let through; ``mode`` one of ``_MODES``; ``series`` fires
    only on calls whose ``(lo, hi)`` range covers that series index (a
    poison series: the chunk holding it dies wherever it lands);
    ``path`` a substring scope on the call's target path; ``rc`` the
    exit code of "exit" mode; ``delay_s`` a sleep's stall; ``fraction``
    the surviving share of a short write; ``tag`` a free-form label on
    the observability event a firing emits.
    """

    def __init__(self, state_dir: Optional[str] = None):
        self.state_dir = state_dir or tempfile.mkdtemp(
            prefix="tsspark_faults_"
        )
        self.rules: List[dict] = []

    def fail(self, point: str, *, attempts: int = 1, after: int = 0,
             mode: str = "raise", series: Optional[int] = None,
             rc: int = 23, delay_s: float = 0.5,
             tag: Optional[str] = None, path: Optional[str] = None,
             fraction: float = 0.5) -> "FaultPlan":
        if mode not in _MODES:
            raise ValueError(f"mode {mode!r} not in {_MODES}")
        if attempts < 1 or after < 0:
            raise ValueError("attempts must be >= 1 and after >= 0")
        if not (0.0 <= fraction < 1.0):
            raise ValueError("fraction must be in [0, 1)")
        self.rules.append({
            "id": f"r{len(self.rules)}_{point}", "point": point,
            "attempts": int(attempts), "after": int(after), "mode": mode,
            "series": series, "rc": int(rc), "delay_s": float(delay_s),
            "tag": tag, "path": path, "fraction": float(fraction),
        })
        return self

    def to_env(self) -> str:
        os.makedirs(self.state_dir, exist_ok=True)
        return json.dumps({"state_dir": self.state_dir, "rules": self.rules})

    @classmethod
    def from_env(cls, spec: str) -> "FaultPlan":
        """The plan ``spec`` holds; ``ValueError`` for a rule that asks
        for a mode the harness does not know."""
        d = json.loads(spec)
        plan = cls(state_dir=d["state_dir"])
        for rule in d["rules"]:
            if rule.get("mode", "raise") not in _MODES:
                raise ValueError(
                    f"fault rule {rule.get('id')}: mode {rule['mode']!r} "
                    f"is not one the harness injects ({_MODES})")
            plan.rules.append(dict(rule, mode=rule.get("mode", "raise")))
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


def _matches_path(rule: dict, path: Optional[str]) -> bool:
    scope = rule.get("path")
    if scope is None:
        return True
    if path is None:
        return False  # path-scoped rule at a pathless call site
    return scope in os.path.abspath(path)


def _matches(rule: dict, lo: Optional[int], hi: Optional[int]) -> bool:
    s = rule.get("series")
    if s is None:
        return True
    if lo is None:
        return True  # series-targeted rule at a context-free call site
    return lo <= s < (hi if hi is not None else lo + 1)


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


def _armed_call(rule: dict, state_dir: str, lo: Optional[int] = None,
                hi: Optional[int] = None) -> bool:
    """True when this call falls inside the rule's firing window."""
    if not _matches(rule, lo, hi):
        return False
    n = _claim_call(state_dir, rule)
    return n is not None and rule["after"] <= n < rule["after"] + \
        rule["attempts"]


def _count_fault_metric(mode: str) -> None:
    try:
        from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

        METRICS.counter("tsspark_io_faults_fired_total").inc()
        METRICS.counter(f"tsspark_io_fault_{mode}_total").inc()
    except Exception:
        pass


def _obs_fault(rule: dict, point: str, lo: Optional[int],
               hi: Optional[int], path: Optional[str] = None) -> None:
    """Span-ledger annotation for one firing: the moment a fault was
    injected becomes readable off the trace.  Best-effort; never breaks
    the site."""
    try:
        from tsspark_tpu_torch.obs import context as obs

        attrs = {"point": point, "rule": rule["id"],
                 "mode": rule["mode"], "tag": rule.get("tag")}
        if lo is not None:
            attrs["lo"], attrs["hi"] = lo, hi
        if path is not None:
            attrs["path"] = os.path.basename(path)
        obs.event("fault", **attrs)
    except Exception:
        pass


def inject(point: str, *, lo: Optional[int] = None,
           hi: Optional[int] = None, path: Optional[str] = None) -> bool:
    """Fault injection point.  No-op (False) unless a plan arms ``point``
    and this call falls in a rule's window.

    ``lo``/``hi``: the series range the call operates on (series-scoped
    rules match against it); ``path``: the artifact the call targets
    (path-scoped rules need it to match).  Returns True when a "flag"
    rule fires (the caller fails soft); "raise" raises
    ``FaultInjected``; "exit" kills the process like a real worker death;
    "enospc" / "eio" raise ``OSError`` with the real errno; "sleep"
    stalls, then lets the call proceed."""
    plan = _active_plan()
    if plan is None:
        return False
    flagged = False
    for rule in plan.rules:
        if rule["point"] != point or rule["mode"] in _HOOK_MODES:
            continue
        if not _matches_path(rule, path):
            continue
        if not _armed_call(rule, plan.state_dir, lo, hi):
            continue
        mode = rule["mode"]
        _obs_fault(rule, point, lo, hi, path)
        _count_fault_metric(mode)
        if mode == "exit":
            # A kill point is where un-fsynced renames die with the
            # process: replay recorded lost-fsync rollbacks first so the
            # survivor observes the pre-crash on-disk truth.
            _replay_lost_fsyncs(plan.state_dir)
            os._exit(int(rule.get("rc", 23)))
        if mode == "raise":
            raise FaultInjected(point, rule["id"])
        if mode in ("enospc", "eio"):
            num = _errno.ENOSPC if mode == "enospc" else _errno.EIO
            raise OSError(
                num, f"injected {mode.upper()} at {point!r} (rule "
                f"{rule['id']}); deliberate — a FaultPlan armed this point",
            )
        if mode == "sleep":
            # A stall, not a failure: the call proceeds (not flagged).
            time.sleep(float(rule.get("delay_s", 0.5)))
            continue
        flagged = True
    return flagged


def corrupt_file(point: str, path: str, *, lo: Optional[int] = None,
                 hi: Optional[int] = None) -> bool:
    """Corruption hook: when a "corrupt" rule at ``point`` fires, flip
    bytes across ``path`` (silent media corruption of a just-written
    checkpoint).  Returns True when corruption was applied."""
    plan = _active_plan()
    if plan is None:
        return False
    hit = False
    for rule in plan.rules:
        if rule["point"] != point or rule["mode"] != "corrupt":
            continue
        if not _matches_path(rule, path):
            continue
        if not _armed_call(rule, plan.state_dir, lo, hi):
            continue
        _obs_fault(rule, point, lo, hi, path)
        _count_fault_metric("corrupt")
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                # 16 bytes at seven offsets across the file: a single
                # mid-file flip can land in npz/zip alignment padding no
                # loader parses, which would make it benign.
                for k in range(1, 8):
                    off = size * k // 8
                    fh.seek(off)
                    chunk = fh.read(16)
                    fh.seek(off)
                    fh.write(bytes(b ^ 0xFF for b in chunk))
            hit = True
        except OSError:
            pass
    return hit


def short_write(point: str, path: str) -> Optional[float]:
    """Short-write hook: when a "shortwrite" rule at ``point`` fires, the
    fraction of the payload that survives (the durable-I/O layer
    truncates its temp to it and publishes as if all was well); None
    when nothing fired."""
    plan = _active_plan()
    if plan is None:
        return None
    for rule in plan.rules:
        if rule["point"] != point or rule["mode"] != "shortwrite":
            continue
        if not _matches_path(rule, path):
            continue
        if not _armed_call(rule, plan.state_dir):
            continue
        _count_fault_metric("shortwrite")
        return float(rule.get("fraction", 0.5))
    return None


def lost_fsync(point: str, path: str) -> bool:
    """Lost-fsync hook, called just before a finished temp is renamed
    over ``path``: when a "lost_fsync" rule fires, the target's pre-write
    state (its bytes, or its absence) is recorded for
    ``_replay_lost_fsyncs``.  The write proceeds and the caller sees
    success.  Returns True when a record was made."""
    plan = _active_plan()
    if plan is None:
        return False
    hit = False
    for rule in plan.rules:
        if rule["point"] != point or rule["mode"] != "lost_fsync":
            continue
        if not _matches_path(rule, path):
            continue
        if not _armed_call(rule, plan.state_dir):
            continue
        _count_fault_metric("lost_fsync")
        try:
            _record_lost_fsync(plan.state_dir, path)
            hit = True
        except OSError:
            pass  # unwritable state dir: fail open
    return hit


def _record_lost_fsync(state_dir: str, path: str) -> None:
    """Snapshot ``path``'s pre-write state for a later rollback."""
    d = os.path.join(state_dir, _LOST_DIR)
    os.makedirs(d, exist_ok=True)
    target = os.path.abspath(path)
    for n in range(_MAX_CALLS):
        rec_path = os.path.join(d, f"rec.{n}.json")
        try:
            fd = os.open(rec_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        existed = os.path.exists(target)
        if existed:
            shutil.copy2(target, rec_path + ".bak")
        try:
            os.write(fd, json.dumps({"path": target,
                                     "existed": existed}).encode())
        finally:
            os.close(fd)
        return
    raise OSError("lost-fsync record slots exhausted")


def _replay_lost_fsyncs(state_dir: str) -> int:
    """Roll back every recorded lost fsync: restore the pre-write bytes,
    or remove the file that never landed.  Each record is claimed by a
    rename to ``.done`` first, so it applies once.  Returns the number of
    files rolled back."""
    d = os.path.join(state_dir, _LOST_DIR)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return 0
    replayed = 0
    for name in names:
        if not (name.startswith("rec.") and name.endswith(".json")):
            continue
        rec_path = os.path.join(d, name)
        done_path = rec_path + ".done"
        try:
            os.rename(rec_path, done_path)
        except OSError:
            continue  # another process claimed this record
        try:
            with open(done_path) as fh:
                rec = json.load(fh)
            if rec.get("existed"):
                shutil.copy2(rec_path + ".bak", rec["path"])
            else:
                try:
                    os.remove(rec["path"])
                except FileNotFoundError:
                    pass
            replayed += 1
        except (OSError, ValueError, KeyError):
            continue  # torn record: skip
    return replayed
