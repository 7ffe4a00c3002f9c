"""Engine replica pool: the serving read path scaled out horizontally
(the port's copy of the JAX package's ``serve/pool.py``).

One ``PredictionEngine`` process is a single failure domain — its death
takes every forecast consumer with it.  This module puts N engine
REPLICA PROCESSES behind a single front:

* **Replicas** (``run_replica``, spawned as ``python -m
  tsspark_tpu_torch.serve.replica``) each own a full engine over the shared
  ``ParamRegistry`` and serve the daemon's JSONL envelope over a
  unix-domain socket.  Every replica holds a **lease on its slot**
  (the orchestrate chunk-lease machinery reused on ``[slot, slot+1)``),
  renews it from its heartbeat thread, and **fences every response** on
  still holding it: a zombie replica revived after its slot was stolen
  answers ``fenced`` errors, never data — the split-brain guarantee
  that a stale parameter version cannot be served by a replaced
  process.
* **The front** (``ReplicaPool``) shards requests by series key
  (``shard_of`` — stable CRC32 of the first series id), health-checks
  replicas via heartbeat files, wraps each replica in its own
  ``CircuitBreaker``, and **fails over** a request to the next sibling
  slot when a replica dies mid-request, its breaker is open, or it
  answers ``fenced`` — transport failures are retried on siblings, so a
  single replica kill costs zero non-shed requests.  Dead or wedged
  replicas are respawned under ``RetryPolicy`` backoff; the replacement
  process claims the slot lease itself, so the lease (not the front's
  opinion) arbitrates which process owns a slot.
* **Version discipline**: the front stamps ``expect_version`` into
  every routed request; replicas refresh on mismatch and answer a
  structured ``version-mismatch`` error rather than serving a version
  the front did not expect — closing the stale-read window between an
  activation and a replica's refresh.  ``ReplicaPool.activate`` flips a
  version by first publishing its serve artifacts (the forecast and
  quantile planes, the kernel bank), then **materializing** hot
  forecasts for the new version into every replica's version-keyed
  cache (``PredictionEngine.materialize`` — ahead-of-time compute
  against a prefetched snapshot), then flipping the registry pointer,
  then draining replicas one at a time through an explicit refresh — the
  first post-flip requests are cache hits on a prefetched snapshot.
* **Front crash tolerance**: the pool's state (slot → socket/pid/gen)
  is persisted in ``pool.json``; ``ReplicaPool.attach`` rebuilds a
  front over the LIVE replicas of a dead one without restarting them.

The wire protocol is the serve daemon's JSONL envelope plus control
commands (``ping`` / ``stats`` / ``metrics`` / ``warm`` / ``refresh`` /
``quit``) and two extra response fields: ``replica`` (the answering
slot) and the structured ``fenced`` / ``version-mismatch`` errors.

Replicas run on the card: each is its own process with its own CUDA
context and serves through the kernel library's K1 (``forward``) and K2
(``bands``).  ``ReplicaPool(device="cpu")`` spawns them with ``--device
cpu`` (the plain versions); without a card and without that request a
replica fails loudly at its first dispatch.  A replica's ``stats``
carries its kernel launch counts and its library's loads and builds
(``kernels``), and whether its first forecast built the library.  A
card replica loads the kernel library before it serves; one that cannot
exits with ``RC_NO_LIBRARY`` (nothing serves the plain versions in its
place), and the front counts every replica exit it sees by exit code
(``stats()["spawn_exits"]``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from tsspark_tpu_torch.io import atomic_write, current_state, stale_serving
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
from tsspark_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from tsspark_tpu_torch.serve.engine import ServeError

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))
))

#: Replica exit codes (the spawner reads them off ``Popen.poll``).
RC_LEASE_HELD = 3      # slot lease is live under another process
RC_FENCED = 4          # lease lost while serving (replaced); clean exit
RC_NO_LIBRARY = 5      # the kernel library would not build or load

_POOL_STATE = "pool.json"


class PoolError(ServeError):
    """Base of the pool front's structured errors."""

    reason = "pool-error"


class NoReplicaAvailable(PoolError):
    """Every candidate replica for a request's shard order was dead,
    fenced, or breaker-open — the request could not be placed."""

    reason = "no-replica"


class ReplicaFenced(ServeError):
    """The answering replica no longer holds its slot lease (it was
    replaced while stalled); it refuses to serve data."""

    reason = "fenced"


class VersionMismatch(ServeError):
    """The replica's served version differs from the version the front
    stamped into the request, even after a forced refresh."""

    reason = "version-mismatch"

    def __init__(self, served, expected):
        self.served = served
        self.expected = expected
        super().__init__(
            f"replica serves version {served}, front expected {expected}"
        )

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["served"] = self.served
        d["expected"] = self.expected
        return d


def shard_of(series_id, n_shards: int) -> int:
    """Stable shard of a series key: CRC32 of the id string.  Requests
    route to the shard of their FIRST series id; the failover order for
    shard ``s`` is ``s, s+1, ... (mod n)``."""
    return zlib.crc32(str(series_id).encode()) % max(1, int(n_shards))


def _slot_token(slot: int) -> str:
    return f"pool{slot}.{os.getpid()}.{int(time.time() * 1e3)}"


def _hb_path(pool_dir: str, slot: int) -> str:
    return os.path.join(pool_dir, f"poolhb_{slot}")


def _send_line(sock: socket.socket, obj: Dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


class _LineReader:
    """Newline-framed reads over a socket with manual buffering.

    ``socket.makefile()`` is documented-unsafe under a timeout (a
    timeout mid-read leaves the buffered file object in an inconsistent
    state); manual ``recv`` buffering keeps partial lines intact across
    timeouts, which the replica's poll-for-stop read loop hits
    constantly on idle connections."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def readline(self, poll_s: Optional[float] = None) -> Optional[bytes]:
        """One full line (without the newline), or None on EOF.
        ``socket.timeout`` propagates with the partial line preserved.

        ``poll_s``: wait for readability via ``select`` instead of the
        socket timeout — the server side keeps its accepted sockets
        BLOCKING (a shared socket timeout would also cap ``sendall``,
        and a response stream larger than the socket buffer would then
        tear the connection whenever the peer drains another socket
        first) and polls reads here."""
        while b"\n" not in self.buf:
            if poll_s is not None:
                ready, _, _ = select.select([self.sock], [], [], poll_s)
                if not ready:
                    raise socket.timeout()
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return line


def _pid_alive(pid: Optional[int]) -> bool:
    if not pid or pid <= 0:
        return False
    try:
        os.kill(int(pid), 0)
        return True
    except OSError:
        return False


# ---------------------------------------------------------------------------
# the replica process
# ---------------------------------------------------------------------------


class _Replica:
    """One replica's server loop: engine + UDS JSONL + lease fencing.

    Runs inside its own process (``run_replica``).  The slot lease is
    claimed before the engine attaches and renewed from the heartbeat
    thread; ``fenced`` flips the moment a renewal finds the lease under
    a foreign token, after which every forecast response is the
    structured ``fenced`` error and the process exits after a short
    grace window (long enough for probes to observe the refusal)."""

    def __init__(self, pool_dir: str, slot: int, registry_root: str,
                 socket_path: str, *, gen: int = 1,
                 heartbeat_s: float = 0.25, lease_ttl_s: float = 1.5,
                 max_queue: int = 4096, max_batch: int = 128,
                 cache_capacity: Optional[int] = None,
                 fence_grace_s: float = 8.0, device: Optional[str] = None,
                 bank: Optional[Dict] = None):
        self.pool_dir = pool_dir
        self.slot = int(slot)
        self.gen = int(gen)
        self.registry_root = registry_root
        self.socket_path = socket_path
        self.heartbeat_s = float(heartbeat_s)
        self.lease_ttl_s = float(lease_ttl_s)
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.cache_capacity = (None if cache_capacity is None
                               else int(cache_capacity))
        self.fence_grace_s = float(fence_grace_s)
        self.device = device
        # The kernel bank's arming outcome (aotbank.arm_from_env), or None.
        self.bank = bank
        # Library builds before the first forecast's dispatch, and after
        # it (None until the first forecast is answered).
        self._first_builds: Optional[Tuple[int, int]] = None
        self._builds_at_start: Optional[int] = None
        self._first_lock = threading.Lock()
        self.token = _slot_token(self.slot)
        self.fenced = threading.Event()
        self.stop = threading.Event()
        self.engine = None
        self.registry = None

    # -- lease fencing ---------------------------------------------------------

    def _claim_slot(self) -> bool:
        from tsspark_tpu_torch import orchestrate

        return orchestrate.claim_lease(
            self.pool_dir, self.slot, self.slot + 1, self.token,
            ttl_s=self.lease_ttl_s,
        )

    def _holds_slot(self) -> bool:
        from tsspark_tpu_torch import orchestrate

        return orchestrate.holds_lease(
            self.pool_dir, self.slot, self.slot + 1, self.token
        )

    def _heartbeat(self) -> None:
        # This thread touches the filesystem and the lease, never the
        # device.
        hb = _hb_path(self.pool_dir, self.slot)
        m_shed = METRICS.gauge("tsspark_pool_replica_shed",
                               replica=str(self.slot))
        m_q = METRICS.gauge("tsspark_pool_replica_queue",
                            replica=str(self.slot))
        try:
            while not self.stop.is_set():
                try:
                    os.utime(hb)
                except OSError:
                    pass
                if not self._claim_slot():
                    # Renewal refused: a replacement owns the slot.
                    # Flip to fenced and let the grace timer end the
                    # process — in-flight probes must observe the
                    # structured refusal.
                    self.fenced.set()
                    obs.event("replica.fenced", slot=self.slot,
                              pid=os.getpid())
                    # One-shot grace timer whose only action is
                    # stop.set; run() exits when it fires.
                    threading.Timer(self.fence_grace_s,
                                    self.stop.set).start()
                    return
                if self.engine is not None:
                    m_shed.set(float(self.engine.stats.shed))
                    m_q.set(float(self.engine.stats.submitted
                                  - self.engine.stats.completed
                                  - self.engine.stats.shed
                                  - self.engine.stats.failed))
                self.stop.wait(self.heartbeat_s)
        except Exception as e:
            # A dying heartbeat must take the replica down VISIBLY:
            # with renewals stopped the lease lapses and the front
            # respawns the slot — but only if this process also stops
            # serving instead of running on silently past its fence.
            obs.event("replica.heartbeat_failed", slot=self.slot,
                      pid=os.getpid(), error=repr(e))
            self.stop.set()

    # -- request handling ------------------------------------------------------

    def _error(self, rid, err: Dict) -> Dict:
        return {"ok": False, "id": rid, "replica": self.slot,
                "error": err}

    def _handle_cmd(self, msg: Dict) -> Dict:
        rid = msg.get("id")
        cmd = msg["cmd"]
        if cmd == "ping":
            return {"ok": True, "id": rid, "replica": self.slot,
                    "pid": os.getpid(), "gen": self.gen,
                    "fenced": self.fenced.is_set(),
                    "version": self.engine.served_version()}
        if cmd == "stats":
            return {"ok": True, "id": rid, "replica": self.slot,
                    "pid": os.getpid(), "gen": self.gen,
                    "stats": self.engine.stats.snapshot(),
                    "cache": self.engine.cache.stats(),
                    "kernels": self._kernel_counts(),
                    "version": self.engine.served_version()}
        if cmd == "metrics":
            return {"ok": True, "id": rid, "replica": self.slot,
                    "prometheus": METRICS.to_prometheus()}
        if cmd == "warm":
            horizons = msg.get("horizons") or (7,)
            warmed = self.engine.materialize(
                msg.get("series_ids") or (),
                horizons,
                version=msg.get("version"),
            )
            ladder = None
            if self.bank is not None and self.bank.get("armed"):
                # The bank's shape ladder, each shape launched once:
                # the library's load and every shape's first launch
                # happen here, before traffic.
                from tsspark_tpu_torch.serve import aotbank

                snap = self.registry.load()
                ladder = aotbank.warm_ladder(
                    snap, self.engine.backend,
                    aotbank.shape_ladder(len(snap.series_ids), horizons),
                )
            return {"ok": True, "id": rid, "replica": self.slot,
                    "warmed": warmed, "version": msg.get("version"),
                    "ladder": ladder}
        if cmd == "refresh":
            target = msg.get("version")
            if target is not None:
                self.engine.ensure_version(int(target))
            else:
                self.engine.ensure_version(-1)  # any flip: force reload
            return {"ok": True, "id": rid, "replica": self.slot,
                    "version": self.engine.served_version()}
        if cmd == "quantiles":
            # Interval read: synchronous on the engine (plane gather or
            # row-local compute fallback — no dispatch pump involved).
            import numpy as np

            if self.fenced.is_set():
                return self._error(rid, ReplicaFenced(
                    f"slot {self.slot} lease lost"
                ).to_dict())
            try:
                res = self.engine.quantiles(
                    msg["series_ids"], int(msg["horizon"]),
                    quantiles=msg.get("quantiles"),
                )
            except ServeError as e:
                return self._error(rid, e.to_dict())
            except (KeyError, TypeError, ValueError) as e:
                return self._error(rid, {"type": "BadRequest",
                                         "detail": str(e)})
            return {
                "ok": True, "id": rid, "replica": self.slot,
                "version": res.version,
                "latency_ms": round(res.latency_s * 1e3, 3),
                "from_cache": res.from_cache,
                "series_ids": list(res.series_ids),
                "ds": np.asarray(res.ds).tolist(),
                **{k: np.asarray(v).tolist()
                   for k, v in res.values.items()},
            }
        if cmd == "quit":
            self.stop.set()
            return {"ok": True, "id": rid, "replica": self.slot}
        return self._error(rid, {"type": "BadRequest",
                                 "detail": f"unknown cmd {cmd!r}"})

    def _kernel_counts(self) -> Dict:
        """This process's kernel launches (K1 ``forward``, K2 ``bands``),
        its kernel library's loads and builds, where it loaded from, and
        the builds seen around the first forecast."""
        from tsspark_tpu_torch.kernels import bands, build, forward

        first = self._first_builds
        widths: Dict[str, int] = {}
        for _, width, _ in list(self.engine.stats.occupancy):
            widths[str(width)] = widths.get(str(width), 0) + 1
        return {
            "forward": forward.launches, "bands": bands.launches,
            "dispatch_widths": widths,
            "library_loads": build.loads, "library_builds": build.builds,
            "build_s": build.build_seconds, "build_dir": build.build_dir(),
            "first_request_builds": (None if first is None
                                     else first[1] - first[0]),
            "bank": self.bank,
        }

    def _respond_forecast(self, rid, expect, pend) -> Dict:
        """Resolve one pending forecast into a response line, enforcing
        the lease fence and the front's version expectation AT RESPOND
        TIME (the analog of the fit worker's save-time fence).  Nothing
        reachable from here builds, touches durable storage, or
        spawns."""
        import numpy as np

        from tsspark_tpu_torch.serve.registry import RegistryError

        try:
            res = pend.result(timeout=60.0)
        except ServeError as e:
            return self._error(rid, e.to_dict())
        except RegistryError as e:
            return self._error(rid, {"type": "RegistryError",
                                     "reason": e.reason,
                                     "detail": str(e)})
        except Exception as e:  # engine bug / timeout: structured out
            return self._error(rid, {"type": type(e).__name__,
                                     "reason": "internal",
                                     "detail": str(e)})
        if expect is not None and res.version != expect:
            # The stamp and the served version disagree.  Serving a
            # version that IS the registry's current active pointer is
            # legitimate (the stamp simply predates a flip that landed
            # mid-flight); anything else is the stale-read window the
            # stamping protocol exists to close — reject it.
            try:
                active = self.registry.active_version()
            except Exception:
                active = None
            if res.version != active:
                return self._error(
                    rid, VersionMismatch(res.version, expect).to_dict()
                )
        if self.fenced.is_set() or not self._holds_slot():
            self.fenced.set()
            return self._error(rid, ReplicaFenced(
                f"slot {self.slot} lease lost (pid {os.getpid()})"
            ).to_dict())
        with self._first_lock:
            if self._first_builds is None and self._builds_at_start \
                    is not None:
                from tsspark_tpu_torch.perf import CompileWatch

                self._first_builds = (self._builds_at_start,
                                      CompileWatch.builds_only().size())
        return {
            "ok": True, "id": rid, "replica": self.slot,
            "version": res.version,
            "latency_ms": round(res.latency_s * 1e3, 3),
            "from_cache": res.from_cache,
            "series_ids": list(res.series_ids),
            "ds": np.asarray(res.ds).tolist(),
            **{k: np.asarray(v).tolist()
               for k, v in res.values.items()},
        }

    def _serve_conn(self, conn: socket.socket) -> None:
        from tsspark_tpu_torch.serve.engine import (
            EngineOverloaded,
            ForecastRequest,
        )

        # Blocking socket: writes must never share a read-poll timeout
        # (see _LineReader.readline) — the reader polls via select.
        conn.settimeout(None)
        rfile = _LineReader(conn)
        wlock = threading.Lock()
        pending = []  # (rid, expect_version, PendingForecast)
        cond = threading.Condition()
        done = threading.Event()

        def write(obj: Dict) -> bool:
            try:
                with wlock:
                    _send_line(conn, obj)
                return True
            except OSError:
                done.set()
                return False

        def writer() -> None:
            while True:
                with cond:
                    while not pending and not done.is_set():
                        cond.wait(0.2)
                    if not pending:
                        if done.is_set():
                            return
                        continue
                    rid, expect, pend = pending.pop(0)
                try:
                    resp = self._respond_forecast(rid, expect, pend)
                except Exception as e:
                    # The writer must answer EVERY submitted request: a
                    # dead writer wedges the client on this connection
                    # until its timeout, then the whole group fails
                    # over — one escaped response must not cost that.
                    resp = self._error(rid, {"type": type(e).__name__,
                                             "reason": "internal",
                                             "detail": str(e)})
                write(resp)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        try:
            while not self.stop.is_set():
                try:
                    line = rfile.readline(poll_s=0.5)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if line is None:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError as e:
                    write(self._error(None, {"type": "BadRequest",
                                             "detail": str(e)}))
                    continue
                if msg.get("cmd"):
                    try:
                        write(self._handle_cmd(msg))
                    except Exception as e:
                        write(self._error(msg.get("id"),
                                          {"type": type(e).__name__,
                                           "reason": "internal",
                                           "detail": str(e)}))
                    continue
                rid = msg.get("id")
                if self.fenced.is_set():
                    write(self._error(rid, ReplicaFenced(
                        f"slot {self.slot} lease lost"
                    ).to_dict()))
                    continue
                expect = msg.get("expect_version")
                expect = None if expect is None else int(expect)
                if (expect is not None
                        and self.engine.served_version() != expect):
                    # Submit-time refresh: don't dispatch a whole batch
                    # at a version the front already moved past.
                    self.engine.ensure_version(expect)
                deadline_ms = msg.get("deadline_ms")
                try:
                    req = ForecastRequest.make(
                        msg["series_ids"], int(msg["horizon"]),
                        num_samples=int(msg.get("num_samples", 0)),
                        seed=int(msg.get("seed", 0)),
                        deadline_in_s=(None if deadline_ms is None
                                       else float(deadline_ms) / 1e3),
                    )
                    pend = self.engine.submit(req)
                except EngineOverloaded as e:
                    write(self._error(rid, e.to_dict()))
                    continue
                except (KeyError, TypeError, ValueError) as e:
                    write(self._error(rid, {"type": "BadRequest",
                                            "detail": str(e)}))
                    continue
                with cond:
                    pending.append((rid, expect, pend))
                    cond.notify()
        finally:
            done.set()
            with cond:
                cond.notify()
            wt.join(timeout=2.0)
            try:
                conn.close()
            except OSError:
                pass

    # -- the process body ------------------------------------------------------

    def run(self) -> int:
        from tsspark_tpu_torch.device import resolve_device
        from tsspark_tpu_torch.perf import CompileWatch
        from tsspark_tpu_torch.serve.cache import ForecastCache
        from tsspark_tpu_torch.serve.engine import PredictionEngine
        from tsspark_tpu_torch.serve.registry import ParamRegistry

        os.makedirs(self.pool_dir, exist_ok=True)
        if not self._claim_slot():
            return RC_LEASE_HELD
        hb = _hb_path(self.pool_dir, self.slot)
        open(hb, "a").close()
        self._builds_at_start = CompileWatch.builds_only().size()
        # Without a card, a replica not asked for the CPU raises here.
        if resolve_device(self.device).type == "cuda":
            # The card's kernels load (or build) before serving: a
            # replica without them exits instead of serving the plain
            # versions.
            from tsspark_tpu_torch.kernels import build

            try:
                build.library()
            except Exception as e:
                obs.event("replica.no_library", slot=self.slot,
                          pid=os.getpid(), error=repr(e))
                print(f"replica {self.slot}: kernel library: {e!r}",
                      file=sys.stderr, flush=True)
                return RC_NO_LIBRARY

        self.registry = ParamRegistry.open(self.registry_root)
        self.engine = PredictionEngine(
            self.registry, device=self.device,
            max_queue=self.max_queue, max_batch=self.max_batch,
            cache=ForecastCache(capacity=self.cache_capacity),
            retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.01,
                                     backoff=2.0, max_delay_s=0.1),
            breaker=CircuitBreaker(failure_threshold=3,
                                   reset_timeout_s=0.5,
                                   name=f"replica{self.slot}-backend"),
        )
        self.engine.start(poll_s=0.002)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.socket_path)
        srv.listen(64)
        srv.settimeout(0.25)
        hb_t = threading.Thread(target=self._heartbeat, daemon=True)
        hb_t.start()
        obs.event("replica.start", slot=self.slot, pid=os.getpid(),
                  gen=self.gen)
        try:
            while not self.stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                # Per-connection daemon threads live as long as their
                # connection: each closes its conn in a finally, and the
                # client observes EOF and fails over.
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            self.stop.set()
            try:
                srv.close()
            except OSError:
                pass
            self.engine.stop()
            hb_t.join(timeout=2.0)
            if self.fenced.is_set():
                return RC_FENCED
            # Clean shutdown releases the slot for an instant successor.
            from tsspark_tpu_torch import orchestrate

            orchestrate.release_lease(self.pool_dir, self.slot,
                                      self.slot + 1, self.token)
        return 0


def run_replica(pool_dir: str, slot: int, registry_root: str,
                socket_path: str, **kwargs) -> int:
    """Entry point for one replica process (see ``_Replica``)."""
    return _Replica(pool_dir, slot, registry_root, socket_path,
                    **kwargs).run()


# ---------------------------------------------------------------------------
# the front
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicaInfo:
    """Front-side view of one slot."""

    slot: int
    gen: int = 0
    socket_path: str = ""
    pid: Optional[int] = None
    proc: Optional[subprocess.Popen] = None
    draining: bool = False
    fail_streak: int = 0
    next_respawn: float = 0.0
    breaker: Optional[CircuitBreaker] = None
    # ``time.monotonic()`` when the last spawn started, and when that
    # spawn first answered ping (None until it does).
    spawn_t: Optional[float] = None
    ready_t: Optional[float] = None


class _Conn:
    """One persistent client connection to a replica socket.

    Responses are matched by REQUEST ID, never by arrival order: a
    connection that still has another pipelined wave's responses in
    flight (the failover path re-routes individual requests onto a
    sibling mid-wave) must not hand those bytes to the wrong caller.
    Unclaimed responses are stashed for their own reader; the stash is
    bounded — an abandoned response (its request was re-routed after a
    timeout) ages out instead of leaking."""

    _STASH_CAP = 4096

    def __init__(self, path: str, gen: int, timeout_s: float):
        self.path = path
        self.gen = gen
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout_s)
        self.sock.connect(path)
        self.rfile = _LineReader(self.sock)
        self.stash: Dict[str, Dict] = {}

    def send(self, obj: Dict) -> None:
        _send_line(self.sock, obj)

    def _recv_raw(self) -> Dict:
        line = self.rfile.readline()
        if line is None:
            raise ConnectionError(f"replica at {self.path} closed")
        return json.loads(line)

    def recv_for(self, rid) -> Dict:
        """The response whose ``id`` matches ``rid`` (stashing any
        other wave's responses that arrive first)."""
        rid = str(rid)
        if rid in self.stash:
            return self.stash.pop(rid)
        while True:
            resp = self._recv_raw()
            got = str(resp.get("id"))
            if got == rid:
                return resp
            while len(self.stash) >= self._STASH_CAP:
                self.stash.pop(next(iter(self.stash)))
            self.stash[got] = resp

    def request(self, obj: Dict) -> Dict:
        self.send(obj)
        return self.recv_for(obj.get("id"))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ReplicaPool:
    """The pool front: spawn/attach, shard-route, fail over, respawn.

    Thread-safe for concurrent request threads (each thread keeps its
    own socket connections; breakers, routing state, and counters are
    shared).  ``ensure_alive`` is the health step — call it from a
    watch thread (``start_watch``) or inline between request waves."""

    def __init__(self, pool_dir: str, registry_root: str,
                 n_replicas: int = 2, *,
                 heartbeat_s: float = 0.25,
                 stale_after_s: Optional[float] = None,
                 lease_ttl_s: Optional[float] = None,
                 request_timeout_s: float = 60.0,
                 spawn_timeout_s: float = 120.0,
                 respawn_policy: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 0.5,
                 max_queue: int = 4096, max_batch: int = 128,
                 cache_capacity: Optional[int] = None,
                 hot_horizons: Sequence[int] = (7, 14, 28),
                 device: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
        """``device``: the replicas' device (``--device``); None is the
        card.  The front's own publishes at ``activate`` run there too.
        ``env``: variables set in the replicas' environment on top of
        this process's (e.g. ``$TSSPARK_AOT_CACHE_DIR``)."""
        from tsspark_tpu_torch.serve.registry import ParamRegistry

        self.pool_dir = os.path.abspath(pool_dir)
        self.registry_root = os.path.abspath(registry_root)
        self.n_replicas = int(n_replicas)
        self.heartbeat_s = float(heartbeat_s)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else 5.0 * self.heartbeat_s)
        self.lease_ttl_s = (float(lease_ttl_s)
                            if lease_ttl_s is not None
                            else 8.0 * self.heartbeat_s)
        self.request_timeout_s = float(request_timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.respawn_policy = respawn_policy or RetryPolicy(
            max_attempts=None, base_delay_s=0.2, backoff=2.0,
            max_delay_s=2.0,
        )
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.cache_capacity = (None if cache_capacity is None
                               else int(cache_capacity))
        self.hot_horizons = tuple(int(h) for h in hot_horizons)
        self.device = device
        self.env = dict(env or {})
        os.makedirs(self.pool_dir, exist_ok=True)
        self.registry = ParamRegistry.open(self.registry_root)
        self.expected_version = self.registry.active_version()
        self.replicas: Dict[int, ReplicaInfo] = {
            k: ReplicaInfo(
                slot=k,
                breaker=CircuitBreaker(
                    failure_threshold=int(breaker_threshold),
                    reset_timeout_s=float(breaker_reset_s),
                    name=f"replica{k}",
                ),
            )
            for k in range(self.n_replicas)
        }
        # _lock serializes lifecycle passes (spawn/ensure_alive) ONLY —
        # the request path must never wait behind a multi-second
        # respawn, so it uses the dedicated locks below.
        self._lock = threading.RLock()
        self._activate_lock = threading.Lock()
        # Serializes pool.json writes (spawns run in parallel threads and
        # share one temp-file name).
        self._state_lock = threading.Lock()
        self._local = threading.local()
        self._watch: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._rid = 0
        self._rid_lock = threading.Lock()
        # Pool counters (also mirrored into the obs metrics registry —
        # the "pool gauges" the SLO watcher and loadgen report read).
        # Guarded by _count_lock: `+= 1` from concurrent client threads
        # is load/add/store bytecode, and wrong_version in particular
        # is an invariant pinned at exactly zero — a lost increment
        # would hide a real stale read.
        self._count_lock = threading.Lock()
        self.failovers = 0
        self.respawns = 0
        # Replica exits seen at spawn or health checks, by exit code.
        self.spawn_exits: Dict[str, int] = {}
        self.wrong_version = 0
        self.fenced_seen = 0
        self._m_alive = METRICS.gauge("tsspark_pool_replicas_alive")
        self._m_failovers = METRICS.counter("tsspark_pool_failovers_total")
        self._m_respawns = METRICS.counter("tsspark_pool_respawns_total")
        self._m_wrongv = METRICS.counter(
            "tsspark_pool_wrong_version_total"
        )

    # -- lifecycle -------------------------------------------------------------

    def _spawn_cmd(self, info: ReplicaInfo) -> List[str]:
        cmd = [
            sys.executable, "-m", "tsspark_tpu_torch.serve.replica",
            "--pool-dir", self.pool_dir,
            "--slot", str(info.slot),
            "--registry", self.registry_root,
            "--socket", info.socket_path,
            "--gen", str(info.gen),
            "--heartbeat-s", str(self.heartbeat_s),
            "--lease-ttl-s", str(self.lease_ttl_s),
            "--max-queue", str(self.max_queue),
            "--max-batch", str(self.max_batch),
        ]
        if self.cache_capacity is not None:
            cmd += ["--cache-capacity", str(self.cache_capacity)]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        return cmd

    def _child_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        parts = [_REPO_ROOT] + (
            [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []
        )
        env["PYTHONPATH"] = os.pathsep.join(parts)
        env.update(self.env)
        obs.inject_env(env)
        return env

    def _spawn(self, slot: int) -> bool:
        """Start (or restart) the replica for ``slot``; True when it
        answers ping before ``spawn_timeout_s``.  The child claims the
        slot lease itself — a spawn against a LIVE lease exits
        ``RC_LEASE_HELD`` and this returns False (the backoff loop in
        ``ensure_alive`` retries after the lease expires)."""
        info = self.replicas[slot]
        info.gen += 1
        info.socket_path = os.path.join(
            self.pool_dir, f"replica_{slot}.g{info.gen}.sock"
        )
        info.spawn_t, info.ready_t = time.monotonic(), None
        info.proc = subprocess.Popen(
            self._spawn_cmd(info), env=self._child_env(),
            stdout=sys.stderr, stderr=sys.stderr,
        )
        info.pid = info.proc.pid
        t0 = time.monotonic()
        while time.monotonic() - t0 < self.spawn_timeout_s:
            if info.proc.poll() is not None:
                self._note_exit(info.proc.returncode)
                return False
            try:
                conn = _Conn(info.socket_path, info.gen, 5.0)
                try:
                    resp = conn.request({"cmd": "ping"})
                finally:
                    conn.close()
                if resp.get("ok"):
                    info.ready_t = time.monotonic()
                    info.breaker.record_success()
                    self._write_state()
                    return True
            except (OSError, ValueError, ConnectionError):
                time.sleep(0.05)
        return False

    def start(self) -> "ReplicaPool":
        """Spawn every replica and wait until each answers ping."""
        # The lifecycle lock is held across the spawn waits by design: it
        # serializes spawn/health/stop passes only, and the request path
        # never takes it.  All replicas start at once (each pays its
        # interpreter, torch import and CUDA context in parallel).
        with self._lock:
            errors: Dict[int, str] = {}

            def one(slot: int) -> None:
                deadline = time.monotonic() + self.spawn_timeout_s
                while not self._spawn(slot):
                    if time.monotonic() > deadline:
                        errors[slot] = (f"replica {slot} failed to start "
                                        f"within {self.spawn_timeout_s}s")
                        return
                    time.sleep(0.2)

            threads = [threading.Thread(target=one, args=(slot,))
                       for slot in range(self.n_replicas)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise PoolError("; ".join(errors.values()))
            self._write_state()
            self._m_alive.set(float(self.n_replicas))
        return self

    @classmethod
    def attach(cls, pool_dir: str, **kwargs) -> "ReplicaPool":
        """Rebuild a front over an existing pool (front-crash recovery):
        live replicas are adopted as-is (their leases and engines keep
        serving), dead slots are respawned."""
        with open(os.path.join(pool_dir, _POOL_STATE)) as fh:
            state = json.load(fh)
        pool = cls(pool_dir, state["registry"],
                   n_replicas=int(state["n_replicas"]), **kwargs)
        with pool._lock:
            for key, rec in (state.get("replicas") or {}).items():
                slot = int(key)
                if slot not in pool.replicas:
                    continue
                info = pool.replicas[slot]
                info.gen = int(rec.get("gen", 1))
                info.socket_path = rec.get("socket", "")
                info.pid = rec.get("pid")
                info.proc = None  # not our child; liveness via pid/hb
            for slot in range(pool.n_replicas):
                if pool.ping(slot) is None:
                    pool._spawn(slot)
        return pool

    def _write_state(self) -> None:
        with self._state_lock:
            self._write_state_locked()

    def _write_state_locked(self) -> None:
        state = {
            "n_replicas": self.n_replicas,
            "registry": self.registry_root,
            "expected_version": self.expected_version,
            "replicas": {
                str(k): {"socket": i.socket_path, "pid": i.pid,
                         "gen": i.gen}
                for k, i in self.replicas.items()
            },
        }
        atomic_write(
            os.path.join(self.pool_dir, _POOL_STATE),
            lambda fh: json.dump(state, fh, indent=1), mode="w",
        )

    def stop(self) -> None:
        self.stop_watch()
        # The lifecycle lock across terminate/wait: teardown must exclude
        # a concurrent health pass respawning what it just killed.
        with self._lock:
            for info in self.replicas.values():
                try:
                    self._request_slot(info.slot, {"cmd": "quit"},
                                       timeout_s=2.0)
                except Exception:
                    pass
                if info.proc is not None:
                    try:
                        info.proc.terminate()
                        info.proc.wait(timeout=5.0)
                    except Exception:
                        try:
                            info.proc.kill()
                        except OSError:
                            pass
                elif _pid_alive(info.pid):
                    try:
                        os.kill(int(info.pid), signal.SIGTERM)
                    except OSError:
                        pass
        self.close_front()

    def close_front(self) -> None:
        """Drop this thread's connections (front teardown; replicas keep
        running — ``attach`` builds the successor front)."""
        conns = getattr(self._local, "conns", None) or {}
        for c in conns.values():
            c.close()
        self._local.conns = {}

    # -- health ----------------------------------------------------------------

    def ping(self, slot: int) -> Optional[Dict]:
        try:
            resp = self._request_slot(slot, {"cmd": "ping"},
                                      timeout_s=2.0)
            return resp if resp.get("ok") else None
        except (OSError, ValueError, ConnectionError, PoolError):
            return None

    def alive_count(self) -> int:
        return sum(1 for k in self.replicas if self.ping(k) is not None)

    def _note_exit(self, rc) -> None:
        with self._count_lock:
            key = str(rc)
            self.spawn_exits[key] = self.spawn_exits.get(key, 0) + 1

    def _slot_unhealthy(self, info: ReplicaInfo) -> Optional[str]:
        if info.proc is not None and info.proc.poll() is not None:
            return f"process exited rc={info.proc.poll()}"
        if info.proc is None and not _pid_alive(info.pid):
            return "attached pid is gone"
        try:
            age = time.time() - os.path.getmtime(
                _hb_path(self.pool_dir, info.slot)
            )
        except OSError:
            age = float("inf")
        if age > self.stale_after_s:
            return f"heartbeat stale ({age:.2f}s)"
        return None

    def ensure_alive(self) -> List[int]:
        """One health pass: respawn dead/wedged slots (under the
        respawn policy's backoff).  Returns the slots respawned."""
        respawned: List[int] = []
        # One health pass at a time; the request path routes on breakers
        # and leases without ever taking this lock.
        with self._lock:
            alive = 0
            for slot, info in self.replicas.items():
                why = self._slot_unhealthy(info)
                if why is None:
                    alive += 1
                    continue
                if time.time() < info.next_respawn:
                    continue
                if info.proc is not None and info.proc.poll() is not None:
                    self._note_exit(info.proc.returncode)
                if info.proc is not None and info.proc.poll() is None:
                    # Wedged (stale heartbeat, process alive): kill it;
                    # the lease decides whether the replacement may
                    # actually take over.
                    try:
                        info.proc.kill()
                        info.proc.wait(timeout=5.0)
                    except Exception:
                        pass
                self._bump("respawns")
                self._m_respawns.inc()
                obs.event("pool.respawn", slot=slot, reason=why)
                if self._spawn(slot):
                    info.fail_streak = 0
                    info.next_respawn = 0.0
                    respawned.append(slot)
                    alive += 1
                else:
                    info.fail_streak += 1
                    info.next_respawn = (
                        time.time()
                        + self.respawn_policy.delay_s(info.fail_streak)
                    )
            self._m_alive.set(float(alive))
        return respawned

    def start_watch(self, interval_s: float = 0.3) -> None:
        if self._watch is not None:
            return
        self._watch_stop.clear()

        def loop():
            while not self._watch_stop.is_set():
                try:
                    self.ensure_alive()
                except Exception:
                    pass
                self._watch_stop.wait(interval_s)

        self._watch = threading.Thread(target=loop, name="pool-watch",
                                       daemon=True)
        self._watch.start()

    def stop_watch(self) -> None:
        if self._watch is None:
            return
        self._watch_stop.set()
        self._watch.join(timeout=5.0)
        self._watch = None

    # -- request path ----------------------------------------------------------

    def _conn(self, slot: int) -> _Conn:
        conns: Dict[int, _Conn] = getattr(self._local, "conns", None)
        if conns is None:
            conns = {}
            self._local.conns = conns
        info = self.replicas[slot]
        cur = conns.get(slot)
        if cur is not None and cur.gen == info.gen:
            return cur
        if cur is not None:
            cur.close()
        conn = _Conn(info.socket_path, info.gen,
                     self.request_timeout_s)
        conns[slot] = conn
        return conn

    def _drop_conn(self, slot: int) -> None:
        conns = getattr(self._local, "conns", None) or {}
        cur = conns.pop(slot, None)
        if cur is not None:
            cur.close()

    def _request_slot(self, slot: int, payload: Dict,
                      timeout_s: Optional[float] = None) -> Dict:
        conn = self._conn(slot)
        if timeout_s is not None:
            conn.sock.settimeout(timeout_s)
        try:
            return conn.request(payload)
        finally:
            if timeout_s is not None:
                conn.sock.settimeout(self.request_timeout_s)

    def _bump(self, name: str, n: int = 1) -> None:
        if not n:
            return
        with self._count_lock:
            setattr(self, name, getattr(self, name) + n)

    def _note_served_version(self, resp: Dict,
                             stamped: Optional[int]) -> None:
        """Judge an OK response's version against its own stamp.  A
        response OLDER than the stamp is normally the stale-read window
        (counted in ``wrong_version`` — the chaos invariant pins it at
        zero) — unless the registry's active pointer itself moved back
        (a ROLLBACK landed): then the replica is correct and the front
        adopts the new pointer instead of flagging every response
        forever."""
        version = resp.get("version")
        if stamped is None or version is None or version >= stamped:
            return
        active = self.registry.active_version()
        if version == active:
            # A single store adopting the registry's active pointer:
            # every writer converges to active_version(), so last write
            # wins harmlessly.
            self.expected_version = active
            return
        self._bump("wrong_version")
        self._m_wrongv.inc()

    def _next_rid(self) -> str:
        with self._rid_lock:
            self._rid += 1
            return f"q{self._rid}"

    def shard_order(self, series_ids: Sequence) -> List[int]:
        home = shard_of(series_ids[0], self.n_replicas)
        return [(home + off) % self.n_replicas
                for off in range(self.n_replicas)]

    def forecast(self, series_ids: Sequence, horizon: int,
                 num_samples: int = 0, seed: int = 0,
                 deadline_ms: Optional[float] = None) -> Dict:
        """Route one request; returns the replica's raw response dict
        (``ok`` true with arrays, or a structured error the caller
        inspects).  Transport failures / fenced replicas fail over to
        siblings; only ``NoReplicaAvailable`` raises."""
        payload = {
            "id": self._next_rid(),
            "series_ids": [str(s) for s in series_ids],
            "horizon": int(horizon),
            "num_samples": int(num_samples), "seed": int(seed),
        }
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        resp = self._route(payload)
        if isinstance(resp, dict) and stale_serving(self.registry_root):
            # Ladder rung 4 (stale_serve): the registry root is out of
            # disk, refits are paused, and this answer may be computed
            # from a version older than the landed data.  Keep serving
            # — recency honesty beats an outage — but say so.
            resp["stale"] = True
            resp["disk_ladder"] = current_state(self.registry_root)
        return resp

    def quantiles(self, series_ids: Sequence, horizon: int,
                  quantiles: Optional[Sequence[float]] = None) -> Dict:
        """Route one interval read to the home replica: quantile-plane
        mmap gather on the replica when covered, row-local compute
        fallback otherwise.  Same failover and staleness marking as
        :meth:`forecast`."""
        payload = {
            "id": self._next_rid(), "cmd": "quantiles",
            "series_ids": [str(s) for s in series_ids],
            "horizon": int(horizon),
        }
        if quantiles is not None:
            payload["quantiles"] = [float(q) for q in quantiles]
        resp = self._route(payload)
        if isinstance(resp, dict) and stale_serving(self.registry_root):
            resp["stale"] = True
            resp["disk_ladder"] = current_state(self.registry_root)
        return resp

    def _route(self, payload: Dict,
               skip_slot: Optional[int] = None) -> Dict:
        """``skip_slot``: a slot the caller just observed failing (the
        wave fallback) — excluded so the re-route neither re-sends to a
        known-bad replica nor double-counts its failure.

        A slot that is only draining (an activation's refresh, a bounded
        moment) is waited for rather than failed: when every other
        candidate is down, the request waits out the drain instead of
        failing (up to ``request_timeout_s``)."""
        last_detail = "no replica admitted the request"
        deadline = time.monotonic() + self.request_timeout_s
        while True:
            draining = False
            for slot in self.shard_order(payload["series_ids"]):
                if slot == skip_slot:
                    continue
                if self.replicas[slot].draining:
                    draining = True
                    continue
                resp = self._try_slot(slot, payload)
                if resp is not None:
                    return resp
                last_detail = f"slot {slot} unavailable"
            if not draining or time.monotonic() > deadline:
                raise NoReplicaAvailable(last_detail)
            time.sleep(0.005)

    def _try_slot(self, slot: int, payload: Dict,
                  _retried: bool = False) -> Optional[Dict]:
        """One attempt at one slot; None means 'fail over'."""
        info = self.replicas[slot]
        if info.draining or not info.breaker.allow():
            return None
        payload = dict(payload, expect_version=self.expected_version)
        try:
            resp = self._request_slot(slot, payload)
        except (OSError, ValueError, ConnectionError):
            info.breaker.record_failure()
            self._drop_conn(slot)
            self._bump("failovers")
            self._m_failovers.inc()
            return None
        stamped = payload.get("expect_version")
        if resp.get("ok"):
            info.breaker.record_success()
            self._note_served_version(resp, stamped)
            return resp
        err = resp.get("error") or {}
        reason = err.get("reason")
        if reason == "fenced":
            info.breaker.record_failure()
            self._bump("fenced_seen")
            self._bump("failovers")
            self._m_failovers.inc()
            self._drop_conn(slot)
            return None
        if reason == "version-mismatch" and not _retried:
            # The registry may have flipped under the front (another
            # publisher activated): adopt the current active pointer
            # and retry this slot once before failing over.  The
            # replica ANSWERED — record the success first, or a
            # half-open breaker's single trial slot would be consumed
            # by this attempt and never resolved (the retry's allow()
            # would then refuse the healthy replica forever).
            info.breaker.record_success()
            active = self.registry.active_version()
            if active != self.expected_version:
                self.expected_version = active
            return self._try_slot(slot, payload, _retried=True)
        if reason == "version-mismatch":
            info.breaker.record_failure()
            self._bump("failovers")
            self._m_failovers.inc()
            return None
        # Structured terminal error (shed, unknown series, overloaded,
        # backend breaker): the replica answered — not a failover case.
        info.breaker.record_success()
        return resp

    # -- pipelined waves (the loadgen's hot path) ------------------------------

    def submit_wave(self, requests: List[Dict]) -> Dict[str, Dict]:
        """Send many requests pipelined (grouped per owning replica),
        collect all responses.  Requests left unanswered by a dying
        replica are re-routed individually through the failover path.
        Each request dict needs ``id`` and ``series_ids`` (+ forecast
        fields); returns ``{id: response}``."""
        groups: Dict[int, List[Dict]] = {}
        out: Dict[str, Dict] = {}
        unplaced: List[Dict] = []
        for req in requests:
            placed = False
            for slot in self.shard_order(req["series_ids"]):
                info = self.replicas[slot]
                if info.draining or not info.breaker.allow():
                    continue
                groups.setdefault(slot, []).append(req)
                placed = True
                break
            if not placed:
                unplaced.append(req)
        # Two phases: send EVERY slot's group first, then collect — so
        # all replicas compute concurrently instead of each waiting for
        # the previous slot's batch to drain.
        sent: Dict[int, List[Dict]] = {}
        stamps: Dict[str, Optional[int]] = {}
        for slot, group in groups.items():
            try:
                conn = self._conn(slot)
                for req in group:
                    stamp = self.expected_version
                    stamps[str(req["id"])] = stamp
                    conn.send(dict(req, expect_version=stamp))
                sent[slot] = group
            except (OSError, ValueError, ConnectionError):
                self.replicas[slot].breaker.record_failure()
                self._drop_conn(slot)
        for slot, group in groups.items():
            info = self.replicas[slot]
            answered: Dict[str, Dict] = {}
            if slot in sent:
                try:
                    conn = self._conn(slot)
                    for req in group:
                        rid = str(req["id"])
                        answered[rid] = conn.recv_for(rid)
                except (OSError, ValueError, ConnectionError):
                    info.breaker.record_failure()
                    self._drop_conn(slot)
            if slot in sent and answered:
                # One breaker outcome for the slot's whole group: a
                # fenced answer steers future routing away; a clean
                # group (mismatch included — the replica is healthy,
                # the front's stamp just lagged a flip) counts as up.
                if any((r.get("error") or {}).get("reason") == "fenced"
                       for r in answered.values()
                       if not r.get("ok")):
                    info.breaker.record_failure()
                else:
                    info.breaker.record_success()
            for req in group:
                rid = str(req["id"])
                resp = answered.get(rid)
                err = ((resp.get("error") or {})
                       if resp is not None and not resp.get("ok")
                       else {})
                if resp is None or err.get("reason") in (
                    "fenced", "version-mismatch"
                ):
                    if resp is not None:
                        self._bump("fenced_seen",
                                   err.get("reason") == "fenced")
                    self._bump("failovers")
                    self._m_failovers.inc()
                    try:
                        # skip_slot: never re-send to the slot that
                        # just failed this request (and never count its
                        # failure twice).
                        resp = self._route(dict(req), skip_slot=slot)
                    except NoReplicaAvailable as e:
                        resp = {"ok": False, "id": rid,
                                "error": e.to_dict()}
                elif resp.get("ok"):
                    self._note_served_version(resp, stamps.get(rid))
                out[rid] = resp
        # Requests no slot admitted (every candidate draining or breaker-
        # open) go one by one through the failover path, which waits out
        # a drain.
        for req in unplaced:
            rid = str(req["id"])
            try:
                out[rid] = self._route(dict(req))
            except NoReplicaAvailable as e:
                out[rid] = {"ok": False, "id": rid, "error": e.to_dict()}
        return out

    # -- version flips ---------------------------------------------------------

    def activate(self, version: int,
                 hot_series: Optional[Sequence] = None,
                 horizons: Optional[Sequence[int]] = None
                 ) -> Dict[int, Optional[int]]:
        """Flip the pool to ``version`` with a flat p99: materialize
        hot forecasts for the NEW version into every replica's cache
        (ahead-of-time compute against a prefetched snapshot), flip the
        registry pointer, then drain replicas one at a time through an
        explicit refresh (siblings own each drained slot's traffic for
        the moment its engine swaps snapshots).  Returns each slot's
        warmed row count (None: the slot did not answer its warm)."""
        version = int(version)
        horizons = tuple(horizons or self.hot_horizons)
        hot = [str(s) for s in (hot_series or ())]
        with self._activate_lock:
            t0 = time.time()
            # Materialize the serve artifacts for the NEW version
            # before any replica refreshes onto it: the forecast plane
            # (replicas adopt it at warm/refresh and answer hot reads
            # with no dispatch) and the kernel bank (a respawned replica
            # loads the built kernel library).  Both are best-effort
            # accelerators — a shed or failed publish leaves the
            # compute path serving, never blocks the flip.
            arts = self._publish_serve_artifacts(version, horizons)
            warmed = {}
            for slot in self.replicas:
                try:
                    resp = self._request_slot(slot, {
                        "cmd": "warm", "version": version,
                        "series_ids": hot, "horizons": list(horizons),
                    })
                    warmed[slot] = (resp.get("warmed")
                                    if resp.get("ok") else None)
                except (OSError, ValueError, ConnectionError):
                    warmed[slot] = None  # dead replica warms at respawn
            self.registry.activate(version)
            self.expected_version = version
            for slot, info in self.replicas.items():
                info.draining = True
                try:
                    deadline = time.monotonic() + 10.0
                    while time.monotonic() < deadline:
                        resp = self._request_slot(slot, {
                            "cmd": "refresh", "version": version,
                        })
                        if (resp.get("ok")
                                and resp.get("version") == version):
                            break
                        time.sleep(0.02)
                except (OSError, ValueError, ConnectionError):
                    pass  # dead replica adopts the flip at respawn
                finally:
                    info.draining = False
            self._write_state()
            obs.record("pool.activate", t0, time.time() - t0,
                       version=version, warmed=warmed,
                       hot=len(hot), fplane=arts.get("fplane"),
                       aot=arts.get("aot"))
        return warmed

    def _publish_serve_artifacts(self, version: int,
                                 horizons: Sequence[int]) -> Dict:
        """Best-effort forecast plane, quantile plane and kernel bank for
        the flip target (each idempotent; see ``fplane.maybe_publish`` /
        ``qplane.maybe_publish`` / ``aotbank.build_bank``), on the
        pool's device.  Failures degrade to an event — the flip itself
        must never hinge on speculative precompute."""
        out: Dict = {"fplane": None, "qplane": None, "aot": None}
        try:
            from tsspark_tpu_torch.backends.registry import get_backend
            from tsspark_tpu_torch.config import SolverConfig
            from tsspark_tpu_torch.serve import aotbank, fplane
            from tsspark_tpu_torch.uncertainty import qplane

            backend = get_backend("cuda", self.registry.config,
                                  SolverConfig(), device=self.device)
            pub = fplane.maybe_publish(self.registry, version, backend,
                                       horizons=horizons)
            out["fplane"] = None if pub is None else pub.get("status")
            qpub = qplane.maybe_publish(self.registry, version, backend,
                                        horizons=horizons)
            out["qplane"] = None if qpub is None else qpub.get("status")
            bank_dir = aotbank.cache_dir_from_env()
            if bank_dir:
                snap = self.registry.load(int(version), fallback=False)
                bank = aotbank.build_bank(
                    snap, backend, dirpath=bank_dir, horizons=horizons,
                )
                out["aot"] = None if bank is None else bank.get("status")
        except Exception as e:
            obs.event("pool.serve_artifacts_failed",
                      version=int(version), error=repr(e))
        return out

    # -- aggregation -----------------------------------------------------------

    def stats(self) -> Dict:
        """Pool + per-replica stats (per-replica shed counts are the
        per-failure-domain saturation signal)."""
        per: Dict[str, Dict] = {}
        for slot in self.replicas:
            try:
                resp = self._request_slot(slot, {"cmd": "stats"},
                                          timeout_s=5.0)
            except (OSError, ValueError, ConnectionError):
                resp = None
            if resp is not None and resp.get("ok"):
                from tsspark_tpu_torch.utils.procmem import (
                    mapped_file_mem,
                    proc_mem,
                )

                st = resp["stats"]
                per[str(slot)] = {
                    "pid": resp.get("pid"), "gen": resp.get("gen"),
                    "version": resp.get("version"),
                    "submitted": st.get("submitted"),
                    "completed": st.get("completed"),
                    "shed": st.get("shed"),
                    "failed": st.get("failed"),
                    "rejected": st.get("rejected"),
                    "fast_failed": st.get("fast_failed"),
                    "latency_ms": st.get("latency_ms"),
                    "plane_hits": st.get("plane_hits"),
                    "plane_hit_rate": st.get("plane_hit_rate"),
                    "dispatches": st.get("dispatches"),
                    "cache": resp.get("cache"),
                    "kernels": resp.get("kernels"),
                    # Sharing-aware memory (utils.procmem): rss_anon is
                    # the private heap an npz snapshot would live in;
                    # the snap_* fields are the replica's resident cost
                    # in the mmap snapshot plane's shared columns.
                    "mem": {
                        **proc_mem(resp.get("pid")),
                        "snap": mapped_file_mem(resp.get("pid")),
                    },
                }
            else:
                per[str(slot)] = {"down": True}
        return {
            "n_replicas": self.n_replicas,
            "expected_version": self.expected_version,
            "failovers": self.failovers,
            "respawns": self.respawns,
            "spawn_exits": dict(self.spawn_exits),
            "wrong_version": self.wrong_version,
            "fenced_seen": self.fenced_seen,
            "breakers": {str(k): i.breaker.snapshot()
                         for k, i in self.replicas.items()},
            "disk_ladder": current_state(self.registry_root),
            "stale_serve": stale_serving(self.registry_root),
            "replicas": per,
        }

    def prometheus(self) -> str:
        """Aggregated Prometheus text: the front's own pool gauges plus
        each live replica's metrics under a ``# replica <k>`` banner
        (per-replica shed counts ride the labeled
        ``tsspark_pool_replica_shed`` gauge each replica exports)."""
        parts = ["# pool front", METRICS.to_prometheus()]
        for slot in self.replicas:
            try:
                resp = self._request_slot(slot, {"cmd": "metrics"},
                                          timeout_s=5.0)
            except (OSError, ValueError, ConnectionError):
                continue
            if resp.get("ok"):
                parts.append(f"# replica {slot}")
                parts.append(resp.get("prometheus", ""))
        return "\n".join(parts)


# The replica CLI lives in serve/replica.py (a module this package's
# __init__ does NOT import, so ``python -m`` runs it without the runpy
# double-import warning).
