"""The port's replica pool (``serve/pool.py``) on the CPU, with replicas
asked for the CPU (``--device cpu``), as the JAX package's own pool tests
run it: shard routing (``shard_of`` the reference's slot for every id)
and bitwise parity through replica processes, failover and respawn after
SIGKILL, concurrent activations from two publishers, the materialized
flip, per-replica shed counts in the stats and the Prometheus text, and
a zombie replica fenced once its slot lease is stolen.  Without a card
and without ``--device cpu`` a replica refuses to start."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tsspark_tpu.serve.pool import shard_of as jax_shard_of
from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.serve import (
    ParamRegistry,
    PoolError,
    ReplicaPool,
    shard_of,
)
from tsspark_tpu_torch.serve.pool import _send_line

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
SOLVER = SolverConfig(max_iters=25)
IDS = [f"s{i}" for i in range(6)]


@pytest.fixture(scope="module")
def pool_env(tmp_path_factory):
    """One live 2-replica CPU pool shared by the module's tests (replica
    spawns are the slow part; tests restore any replica they kill)."""
    rng = np.random.default_rng(0)
    t = np.arange(150.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 150)))
    backend = get_backend("cuda", CFG, SOLVER, device="cpu")
    state = backend.fit(t, y)
    root = tmp_path_factory.mktemp("pool_env")
    registry = ParamRegistry(str(root / "registry"), CFG)
    registry.publish(state, IDS, step=np.ones(len(IDS)))
    env_threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",)}
    os.environ["OMP_NUM_THREADS"] = "1"  # replicas inherit it
    pool = ReplicaPool(str(root / "pool"), registry.root, n_replicas=2,
                       heartbeat_s=0.2, breaker_reset_s=0.3,
                       device="cpu", spawn_timeout_s=120.0)
    try:
        pool.start()
        yield backend, state, registry, pool
    finally:
        pool.stop()
        for k, v in env_threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _respawn(pool, slot, timeout_s=90.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if slot in pool.ensure_alive():
            return True
        time.sleep(0.2)
    return False


def test_shard_of_is_the_reference_slot():
    rng = np.random.default_rng(3)
    ids = [f"s{i}" for i in range(500)] + [
        "".join(map(chr, rng.integers(33, 0x24F, rng.integers(1, 12))))
        for _ in range(500)]
    for n in (1, 2, 3, 4, 7):
        assert [shard_of(s, n) for s in ids] == \
            [jax_shard_of(s, n) for s in ids]
    assert shard_of("x", 0) == jax_shard_of("x", 0) == 0


def test_pool_routes_by_shard_and_matches_direct_predict(pool_env):
    """Forecasts served through a replica process are bitwise a direct
    ``backend.predict`` (the engine's pin survives the wire)."""
    backend, state, registry, pool = pool_env
    for sids, h in ((["s0", "s3"], 7), (["s5"], 28), (IDS, 14)):
        resp = pool.forecast(sids, h)
        assert resp["ok"] and resp["replica"] == shard_of(sids[0], 2)
        snap = registry.load(resp["version"])
        idx, _ = snap.rows(sids)
        sub, step = snap.take(idx)
        last = np.asarray(sub.meta.ds_start + sub.meta.ds_span, np.float64)
        grid = last[:, None] + step[:, None] * np.arange(1, h + 1)
        direct = backend.predict(sub, grid, num_samples=0)
        np.testing.assert_array_equal(np.asarray(resp["ds"]), grid)
        for k, v in direct.items():
            np.testing.assert_array_equal(
                np.asarray(resp[k], np.float32), v, err_msg=k)
    bad = pool.forecast(["ghost"], 7)
    assert not bad["ok"] and bad["error"]["reason"] == "unknown-series"


def test_failover_then_respawn_resumes_same_shard(pool_env):
    """SIGKILL a replica: requests for its shard are served by the
    sibling with zero failures, and the respawned process (holding the
    slot's lease) resumes the same shard at the active version."""
    backend, state, registry, pool = pool_env
    victim = shard_of(IDS[0], 2)
    sid = next(s for s in IDS if shard_of(s, 2) == victim)
    pid0 = pool.replicas[victim].pid
    failovers0 = pool.failovers
    t_kill = time.monotonic()
    os.kill(pid0, signal.SIGKILL)
    resp = pool.forecast([sid], 7)  # an in-flight failover, no error
    assert resp["ok"] and resp["replica"] != victim
    assert pool.failovers > failovers0
    assert _respawn(pool, victim)
    info = pool.replicas[victim]
    assert t_kill < info.spawn_t < info.ready_t  # the pool's own stamps
    resp2 = pool.forecast([sid], 7)
    assert resp2["ok"] and resp2["replica"] == victim
    assert resp2["version"] == registry.active_version()
    pid1 = pool.replicas[victim].pid
    assert pid1 != pid0
    assert pool.ping(victim)["pid"] == pid1
    lease = orchestrate.read_lease(pool.pool_dir, victim, victim + 1)
    assert lease["token"].startswith(f"pool{victim}.{pid1}.")
    assert pool.stats()["spawn_exits"] == {"-9": 1}  # the kill, counted
    assert pool.wrong_version == 0


def test_concurrent_activates_from_two_publishers(pool_env):
    """Two publishers activate different versions against the live pool
    at once: the pool converges on the registry's final active pointer
    with zero wrong-version responses."""
    backend, state, registry, pool = pool_env
    base = registry.active_version()
    va = registry.publish(state._replace(theta=state.theta * 1.003),
                          IDS, step=np.ones(len(IDS)), activate=False)
    vb = registry.publish(state._replace(theta=state.theta * 1.007),
                          IDS, step=np.ones(len(IDS)), activate=False)
    errs = []

    def flip(v):
        try:
            pool.activate(v, hot_series=IDS, horizons=(7,))
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=flip, args=(v,)) for v in (va, vb)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    final = registry.active_version()
    assert final in (va, vb) and final != base
    pool.expected_version = final  # a real front re-reads on mismatch
    for sid in IDS:
        resp = pool.forecast([sid], 7)
        assert resp["ok"] and resp["version"] == final
    assert pool.wrong_version == 0


def test_activate_flip_serves_from_materialized_cache(pool_env):
    """The flip lands on a warm cache (the forecast plane the activation
    published, or the materialized rows): the first post-flip request
    for a hot series dispatches nothing on any replica."""
    backend, state, registry, pool = pool_env
    v = registry.publish(state._replace(theta=state.theta * 1.011),
                         IDS, step=np.ones(len(IDS)), activate=False)
    before = {k: r["dispatches"]
              for k, r in pool.stats()["replicas"].items()}
    warmed = pool.activate(v, hot_series=IDS, horizons=(7,))
    assert sorted(warmed) == [0, 1]
    assert all(n is not None for n in warmed.values())
    for sid in IDS:
        resp = pool.forecast([sid], 7)
        assert resp["ok"] and resp["version"] == v
        assert resp["from_cache"] == 1, (sid, resp.get("from_cache"))
    after = {k: r["dispatches"] for k, r in pool.stats()["replicas"].items()}
    assert after == before  # the plane answered; nothing dispatched
    # Sampled requests are no plane's: the first dispatches, the repeat
    # is a cache hit.
    a = pool.forecast(["s1"], 7, num_samples=8, seed=3)
    b = pool.forecast(["s1"], 7, num_samples=8, seed=3)
    assert a["ok"] and b["ok"] and b["from_cache"] == 1
    assert a["yhat_lower"] == b["yhat_lower"]


def test_pool_stats_and_metrics_expose_per_replica_shed(pool_env):
    """Per-replica shed counts ride the stats and the Prometheus
    aggregation (``tsspark_pool_replica_shed{replica=k}``); each
    replica's stats carry its kernel counters (none on the CPU)."""
    backend, state, registry, pool = pool_env
    waves = pool.submit_wave([
        {"id": f"h{i}", "series_ids": [IDS[i]], "horizon": 7,
         "deadline_ms": 0.0} for i in range(len(IDS))])
    assert all(r["error"]["reason"] == "deadline-exceeded"
               for r in waves.values())
    time.sleep(0.6)  # a heartbeat exports the gauge
    st = pool.stats()
    assert set(st["replicas"]) == {"0", "1"}
    assert sum(r["shed"] for r in st["replicas"].values()) >= len(IDS)
    for rep in st["replicas"].values():
        assert "latency_ms" in rep
        assert rep["kernels"]["forward"] == 0
        assert rep["kernels"]["library_loads"] == 0
        assert rep["kernels"]["bank"] is None
    prom = pool.prometheus()
    assert "tsspark_pool_replica_shed" in prom
    assert 'replica="0"' in prom and 'replica="1"' in prom
    assert "tsspark_serve_retry_after_seconds" in prom
    assert "tsspark_pool_replicas_alive" in prom
    assert st["disk_ladder"] == "normal" and st["stale_serve"] is False


def test_requests_wait_out_a_drain_instead_of_failing(pool_env):
    """With every candidate slot draining (an activation's refresh), a
    request waits for the drain to end rather than failing with
    ``no-replica``: single requests and a wave's unplaced ones alike."""
    backend, state, registry, pool = pool_env
    for info in pool.replicas.values():
        info.draining = True

    def undrain():
        time.sleep(0.3)
        for info in pool.replicas.values():
            info.draining = False

    for call in (lambda: pool.forecast(["s2"], 7),
                 lambda: pool.submit_wave([
                     {"id": "w1", "series_ids": ["s1"], "horizon": 7},
                     {"id": "w2", "series_ids": ["s4"], "horizon": 9}])):
        for info in pool.replicas.values():
            info.draining = True
        t = threading.Thread(target=undrain)
        t.start()
        t0 = time.monotonic()
        out = call()
        t.join()
        assert time.monotonic() - t0 >= 0.25
        answers = out.values() if "w1" in out else [out]
        assert all(r["ok"] for r in answers), answers


def test_zombie_replica_is_fenced_after_lease_steal(pool_env):
    """A replica stalls (SIGSTOP), its slot lease expires and is stolen;
    revived, it must answer the structured ``fenced`` refusal, never
    data at any version."""
    backend, state, registry, pool = pool_env
    slot = 1
    info = pool.replicas[slot]
    zpid, zsock = info.pid, info.socket_path
    os.kill(zpid, signal.SIGSTOP)
    try:
        deadline = time.time() + 4.0 * pool.lease_ttl_s
        stolen = False
        while time.time() < deadline:
            if orchestrate.claim_lease(pool.pool_dir, slot, slot + 1,
                                       "test-thief",
                                       ttl_s=pool.lease_ttl_s):
                stolen = True
                break
            time.sleep(0.1)
        assert stolen
    finally:
        os.kill(zpid, signal.SIGCONT)
    time.sleep(0.5)  # one heartbeat cycle: the zombie notices
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(15.0)
    s.connect(zsock)
    _send_line(s, {"id": "z", "series_ids": [IDS[0]], "horizon": 5,
                   "expect_version": registry.active_version()})
    buf = b""
    while b"\n" not in buf:
        chunk = s.recv(65536)
        assert chunk, "zombie closed without the structured refusal"
        buf += chunk
    s.close()
    resp = json.loads(buf.split(b"\n", 1)[0])
    assert not resp["ok"] and resp["error"]["reason"] == "fenced"
    orchestrate.release_lease(pool.pool_dir, slot, slot + 1, "test-thief")
    try:
        os.kill(zpid, signal.SIGKILL)
    except OSError:
        pass
    assert _respawn(pool, slot)
    assert pool.forecast([next(s2 for s2 in IDS
                               if shard_of(s2, 2) == slot)], 5)["ok"]


def test_a_replica_without_a_card_or_a_cpu_request_refuses(tmp_path,
                                                           pool_env):
    """The port's departure from the reference: a replica runs on the
    card unless asked for the CPU, so here (no card) it exits non-zero
    at start, and the front counts the exit instead of serving."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the replica would serve on it")
    registry = pool_env[2]
    pool = ReplicaPool(str(tmp_path / "pool"), registry.root, n_replicas=1,
                       spawn_timeout_s=6.0)
    with pytest.raises(PoolError, match="failed to start"):
        pool.start()
    exits = pool.stats()["spawn_exits"]
    assert exits and "0" not in exits
    pool.stop()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TSSPARK_SERVE_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.serve.replica",
         "--pool-dir", str(tmp_path / "p2"), "--slot", "0",
         "--registry", registry.root, "--socket", str(tmp_path / "s")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
