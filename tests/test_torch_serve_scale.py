"""The engine's version-flip machinery and failure handling against the
JAX package's: ``prefetch`` / ``materialize`` / ``ensure_version``, the
delta flip's cache carry-forward, retries under ``RetryPolicy``, the
registry and dispatch circuit breakers (``BackendUnavailable``), and
``CudaBackend(perf=...)``; plus the Prometheus text both packages render
from one snapshot."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu.backends.registry import get_backend as jax_get_backend
from tsspark_tpu.config import ProphetConfig as JaxConfig
from tsspark_tpu.config import SeasonalityConfig as JaxSeason
from tsspark_tpu.config import SolverConfig as JaxSolver
from tsspark_tpu.obs import metrics as jmetrics
from tsspark_tpu.serve import ForecastCache as JaxCache
from tsspark_tpu.serve import ParamRegistry as JaxRegistry
from tsspark_tpu.serve import PredictionEngine as JaxEngine
from tsspark_tpu.serve.registry import take_fitstate as jtake
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.obs import metrics as tmetrics
from tsspark_tpu_torch.perf import PerfRecorder, get_perf
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from tsspark_tpu_torch.serve import (
    BackendUnavailable,
    ForecastCache,
    ParamRegistry,
    PredictionEngine,
    RegistryError,
    take_fitstate,
)

torch.set_num_threads(2)

JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
IDS = [f"s{i}" for i in range(6)]


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX package fits one 6-series batch, as tests/test_pool.py
    does; the port serves the same weights carried across."""
    rng = np.random.default_rng(0)
    t = np.arange(150.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 150)))
    backend = jax_get_backend("tpu", JCFG, JaxSolver(max_iters=25))
    return t, y, backend.fit(t, jnp.asarray(y))


def _port_state(jax_state):
    leaves = {f: np.asarray(getattr(jax_state, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    leaves.update(jax_state.meta._asdict())
    return fitstate_from_numpy(leaves, "cpu")


def _both(tmp_path, jax_fitted):
    """The same weights published as v1 in a JAX and a port registry."""
    state = jax_fitted[2]
    jreg = JaxRegistry(str(tmp_path / "jax"), JCFG)
    jreg.publish(state, IDS, step=np.ones(len(IDS)))
    treg = ParamRegistry(str(tmp_path / "port"), CFG)
    treg.publish(_port_state(state), IDS, step=np.ones(len(IDS)))
    return (jreg, state), (treg, _port_state(state))


def _close(got, want, scale):
    for k, v in want.items():
        atol = 1e-6 * (1.0 if k == "multiplicative" else scale)
        assert (np.abs(np.asarray(got[k]) - np.asarray(v))
                <= atol + 1e-5 * np.abs(np.asarray(v))).all(), k


def _warm_flip(reg, state, eng):
    """The reference's materializer script, on either package; returns
    the post-flip result."""
    assert eng.forecast(["s0"], 7).version == 1
    v2 = reg.publish(state._replace(theta=state.theta * 1.01), IDS,
                     step=np.ones(len(IDS)), activate=False)
    assert eng.materialize(IDS, [7], version=v2) == len(IDS)
    assert eng.materialize(IDS, [7], version=v2) == 0  # idempotent
    assert eng.forecast(["s1"], 7).version == 1  # not active yet
    dispatches = eng.stats.dispatches
    reg.activate(v2)
    res = eng.forecast(["s0", "s1"], 7)
    assert res.version == v2 and res.from_cache == 2
    assert eng.stats.dispatches == dispatches  # the flip computed nothing
    assert eng.ensure_version(v2) is True
    assert eng.ensure_version(999) is False
    return res


def test_prefetch_materialize_warm_flip_on_both_packages(tmp_path,
                                                         jax_fitted):
    (jreg, jstate), (treg, tstate) = _both(tmp_path, jax_fitted)
    want = _warm_flip(jreg, jstate, JaxEngine(jreg, cache=JaxCache(64)))
    got = _warm_flip(treg, tstate, PredictionEngine(
        treg, cache=ForecastCache(64), device="cpu"))
    np.testing.assert_array_equal(got.ds, want.ds)
    scale = np.asarray(jstate.meta.y_scale)[:2, None]
    _close(got.values, want.values, scale)


def test_prefetched_snapshot_is_swapped_in_without_a_load(tmp_path,
                                                          jax_fitted):
    _, (treg, tstate) = _both(tmp_path, jax_fitted)
    eng = PredictionEngine(treg, device="cpu")
    eng.forecast(["s0"], 7)
    v2 = treg.publish(tstate, IDS, step=np.ones(len(IDS)), activate=False)
    pre = eng.prefetch(v2)
    loads = []
    real = treg.load
    treg.load = lambda *a, **k: loads.append(a) or real(*a, **k)
    treg.activate(v2)
    assert eng.refresh() is pre and loads == []
    assert eng.served_version() == v2


def _delta_cache_keys(reg, state, eng, take, changed):
    """Fill the cache at v1, publish a delta refitting ``changed`` rows,
    flip, and return the carried keys (version 2's) and the counter."""
    for h in (7, 14):
        eng.forecast(IDS, h)
    sub = take(state, np.asarray(changed))
    sub = sub._replace(theta=sub.theta * 1.02)
    v2 = reg.publish_delta(sub, changed, activate=False)
    reg.activate(v2)
    keys = {k for k in list(eng.cache._data) if k[0] == v2}
    return keys, eng.cache.stats()["carried"]


@pytest.mark.parametrize("changed", [[1], [0, 4, 5], []])
def test_delta_flip_carries_the_jax_packages_cache_keys(tmp_path,
                                                        jax_fitted,
                                                        changed):
    (jreg, jstate), (treg, tstate) = _both(tmp_path, jax_fitted)
    jeng = JaxEngine(jreg, cache=JaxCache(256))
    teng = PredictionEngine(treg, cache=ForecastCache(256), device="cpu")
    want = _delta_cache_keys(jreg, jstate, jeng, jtake, changed)
    got = _delta_cache_keys(treg, tstate, teng, take_fitstate, changed)
    assert got == want
    assert got[1] == 2 * (len(IDS) - len(changed))
    # The carried rows are the base version's rows, now at v2 ...
    res = teng.forecast(IDS, 7)
    assert res.version == 2
    assert res.from_cache == len(IDS) - len(changed)
    # ... and a fresh engine computing v2 gives the same bits.
    fresh = PredictionEngine(treg, cache=ForecastCache(0), device="cpu")
    ref = fresh.forecast(IDS, 7)
    for k in ref.values:
        np.testing.assert_array_equal(res.values[k], ref.values[k])


def test_a_full_flip_still_drops_the_cache(tmp_path, jax_fitted):
    _, (treg, tstate) = _both(tmp_path, jax_fitted)
    eng = PredictionEngine(treg, cache=ForecastCache(64), device="cpu")
    eng.forecast(IDS, 7)
    treg.publish(tstate, IDS, step=np.ones(len(IDS)))
    assert eng.forecast(IDS, 7).from_cache == 0
    assert eng.cache.stats()["carried"] == 0
    assert eng.cache.key_versions() == [2]


def test_retry_policy_covers_a_transient_dispatch_fault(tmp_path,
                                                        jax_fitted,
                                                        monkeypatch):
    _, (treg, _) = _both(tmp_path, jax_fitted)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "serve_predict", attempts=1, mode="raise")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    eng = PredictionEngine(
        treg, device="cpu",
        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                 max_delay_s=0.0),
    )
    res = eng.forecast(["s0"], 7)  # the first attempt faults, the retry
    assert res.values["yhat"].shape == (1, 7)
    assert eng.stats.dispatches == 1 and eng.stats.failed == 0


def test_open_dispatch_breaker_fails_fast(tmp_path, jax_fitted,
                                          monkeypatch):
    """Two failed dispatches open the breaker; the third request fails
    at once with the structured ``BackendUnavailable`` (no attempt)."""
    _, (treg, _) = _both(tmp_path, jax_fitted)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "serve_predict", attempts=100, mode="raise")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=30.0,
                        name="backend")
    eng = PredictionEngine(treg, device="cpu", breaker=br,
                           cache=ForecastCache(0))
    calls = []
    real = eng.backend.predict
    eng.backend.predict = lambda *a, **k: calls.append(1) or real(*a, **k)
    for _ in range(2):
        with pytest.raises(faults.FaultInjected):
            eng.forecast(["s0"], 7)
    with pytest.raises(BackendUnavailable) as e:
        eng.forecast(["s1"], 7)
    assert e.value.to_dict()["reason"] == "circuit-open"
    assert 0 < e.value.to_dict()["retry_after_s"] <= 30.0
    assert calls == [] and eng.stats.fast_failed == 1
    snap = eng.stats.snapshot()
    assert snap["fast_failed"] == 1 and snap["retry_after_s"] > 0
    assert br.snapshot()["opens"] == 1 and br.snapshot()["state"] == "open"


def test_registry_breaker_serves_the_held_snapshot_then_retries(
        tmp_path, jax_fitted):
    """While the registry breaker is open the engine serves its held
    snapshot without marking the missed flip as seen; once the window
    elapses the next pump picks the new version up."""
    _, (treg, tstate) = _both(tmp_path, jax_fitted)
    eng = PredictionEngine(
        treg, device="cpu",
        registry_breaker=CircuitBreaker(failure_threshold=1,
                                        reset_timeout_s=0.05,
                                        name="registry"),
    )
    assert eng.forecast(["s0"], 7).version == 1
    # A cross-process flip: a second handle publishes v2.
    reg2 = ParamRegistry(treg.root, CFG)
    v2 = reg2.publish(tstate._replace(theta=tstate.theta * 1.01), IDS)
    real_load = treg.load
    treg.load = lambda *a, **k: (_ for _ in ()).throw(OSError("hiccup"))
    try:
        with pytest.raises(OSError):
            eng.forecast(["s0"], 7)
        assert eng.forecast(["s0"], 7).version == 1  # breaker open
    finally:
        treg.load = real_load
    time.sleep(0.06)
    assert eng.forecast(["s0"], 7).version == v2


def test_open_registry_breaker_with_nothing_held_is_structured(
        tmp_path, jax_fitted):
    _, (treg, _) = _both(tmp_path, jax_fitted)
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=30.0,
                        name="registry")
    br.record_failure()
    eng = PredictionEngine(treg, device="cpu", registry_breaker=br)
    with pytest.raises(RegistryError) as e:
        eng.forecast(["s0"], 7)
    assert e.value.reason == "circuit-open"


def test_engine_recorder_times_each_dispatch(tmp_path, jax_fitted):
    _, (treg, _) = _both(tmp_path, jax_fitted)
    rec = PerfRecorder()
    eng = PredictionEngine(treg, device="cpu", recorder=rec)
    eng.forecast(IDS, 7)
    eng.forecast(IDS[:2], 30, num_samples=8, seed=1)
    segs = rec.report().segments
    assert [(s.kind, s.width, s.live) for s in segs] == \
        [("predict", 8, 6), ("predict", 8, 2)]
    assert not any(s.compile_miss for s in segs)  # nothing loads on CPU


def test_cuda_backend_perf_attaches_a_per_dispatch_report(jax_fitted):
    t, y, _ = jax_fitted
    rec = PerfRecorder()
    bk = get_backend("cuda", CFG, SolverConfig(max_iters=25),
                     device="cpu", perf=rec, chunk_size=4)
    state = bk.fit(t, y)
    rep = get_perf(state)
    assert rep is not None and rep.to_dict()["n_dispatches"] >= 2
    assert all(s.kind == "chunk" for s in rep.segments)
    assert rep.widths[:2] == (4, 4)  # 6 series in chunks of 4
    # fit_twophase attaches the cumulative report too.
    state2 = bk.fit_twophase(t, y, phase1_iters=4)
    assert get_perf(state2).to_dict()["n_dispatches"] > len(rep.segments)
    # Without a recorder nothing is attached, and the recorder changes
    # no bit of the fit.
    plain = get_backend("cuda", CFG, SolverConfig(max_iters=25),
                        device="cpu", chunk_size=4).fit(t, y)
    assert get_perf(plain) is None
    np.testing.assert_array_equal(plain.theta.numpy(), state.theta.numpy())


def test_streaming_perf_report_returns_the_backends(jax_fitted):
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster

    sf = StreamingForecaster(CFG, SolverConfig(max_iters=10),
                             device="cpu")
    assert sf.perf_report() is None
    rec = PerfRecorder()
    sf = StreamingForecaster(CFG, SolverConfig(max_iters=10),
                             device="cpu", perf=rec)
    assert sf.backend.perf is rec
    t, y, _ = jax_fitted
    sf.backend.fit(t, y)
    assert sf.perf_report().to_dict()["n_dispatches"] >= 1


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_routes_through_the_sharded_fit(jax_fitted, shape):
    """``CudaBackend(mesh=, shard_config=)`` on a 2-entry CPU mesh fits
    through the sharded route: a series split is the meshless fit's bits,
    a time split (named by ``shard_config``) its losses at the reference's
    mesh bound (rtol 2e-3, atol 2e-3)."""
    from tsspark_tpu_torch.config import ShardingConfig
    from tsspark_tpu_torch.parallel.mesh import make_mesh

    t, y, _ = jax_fitted
    solver = SolverConfig(max_iters=25)
    plain = get_backend("cuda", CFG, solver, device="cpu").fit(t, y)
    mesh = make_mesh(*shape, devices=["cpu", "cpu"])
    got = get_backend(
        "cuda", CFG, solver, device="cpu", mesh=mesh,
        shard_config=ShardingConfig(time_axis="time")).fit(t, y)
    if shape[1] == 1:
        assert torch.equal(got.theta, plain.theta)
        np.testing.assert_array_equal(got.loss, plain.loss)
    else:
        np.testing.assert_allclose(got.loss, plain.loss, rtol=2e-3,
                                   atol=2e-3)


def test_prometheus_text_equals_the_jax_packages():
    """One snapshot, both renderers: the same exposition text."""
    reg = tmetrics.MetricsRegistry()
    reg.counter("tsspark_serve_requests_total", result="shed").inc(3)
    reg.counter("tsspark_serve_dispatches_total").inc(7)
    reg.gauge("tsspark_pool_replica_shed", replica="1").set(2.0)
    h = reg.histogram("tsspark_serve_request_seconds")
    for v in (0.001, 0.003, 0.02, 0.5):
        h.observe(v)
    snap = reg.snapshot()
    assert reg.to_prometheus() == jmetrics.prometheus_text(snap)
    text = tmetrics.prometheus_text(snap)
    assert 'tsspark_serve_requests_total{result="shed"} 3' in text
    assert 'tsspark_serve_request_seconds_bucket{le="+Inf"} 4' in text
