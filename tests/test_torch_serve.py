"""The port's serving path: it opens a registry the JAX package published
and answers the same coalesced requests as the JAX engine, its engine is
bitwise equal to a direct port ``backend.predict``, and the registry
lifecycle (publish / activate / rollback, corrupt-manifest rejection,
last-good fallback, unknown series) mirrors the JAX package's."""

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu.backends.registry import get_backend as jax_get_backend
from tsspark_tpu.config import ProphetConfig as JaxConfig
from tsspark_tpu.config import SeasonalityConfig as JaxSeason
from tsspark_tpu.config import SolverConfig as JaxSolver
from tsspark_tpu.serve import ParamRegistry as JaxRegistry
from tsspark_tpu.serve import PredictionEngine as JaxEngine
from tsspark_tpu.utils import checkpoint as jckpt
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.carry import fitstate_from_numpy, fitstate_to_numpy
from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
from tsspark_tpu_torch.serve import (
    EngineOverloaded,
    ForecastCache,
    ForecastRequest,
    ParamRegistry,
    PredictionEngine,
    RegistryError,
    RequestShed,
    SamplesUnsupported,
    UnknownSeries,
)
from tsspark_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
IDS = [f"s{i}" for i in range(6)]


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX package fits one 6-series batch, as tests/test_serve.py
    does; every test here only reads it."""
    rng = np.random.default_rng(0)
    t = np.arange(150.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 150)))
    backend = jax_get_backend("tpu", JCFG, JaxSolver(max_iters=25))
    return backend, backend.fit(t, jnp.asarray(y))


@pytest.fixture
def jax_registry(tmp_path, jax_fitted):
    _, state = jax_fitted
    reg = JaxRegistry(str(tmp_path / "jax_registry"), JCFG)
    reg.publish(state, IDS, step=np.ones(len(IDS)))
    return reg


def _port_state(jax_state):
    """Weights carried across as numpy leaves."""
    leaves = {f: np.asarray(getattr(jax_state, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    leaves.update(jax_state.meta._asdict())
    return fitstate_from_numpy(leaves, "cpu")


def _port_registry(tmp_path, jax_fitted, **kw):
    reg = ParamRegistry(str(tmp_path / "registry"), CFG, **kw)
    reg.publish(_port_state(jax_fitted[1]), IDS, step=np.ones(len(IDS)))
    return reg


def test_port_opens_a_registry_the_jax_package_published(jax_registry,
                                                        jax_fitted):
    reg = ParamRegistry.open(jax_registry.root)
    assert dataclasses.asdict(reg.config) == dataclasses.asdict(JCFG)
    assert reg.active_version() == 1
    snap = reg.load()
    _, state = jax_fitted
    np.testing.assert_array_equal(snap.state.theta.numpy(),
                                  np.asarray(state.theta))
    for f in state.meta._fields:
        got = getattr(snap.state.meta, f)
        assert got.dtype == np.float64, f
        np.testing.assert_array_equal(got, getattr(state.meta, f))
    assert snap.series_ids == tuple(IDS)


def test_port_and_jax_engines_answer_the_same_requests(jax_registry):
    reqs = [(["s1", "s3", "s4"], 7), (["s5", "s1"], 5)]
    answers = []
    for eng in (JaxEngine(jax_registry),
                PredictionEngine(ParamRegistry.open(jax_registry.root),
                                 device="cpu")):
        pends = [eng.submit(ForecastRequest.make(s, h)) for s, h in reqs]
        assert eng.pump() == 2
        assert eng.stats.dispatches == 1
        answers.append([p.result(5) for p in pends])
    for want, got in zip(*answers):
        np.testing.assert_array_equal(got.ds, want.ds)
        assert sorted(got.values) == sorted(want.values)
        snap = jax_registry.load()
        idx, _ = snap.rows(got.series_ids)
        scale = np.asarray(snap.state.meta.y_scale)[idx][:, None]
        for k, v in want.values.items():
            atol = 1e-6 * (1.0 if k == "multiplicative" else scale)
            assert (np.abs(got.values[k] - v)
                    <= atol + 1e-5 * np.abs(v)).all(), k


def test_engine_batched_bitwise_equals_direct_predict(tmp_path, jax_fitted):
    """The port's serving pin: two coalesced requests, padded to the pow-2
    width and horizon buckets, reproduce a direct backend.predict for
    the same series bit for bit."""
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu")
    backend = get_backend("cuda", CFG, device="cpu")
    p1 = eng.submit(ForecastRequest.make(["s1", "s3", "s4"], 7))
    p2 = eng.submit(ForecastRequest.make(["s5", "s1"], 5))
    assert eng.pump() == 2
    r1, r2 = p1.result(5), p2.result(5)
    snap = reg.load()
    for res, sids, h in ((r1, ["s1", "s3", "s4"], 7),
                         (r2, ["s5", "s1"], 5)):
        idx, _ = snap.rows(sids)
        sub, step = snap.take(idx)
        last = np.asarray(sub.meta.ds_start + sub.meta.ds_span, np.float64)
        grid = last[:, None] + step[:, None] * np.arange(1, h + 1)
        direct = backend.predict(sub, grid, num_samples=0)
        np.testing.assert_array_equal(res.ds, grid)
        for k, v in direct.items():
            np.testing.assert_array_equal(res.values[k], v, err_msg=k)
    assert eng.stats.dispatches == 1
    occ = eng.stats.occupancy[0]
    assert occ[0] == 4 and occ[1] == 8 and occ[2] == 2


def test_engine_cache_and_sampled_requests(tmp_path, jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu", cache=ForecastCache(64))
    a = eng.forecast(IDS, 10, num_samples=32, seed=1)
    assert a.values["yhat_lower"].shape == (6, 10)
    assert (a.values["yhat_lower"] <= a.values["yhat_upper"]).all()
    again = eng.forecast(IDS, 10, num_samples=32, seed=1)
    assert again.from_cache == 6 and eng.stats.dispatches == 1
    for k in a.values:
        np.testing.assert_array_equal(a.values[k], again.values[k])
    # A version flip invalidates the cache: the next request dispatches.
    reg.publish(_port_state(jax_fitted[1]), IDS)
    fresh = eng.forecast(IDS, 10, num_samples=32, seed=1)
    assert fresh.version == 2 and fresh.from_cache == 0
    assert eng.stats.dispatches == 2


def test_registry_publish_activate_rollback(tmp_path, jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    state = _port_state(jax_fitted[1])
    assert reg.active_version() == 1 and reg.versions() == (1,)
    v2 = reg.publish(state._replace(theta=state.theta * 1.01), IDS)
    assert (v2, reg.active_version()) == (2, 2)
    snap2 = reg.load()
    assert reg.rollback() == 1
    snap1 = reg.load()
    assert snap1.version == 1
    np.testing.assert_array_equal(snap1.state.theta.numpy() * 1.01,
                                  snap2.state.theta.numpy())
    v3 = reg.publish(state, IDS, activate=False)
    assert v3 == 3 and reg.active_version() == 1
    reg.activate(v3)
    assert reg.active_version() == 3
    with pytest.raises(RegistryError) as e:
        reg.activate(99)
    assert e.value.reason == "unknown-version"
    # The JAX package reads what the port published.
    jreg = JaxRegistry(reg.root, JCFG, snapshot_format="npz")
    np.testing.assert_array_equal(np.asarray(jreg.load(1).state.theta),
                                  snap1.state.theta.numpy())


def test_registry_rejects_corrupt_and_incompatible_manifests(tmp_path,
                                                             jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    with pytest.raises(RegistryError) as e:
        ParamRegistry(reg.root, dataclasses.replace(CFG, n_changepoints=4))
    assert e.value.reason == "fingerprint-mismatch"
    with pytest.raises(RegistryError) as e:
        ParamRegistry(reg.root, CFG, numerics_rev=999)
    assert e.value.reason == "numerics-rev-mismatch"
    assert ParamRegistry(reg.root, CFG, numerics_rev=999,
                         strict=False).active_version() == 1
    with open(os.path.join(reg.root, "manifest.json"), "w") as fh:
        fh.write('{"format": 1, "versi')  # torn write simulation
    with pytest.raises(RegistryError) as e:
        ParamRegistry(reg.root, CFG)
    assert e.value.reason == "corrupt-manifest"
    with pytest.raises(RegistryError) as e:
        ParamRegistry.open(reg.root)
    assert e.value.reason == "corrupt-manifest"


def test_corrupt_active_snapshot_falls_back_to_last_good(tmp_path,
                                                         jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    reg.publish(_port_state(jax_fitted[1]), IDS)
    path = os.path.join(reg.version_dir(2), "state.npz")
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        fh.write(b"\x00garbage\x00")
    with pytest.warns(RuntimeWarning, match="last good version 1"):
        snap = reg.load()
    assert snap.version == 1 and snap.fallback_from == 2
    with pytest.raises(RegistryError) as e:
        reg.load(2)
    assert e.value.reason == "corrupt-snapshot"


def test_plane_only_versions_are_refused(tmp_path, jax_fitted):
    _, state = jax_fitted
    jreg = JaxRegistry(str(tmp_path / "mmap"), JCFG, snapshot_format="mmap")
    jreg.publish(state, IDS)
    reg = ParamRegistry.open(jreg.root)
    with pytest.raises(RegistryError) as e:
        reg.load()
    assert e.value.reason == "format-unsupported"


def test_engine_unknown_series_shedding_and_admission(tmp_path, jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu", max_queue=2)
    dead = eng.submit(ForecastRequest.make(["s0"], 7, deadline_in_s=0.0))
    alive = eng.submit(ForecastRequest.make(["s2"], 7, deadline_in_s=30.0))
    with pytest.raises(EngineOverloaded):
        eng.submit(ForecastRequest.make(["s1"], 7))
    time.sleep(0.005)
    assert eng.pump() == 2
    with pytest.raises(RequestShed) as e:
        dead.result(5)
    assert e.value.to_dict()["reason"] == "deadline-exceeded"
    assert alive.result(5).values["yhat"].shape == (1, 7)
    with pytest.raises(UnknownSeries) as e:
        eng.forecast(["s0", "ghost"], 7)
    assert e.value.missing == ("ghost",) and e.value.version == 1
    bad = eng.submit(ForecastRequest(series_ids=(), horizon=7))
    eng.pump()
    with pytest.raises(ValueError):
        bad.result(5)
    snap = eng.stats.snapshot()
    assert (snap["shed"], snap["rejected"], snap["failed"]) == (1, 1, 2)


def test_engine_background_worker(tmp_path, jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu")
    eng.start(poll_s=0.01)
    try:
        res = eng.forecast(["s0", "s4"], 3, timeout_s=30.0)
    finally:
        eng.stop()
    assert res.values["yhat"].shape == (2, 3)
    assert eng._thread is None


def test_fitstate_numpy_round_trip_and_checkpoints(tmp_path, jax_fitted):
    _, jstate = jax_fitted
    state = _port_state(jstate)
    leaves = fitstate_to_numpy(state)
    again = fitstate_from_numpy(leaves, "cpu")
    assert torch.equal(again.theta, state.theta)
    assert again.theta.dtype == torch.float32
    for f in state.meta._fields:
        assert getattr(again.meta, f).dtype == np.float64
        np.testing.assert_array_equal(getattr(again.meta, f),
                                      getattr(jstate.meta, f))
    # Checkpoints cross both ways.
    tckpt.save_state(str(tmp_path / "port"), state, CFG, series_ids=IDS)
    jst, jids = jckpt.load_state(str(tmp_path / "port"), JCFG)
    np.testing.assert_array_equal(np.asarray(jst.theta),
                                  np.asarray(jstate.theta))
    assert list(jids) == IDS
    jckpt.save_state(str(tmp_path / "jax"), jstate, JCFG, series_ids=IDS)
    tst, tids = tckpt.load_state(str(tmp_path / "jax"), CFG)
    assert torch.equal(tst.theta, state.theta) and list(tids) == IDS
    np.testing.assert_array_equal(tst.status, np.asarray(jstate.status))


def test_registry_concurrent_publishers_get_distinct_versions(tmp_path,
                                                              jax_fitted):
    import threading

    reg = _port_registry(tmp_path, jax_fitted)
    state = _port_state(jax_fitted[1])
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        reg.publish(state, IDS))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == [2, 3, 4, 5]
    assert reg.versions() == (1, 2, 3, 4, 5)
    for v in got:
        assert reg.load(v).version == v


def test_engine_follows_a_flip_made_by_another_process(tmp_path,
                                                       jax_fitted):
    reg = _port_registry(tmp_path, jax_fitted)
    state = _port_state(jax_fitted[1])
    reg.publish(state._replace(theta=state.theta * 1.5), IDS,
                activate=False)
    eng = PredictionEngine(reg, device="cpu")
    v1 = eng.forecast(["s0"], 4)
    assert v1.version == 1
    # A second registry object stands in for another process: no
    # in-process notification reaches the engine, only the manifest.
    ParamRegistry(reg.root, CFG).activate(2)
    v2 = eng.forecast(["s0"], 4)
    assert v2.version == 2 and v2.from_cache == 0
    assert not np.array_equal(v1.values["yhat"], v2.values["yhat"])


def test_registry_open_without_a_manifest(tmp_path):
    with pytest.raises(RegistryError) as e:
        ParamRegistry.open(str(tmp_path / "nowhere"))
    assert e.value.reason == "missing-manifest"
    reg = ParamRegistry(str(tmp_path / "empty"), CFG)
    with pytest.raises(RegistryError) as e:
        reg.load()
    assert e.value.reason == "no-active-version"
    with pytest.raises(RegistryError) as e:
        reg.rollback()
    assert e.value.reason == "no-rollback-target"


@pytest.mark.parametrize("num_samples", [-1])
def test_requests_outside_the_band_kernel_are_refused_when_made(
        num_samples):
    with pytest.raises(SamplesUnsupported) as e:
        ForecastRequest.make(["s0"], 7, num_samples=num_samples)
    assert e.value.to_dict()["reason"] == "samples-unsupported"
    assert isinstance(e.value, ValueError)
    assert ForecastRequest.make(["s0"], 7, num_samples=0).num_samples == 0


@pytest.mark.parametrize("num_samples", [16384, 16385, 1_000_000])
def test_sample_counts_past_the_old_cap_are_accepted(num_samples):
    """K2 takes any sample count, so the engine no longer refuses counts
    past the 16,384 one block once held."""
    req = ForecastRequest.make(["s0"], 7, num_samples=num_samples, seed=4)
    assert req.num_samples == num_samples and req.seed == 4


def test_engine_serves_20000_samples(tmp_path, jax_fitted):
    """A sampled request past the old cap through the engine on the CPU
    (the plain path); given draws at that count give the quantiles of
    their own samples."""
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data

    s, h, sids = 20_000, 5, ["s0", "s2", "s5"]
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu", cache=ForecastCache(0))
    res = eng.forecast(sids, h, num_samples=s, seed=3)
    eps = float(np.finfo(np.float32).eps)
    for lo, hi in (("yhat_lower", "yhat_upper"),
                   ("trend_lower", "trend_upper")):
        lo_v, hi_v = res.values[lo], res.values[hi]
        assert lo_v.shape == (3, h)
        assert np.isfinite(lo_v).all() and np.isfinite(hi_v).all()
        # Where most trend paths tie (no simulated changepoint yet), both
        # quantiles are that value, each rounded by its own float32
        # weights: they may part by an ulp either way.
        assert (lo_v <= hi_v + 4 * eps * np.abs(hi_v)).all()
    assert (res.values["yhat_lower"] <= res.values["yhat"]).all()
    assert (res.values["yhat"] <= res.values["yhat_upper"]).all()

    snap = reg.load()
    idx, _ = snap.rows(sids)
    sub, step = snap.take(idx)
    last = np.asarray(sub.meta.ds_start + sub.meta.ds_span, np.float64)
    grid = last[:, None] + step[:, None] * np.arange(1, h + 1)
    data = prepare_predict_data(grid, sub.meta, CFG, torch.device("cpu"))
    theta = sub.theta
    _, det, add, mult = fk.forward(theta, data, CFG)
    scale = torch.as_tensor(sub.meta.y_scale, dtype=torch.float32)
    floor = torch.as_tensor(sub.meta.floor, dtype=torch.float32)
    draws = bk.sample_draws((s, 3, h), torch.Generator().manual_seed(9),
                            torch.device("cpu"))
    out = bk.bands(theta, data, det, add, mult, scale, floor, CFG, s,
                   draws=draws, return_samples=True)
    samples = out["yhat_samples"].numpy().astype(np.float64)
    qs = [float(q) for q in bk.quantile_points(CFG.interval_width)]
    want = np.quantile(samples, qs, axis=0, method="linear")
    atol = 1e-5 * sub.meta.y_scale[:, None]
    for i, k in enumerate(("yhat_lower", "yhat_upper")):
        assert (np.abs(out[k].numpy() - want[i])
                <= atol + 1e-5 * np.abs(want[i])).all(), k


def test_engine_and_backend_stage_clocks(tmp_path, jax_fitted):
    """Each dispatch times its own host stages; the backend's stages sit
    inside the engine's "predict" span, and a cache hit dispatches
    nothing."""
    reg = _port_registry(tmp_path, jax_fitted)
    eng = PredictionEngine(reg, device="cpu", cache=ForecastCache(64))
    eng.forecast(IDS, 10, num_samples=8, seed=1)
    eng.forecast(IDS, 10, num_samples=8, seed=1)
    stages, inner = eng.stats.stages, eng.backend.stages
    assert stages.calls == {"gather": 1, "predict": 1, "scatter": 1,
                            "assemble": 2}
    assert inner.calls == {"prep": 1, "forecast": 1, "to_host": 1}
    assert all(v >= 0.0 for v in stages.seconds.values())
    assert stages.seconds["predict"] >= sum(inner.seconds.values())
    stages.reset()
    assert stages.seconds == {} and stages.calls == {}
