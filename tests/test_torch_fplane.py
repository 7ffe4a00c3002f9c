"""The port's forecast plane (``serve/fplane.py``) and the engine's plane
reads, case for case as the JAX package's ``tests/test_fplane.py``, on
the fitted batch carried across from the JAX package: every plane cell
bitwise a direct ``backend.predict`` (the engine's compute path, K1 on
the card, the plain forward pass here), delta copy-forward flips, torn
publishes refused and served by compute, the coverage rules and the
publish switches.

Across packages: a version with both planes published by the JAX
registry attaches in the port's registry and engine, and one published
by the port in the JAX package's; plane columns read back bitwise in
either package, and forecasts served from the other package's plane are
within float32 tolerance of the reader's own compute path.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu.backends.registry import get_backend as jax_get_backend
from tsspark_tpu.config import ProphetConfig as JaxConfig
from tsspark_tpu.config import SeasonalityConfig as JaxSeason
from tsspark_tpu.config import SolverConfig as JaxSolver
from tsspark_tpu.serve import ForecastCache as JaxCache
from tsspark_tpu.serve import ParamRegistry as JaxRegistry
from tsspark_tpu.serve import PredictionEngine as JaxEngine
from tsspark_tpu.serve import fplane as jfplane
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.io import budget as iobudget
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.faults import FaultPlan
from tsspark_tpu_torch.serve import (
    ForecastCache,
    ParamRegistry,
    PredictionEngine,
    fplane,
)

torch.set_num_threads(2)

JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
HOT = fplane.DEFAULT_HOT_HORIZONS
IDS = [f"s{i}" for i in range(6)]


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX package fits tests/test_fplane.py's batch."""
    rng = np.random.default_rng(7)
    t = np.arange(150.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 150)))
    backend = jax_get_backend("tpu", JCFG, JaxSolver(max_iters=25))
    return backend, backend.fit(t, jnp.asarray(y))


@pytest.fixture(scope="module")
def fitted(jax_fitted):
    state = jax_fitted[1]
    leaves = {f: np.asarray(getattr(state, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    leaves.update(state.meta._asdict())
    backend = get_backend("cuda", CFG, SolverConfig(max_iters=25),
                          device="cpu")
    return backend, fitstate_from_numpy(leaves, "cpu"), IDS


def _registry(tmp_path, fitted, name="registry"):
    _, state, ids = fitted
    reg = ParamRegistry(str(tmp_path / name), CFG)
    reg.publish(state, ids, step=np.ones(len(ids)))
    return reg


def _engine(reg):
    return PredictionEngine(reg, cache=ForecastCache(0), device="cpu")


def _forecasts(engine, ids, horizons=HOT):
    return {h: engine.forecast(list(ids), int(h), num_samples=0, seed=0)
            for h in horizons}


def _assert_bitwise(got, want):
    for h in want:
        np.testing.assert_array_equal(got[h].ds, want[h].ds)
        assert set(got[h].values) == set(want[h].values)
        for k in want[h].values:
            np.testing.assert_array_equal(
                got[h].values[k], want[h].values[k], err_msg=f"h={h} {k}")


def test_bucket_ladder():
    assert fplane.bucket_ladder(HOT) == (8, 16, 32)
    assert fplane.bucket_ladder((3,)) == (8,)
    assert fplane.bucket_ladder((9, 16, 17)) == (16, 32)


def test_plane_columns_bitwise_equal_direct_predict(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    pub = fplane.maybe_publish(reg, 1, backend)
    assert pub["status"] == "published" and pub["buckets"] == [8, 16, 32]
    assert pub["nbytes"] == fplane.plane_nbytes(reg.version_dir(1)) > 0
    view = fplane.attach(reg.version_dir(1))
    snap = reg.load()
    sub, step = snap.take(np.arange(len(ids)))
    for hb in view.buckets:
        grid = fplane.future_grid(sub, step, hb)
        direct = backend.predict(sub, grid, num_samples=0)
        for k in fplane.POINT_KEYS:
            np.testing.assert_array_equal(
                np.asarray(view.columns[hb][k]), np.asarray(direct[k]),
                err_msg=f"hb={hb} {k}")
    idx = np.asarray([3, 0, 5])
    rows = fplane.plane_rows(view, snap, idx, 8)
    sub2, step2 = snap.take(idx)
    grid2 = fplane.future_grid(sub2, step2, 8)
    direct2 = backend.predict(sub2, grid2, num_samples=0)
    for i in range(len(idx)):
        np.testing.assert_array_equal(rows[i]["ds"], grid2[i])
        for k in fplane.POINT_KEYS:
            np.testing.assert_array_equal(rows[i][k],
                                          np.asarray(direct2[k])[i])


def test_engine_plane_serves_bitwise_vs_compute_full_grid(tmp_path,
                                                          fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert fplane.maybe_publish(reg, 1, backend)["status"] == "published"
    eng_plane, eng_disp = _engine(reg), _engine(reg)
    eng_disp._planes = {1: None}  # force the compute path
    got = _forecasts(eng_plane, ids)
    want = _forecasts(eng_disp, ids)
    _assert_bitwise(got, want)
    assert eng_plane.stats.plane_hits == len(ids) * len(HOT)
    assert eng_plane.stats.dispatches == 0
    assert eng_disp.stats.plane_hits == 0
    assert eng_disp.stats.dispatches > 0
    assert eng_plane.stats.snapshot()["plane_hit_rate"] == 1.0


def test_engine_plane_mixed_with_cache_hits(tmp_path, fitted):
    """A group that mixes LRU hits with plane rows is served row by row,
    the same bits as the whole-batch gather."""
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    fplane.maybe_publish(reg, 1, backend)
    eng = PredictionEngine(reg, cache=ForecastCache(64), device="cpu")
    first = eng.forecast(ids[:2], 7, num_samples=20, seed=1)
    assert first.values["yhat"].shape == (2, 7)
    whole = _engine(reg).forecast(ids, 7)
    # Cache the deterministic rows of two series through a plane-less
    # engine sharing the cache, then a mixed group reads the plane.
    eng_d = PredictionEngine(reg, cache=eng.cache, device="cpu")
    eng_d._planes = {1: None}
    eng_d.forecast(ids[:2], 7)
    mixed = eng.forecast(ids, 7)
    assert mixed.from_cache == len(ids)
    for k in whole.values:
        np.testing.assert_array_equal(mixed.values[k], whole.values[k])


def test_engine_plane_coverage_rules(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert fplane.maybe_publish(reg, 1, backend)
    eng = _engine(reg)
    sampled = eng.forecast(ids[:2], 7, num_samples=20, seed=3)
    assert sampled.values["yhat"].shape == (2, 7)
    long_tail = eng.forecast(ids[:2], 60, num_samples=0, seed=0)
    assert long_tail.values["yhat"].shape == (2, 60)
    assert eng.stats.plane_hits == 0
    assert eng.stats.dispatches > 0
    hot = eng.forecast(ids[:2], 7, num_samples=0, seed=0)
    assert hot.values["yhat"].shape == (2, 7)
    assert eng.stats.plane_hits == 2


def test_delta_copy_forward_plane_flip(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert fplane.maybe_publish(reg, 1, backend)["status"] == "published"
    base_view = fplane.attach(reg.version_dir(1))
    snap1 = reg.load()
    changed = np.asarray([1, 3])
    sub, step_sub = snap1.take(changed)
    refit = sub._replace(theta=sub.theta * 1.02)
    v2 = reg.publish_delta(refit, changed.tolist(), step_sub=step_sub)
    pub = fplane.maybe_publish(reg, v2, backend)
    assert pub["status"] == "published-delta"
    view2 = fplane.attach(reg.version_dir(v2))
    snap2 = reg.load()
    assert snap2.version == v2
    unchanged = np.asarray([0, 2, 4, 5])
    sub_ch, step_ch = snap2.take(changed)
    for hb in view2.buckets:
        grid = fplane.future_grid(sub_ch, step_ch, hb)
        direct = backend.predict(sub_ch, grid, num_samples=0)
        for k in fplane.POINT_KEYS:
            np.testing.assert_array_equal(
                np.asarray(view2.columns[hb][k])[unchanged],
                np.asarray(base_view.columns[hb][k])[unchanged],
                err_msg=f"copy-forward hb={hb} {k}")
            np.testing.assert_array_equal(
                np.asarray(view2.columns[hb][k])[changed],
                np.asarray(direct[k]), err_msg=f"changed hb={hb} {k}")
        assert not np.array_equal(
            np.asarray(view2.columns[hb]["yhat"])[changed],
            np.asarray(base_view.columns[hb]["yhat"])[changed])
    eng_plane, eng_disp = _engine(reg), _engine(reg)
    eng_disp._planes = {v2: None}
    _assert_bitwise(_forecasts(eng_plane, ids), _forecasts(eng_disp, ids))
    assert eng_plane.stats.plane_hits > 0


def test_zero_delta_hardlinks_the_base_plane(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    fplane.maybe_publish(reg, 1, backend)
    v2 = reg.publish_delta(None, [])
    assert fplane.maybe_publish(reg, v2, backend)["status"] == \
        "published-delta"
    for name in os.listdir(reg.version_dir(v2)):
        if name.startswith(fplane.FCOL_PREFIX):
            assert os.path.samefile(
                os.path.join(reg.version_dir(1), name),
                os.path.join(reg.version_dir(v2), name))


def test_torn_publish_rejected_fallback_then_bitwise_retry(
        tmp_path, fitted, monkeypatch):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    vdir = reg.version_dir(1)
    ref = _forecasts(_engine(reg), ids)  # no plane yet: compute
    plan = FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("fplane_publish", after=3, mode="raise")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with pytest.raises(faults.FaultInjected):
        fplane.write_plane(vdir, reg.load(), backend)
    monkeypatch.delenv(faults.ENV_VAR)
    assert not fplane.has_plane(vdir)
    assert not fplane.verify_plane(vdir)
    with pytest.raises(fplane.ForecastPlaneError) as e:
        fplane.attach(vdir)
    assert e.value.reason == "corrupt"
    eng_mid = _engine(reg)
    mid = _forecasts(eng_mid, ids)
    assert eng_mid.stats.plane_hits == 0
    _assert_bitwise(mid, ref)
    retry = fplane.maybe_publish(reg, 1, backend, force=True)
    assert retry["status"] == "published"
    assert fplane.verify_plane(vdir)
    assert eng_mid.attach_plane(1)
    after = _forecasts(eng_mid, ids)
    assert eng_mid.stats.plane_hits > 0
    _assert_bitwise(after, ref)


def test_attach_rejects_corrupt_column(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert fplane.maybe_publish(reg, 1, backend)
    vdir = reg.version_dir(1)
    path = os.path.join(vdir, "fcol_h8_yhat.npy")
    mm = np.lib.format.open_memmap(path, mode="r+")
    mm[2:3].view(np.uint32)[...] ^= np.uint32(0x5A5A5A5A)
    mm.flush()
    del mm
    assert not fplane.verify_plane(vdir)
    with pytest.raises(fplane.ForecastPlaneError) as e:
        fplane.attach(vdir)
    assert e.value.reason == "corrupt"
    eng = _engine(reg)
    res = eng.forecast(ids[:3], 7, num_samples=0, seed=0)
    assert res.version == 1 and eng.stats.plane_hits == 0
    eng_ref = _engine(reg)
    eng_ref._planes = {1: None}
    ref = eng_ref.forecast(ids[:3], 7, num_samples=0, seed=0)
    for k in ref.values:
        np.testing.assert_array_equal(res.values[k], ref.values[k])


def test_maybe_publish_idempotent_and_kill_switch(tmp_path, fitted,
                                                  monkeypatch):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert fplane.maybe_publish(reg, 1, backend)["status"] == "published"
    again = fplane.maybe_publish(reg, 1, backend)
    assert again == {"status": "present", "version": 1}
    monkeypatch.setenv("TSSPARK_FPLANE", "0")
    reg2 = _registry(tmp_path, fitted, name="reg2")
    assert fplane.maybe_publish(reg2, 1, backend) is None
    assert not fplane.has_plane(reg2.version_dir(1))


def test_disk_pressure_sheds_and_budget_refusal_returns_none(
        tmp_path, fitted, monkeypatch):
    """Speculative work: under the ladder's shed state the publish is
    refused before any byte lands, and a budget refusal mid-write
    returns None instead of failing the flip."""
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    used = iobudget.DiskBudget(reg.root).used_bytes()
    monkeypatch.setenv(iobudget.ENV_BUDGET_ROOT, reg.root)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, str(int(used * 1.2)))
    assert fplane.maybe_publish(reg, 1, backend) is None  # shed_spec
    assert not fplane.has_plane(reg.version_dir(1))
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, str(int(used * 2)))
    monkeypatch.setattr(fplane, "active_ladder", lambda root: None)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, str(used + 64))
    assert fplane.maybe_publish(reg, 1, backend) is None  # DiskFull
    assert not fplane.has_plane(reg.version_dir(1))


# -- across packages -----------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_planes_attach_across_packages(tmp_path, fitted, jax_fitted,
                                       writer):
    backend, state, ids = fitted
    jbackend, jstate = jax_fitted
    root = str(tmp_path / "registry")
    if writer == "jax":
        wreg = JaxRegistry(root, JCFG)
        wreg.publish(jstate, ids, step=np.ones(len(ids)))
        assert jfplane.maybe_publish(wreg, 1, jbackend)["status"] == \
            "published"
    else:
        wreg = _registry(tmp_path, fitted)
        assert fplane.maybe_publish(wreg, 1, backend)["status"] == \
            "published"
    preg, jreg = ParamRegistry.open(root), JaxRegistry.open(root)
    vdir = preg.version_dir(1)
    pv, jv = fplane.attach(vdir), jfplane.attach(vdir)
    assert pv.buckets == jv.buckets == (8, 16, 32)
    assert fplane.plane_nbytes(vdir) == jfplane.plane_nbytes(vdir)
    for hb in pv.buckets:
        for k in fplane.POINT_KEYS:
            np.testing.assert_array_equal(np.asarray(pv.columns[hb][k]),
                                          np.asarray(jv.columns[hb][k]))
    peng = _engine(preg)
    jeng = JaxEngine(jreg, cache=JaxCache(0))
    peng_c = _engine(preg)
    peng_c._planes = {1: None}
    jeng_c = JaxEngine(jreg, cache=JaxCache(0))
    jeng_c._planes = {1: None}
    scale = np.asarray(state.meta.y_scale)[:, None]
    for eng, own in ((peng, peng_c), (jeng, jeng_c)):
        for h in HOT:
            got = eng.forecast(ids, h, num_samples=0, seed=0)
            want = own.forecast(ids, h, num_samples=0, seed=0)
            np.testing.assert_array_equal(got.ds, want.ds)
            for k in ("yhat", "trend", "additive"):
                g = np.asarray(got.values[k])
                w = np.asarray(want.values[k])
                assert (np.abs(g - w) <= 1e-5 * np.abs(w)
                        + 1e-5 * scale).all(), (writer, h, k)
    assert peng.stats.plane_hits == len(ids) * len(HOT)
    assert jeng.stats.plane_hits == len(ids) * len(HOT)
