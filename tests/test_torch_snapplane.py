"""The port's snapshot plane (``serve/snapplane.py``) and the registry's
plane and delta versions, case for case as the JAX package's
``tests/test_snapshot_plane.py`` (its pool, cache, hygiene and scale-rung
cases aside: those modules are not ported yet) and the delta cases of
``tests/test_fplane.py``'s registry side, on the fitted batch carried
across from the JAX package.

Across packages: a version published by either registry (full and
delta, plane and npz) attaches in the other with every column the same
bits, and engines of both packages serve it within float32 tolerance.
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
from tsspark_tpu.serve import snapplane as jsnapplane
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
from tsspark_tpu_torch.serve import (
    ForecastCache,
    ParamRegistry,
    PredictionEngine,
    RegistryError,
)
from tsspark_tpu_torch.serve import snapplane

torch.set_num_threads(2)

JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
IDS = [f"s{i}" for i in range(6)]
CHANGED = np.asarray([1, 3])


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX package fits tests/test_snapshot_plane.py's batch."""
    rng = np.random.default_rng(3)
    t = np.arange(140.0)
    y = (12 + 0.03 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 140)))
    backend = jax_get_backend("tpu", JCFG, JaxSolver(max_iters=25))
    return backend, backend.fit(t, jnp.asarray(y))


def _port_state(jstate):
    leaves = {f: np.asarray(getattr(jstate, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    leaves.update(jstate.meta._asdict())
    return fitstate_from_numpy(leaves, "cpu")


@pytest.fixture(scope="module")
def state(jax_fitted):
    return _port_state(jax_fitted[1])


def _registry(tmp_path, state, name="registry", **kwargs):
    reg = ParamRegistry(str(tmp_path / name), CFG, **kwargs)
    reg.publish(state, IDS, step=np.ones(len(IDS)))
    return reg


def _scaled(state, k):
    return state._replace(theta=state.theta * k)


def _tear(path):
    """Byte-flip several offsets of one file."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        for k in range(1, 8):
            fh.seek(size * k // 8)
            chunk = fh.read(16)
            fh.seek(size * k // 8)
            fh.write(bytes(b ^ 0xFF for b in chunk))


def _engine(reg):
    return PredictionEngine(reg, cache=ForecastCache(64), device="cpu")


def _forecast_values(engine, sids, horizon):
    res = engine.forecast(sids, horizon)
    return res.version, np.asarray(res.ds), {
        k: np.asarray(v) for k, v in res.values.items()}


def _assert_bitwise(a, b):
    assert a[0] == b[0]
    assert np.array_equal(a[1], b[1])
    assert set(a[2]) == set(b[2])
    for k in a[2]:
        assert np.array_equal(a[2][k], b[2][k]), k


def _columns(vdir):
    spec = snapplane.read_json(os.path.join(vdir, snapplane.SNAP_SPEC))
    return {name: np.asarray(np.load(os.path.join(
        vdir, f"{snapplane.COL_PREFIX}{name}.npy"))) for name in
        spec["columns"]}


# -- plane write/attach mechanics ---------------------------------------------


def test_publish_lands_plane_and_npz(tmp_path, state):
    reg = _registry(tmp_path, state)
    vdir = os.path.join(reg.root, "v000001")
    names = set(os.listdir(vdir))
    assert {"snap_spec.json", "snapok.json", "state.npz",
            "state.json"} <= names
    assert {"snapcol_theta.npy", "snapcol_ids.npy",
            "snapcol_ids_sorted.npy", "snapcol_id_order.npy",
            "snapcol_extra_step.npy"} <= names
    assert snapplane.verify_plane(vdir)
    assert snapplane.snapshot_nbytes(vdir) > 0
    assert reg._read_manifest()["versions"]["1"]["formats"] == ["mmap",
                                                                "npz"]
    # Each leaf of the npz is the plane's column, bit for bit.
    npz = np.load(os.path.join(vdir, "state.npz"))
    cols = _columns(vdir)
    for k in snapplane.state_columns(state, {"step": np.ones(6)}):
        assert np.array_equal(npz[k], cols[k]), k


def test_mmap_rows_match_dict_lookup(tmp_path, state):
    reg = _registry(tmp_path, state)
    mm = reg.load()
    npz = ParamRegistry(reg.root, CFG, snapshot_format="npz").load()
    assert mm.source == "mmap" and npz.source == "npz"
    for query in (["s3", "s1", "s1", "s5"], ["nope"], ["s0", "zzz"], []):
        i_mm, miss_mm = mm.rows(query)
        i_npz, miss_npz = npz.rows(query)
        assert i_mm.tolist() == i_npz.tolist()
        assert miss_mm == miss_npz
    sub_mm, step_mm = mm.take(np.asarray([4, 0]))
    sub_npz, step_npz = npz.take(np.asarray([4, 0]))
    assert torch.equal(sub_mm.theta, sub_npz.theta)
    assert np.array_equal(step_mm, step_npz)


def test_snapshot_format_option_and_environment(tmp_path, state,
                                                monkeypatch):
    with pytest.raises(ValueError):
        ParamRegistry(str(tmp_path / "bad"), CFG, snapshot_format="zip")
    monkeypatch.setenv("TSSPARK_SNAPSHOT_FORMAT", "npz")
    reg = _registry(tmp_path, state, name="env_npz")
    assert reg.snapshot_format == "npz"
    assert not snapplane.has_plane(reg.version_dir(1))
    assert reg.load().source == "npz"
    monkeypatch.setenv("TSSPARK_SNAPSHOT_FORMAT", "mmap")
    reg = _registry(tmp_path, state, name="env_mmap")
    assert not os.path.exists(os.path.join(reg.version_dir(1),
                                           "state.npz"))
    assert reg.load().source == "mmap"


def test_torn_plane_shard_rejected_then_npz_archival_fallback(tmp_path,
                                                              state):
    reg = _registry(tmp_path, state)
    vdir = os.path.join(reg.root, "v000001")
    _tear(os.path.join(vdir, "snapcol_theta.npy"))
    assert not snapplane.verify_plane(vdir)
    with pytest.raises(snapplane.SnapshotPlaneError):
        snapplane.attach(vdir)
    with pytest.warns(RuntimeWarning, match="archival npz"):
        snap = reg.load()
    assert snap.source == "npz" and snap.version == 1
    assert snap.fallback_from is None


def test_torn_plane_only_version_falls_back_to_previous(tmp_path, state):
    reg = _registry(tmp_path, state)
    v2 = reg.publish(_scaled(state, 1.01), IDS, snapshot_format="mmap")
    _tear(os.path.join(reg.root, f"v{v2:06d}", "snapcol_theta.npy"))
    with pytest.warns(RuntimeWarning, match="last good"):
        snap = reg.load()
    assert snap.version == 1 and snap.fallback_from == v2
    with pytest.raises(RegistryError) as e:
        reg.load(v2)
    assert e.value.reason == "corrupt-snapshot"


def test_engine_predictions_bitwise_equal_across_formats(tmp_path, state):
    """Engines on the mmap plane and on the npz serve the same bits,
    through a version flip and under a registry fallback."""
    reg_mm = _registry(tmp_path, state)
    reg_npz = ParamRegistry(reg_mm.root, CFG, snapshot_format="npz")
    eng_mm, eng_npz = _engine(reg_mm), _engine(reg_npz)
    assert eng_mm.refresh().source == "mmap"
    assert eng_npz.refresh().source == "npz"
    for sids, h in ((["s0"], 7), (["s4", "s2", "s0"], 12),
                    (["s5", "s5"], 3)):
        _assert_bitwise(_forecast_values(eng_mm, sids, h),
                        _forecast_values(eng_npz, sids, h))
    v2 = reg_mm.publish(_scaled(state, 1.02), IDS, step=np.ones(len(IDS)))
    a = _forecast_values(eng_mm, ["s1", "s3"], 9)
    b = _forecast_values(eng_npz, ["s1", "s3"], 9)
    assert a[0] == v2
    _assert_bitwise(a, b)
    for name in ("state.npz", "snapcol_theta.npy"):
        _tear(os.path.join(reg_mm.root, f"v{v2:06d}", name))
    with pytest.warns(RuntimeWarning, match="last good"):
        a = _forecast_values(_engine(reg_mm), ["s2", "s0"], 7)
    with pytest.warns(RuntimeWarning, match="last good"):
        b = _forecast_values(_engine(reg_npz), ["s2", "s0"], 7)
    assert a[0] == 1
    _assert_bitwise(a, b)


# -- delta versions --------------------------------------------------------------


def test_delta_publish_copy_forward_bitwise(tmp_path, state):
    """Unchanged rows are the base version's bytes (untouched columns
    hardlinked), changed rows the bytes a full publish of the delta
    version's state lands; the engine serves the delta version."""
    reg = _registry(tmp_path, state)
    snap1 = reg.load()
    sub, step_sub = snap1.take(CHANGED)
    refit = _scaled(sub, 1.02)
    v2 = reg.publish_delta(refit, CHANGED.tolist(), step_sub=step_sub,
                           data_stamp=5)
    assert reg.active_version() == v2
    entry = reg._read_manifest()["versions"][str(v2)]
    assert entry["formats"] == ["mmap"] and entry["delta_from"] == 1
    assert entry["n_changed"] == 2
    info = reg.delta_info(v2)
    assert info["base_version"] == 1 and info["changed_rows"] == [1, 3]
    assert info["changed_ids"] == ["s1", "s3"] and info["version"] == v2
    assert reg.delta_info(1) is None
    assert reg.version_stamp(v2) == 5 and reg.version_stamp(1) == 0
    base_dir, delta_dir = reg.version_dir(1), reg.version_dir(v2)
    assert snapplane.verify_plane(delta_dir)
    for name in ("ids", "ids_sorted", "id_order"):
        assert os.path.samefile(
            os.path.join(base_dir, f"snapcol_{name}.npy"),
            os.path.join(delta_dir, f"snapcol_{name}.npy"))
    full_theta = state.theta.clone()
    full_theta[torch.as_tensor(CHANGED)] = refit.theta
    full = ParamRegistry(str(tmp_path / "full"), CFG)
    full.publish(state._replace(theta=full_theta), IDS,
                 step=np.ones(len(IDS)))
    base, delta, want = (_columns(base_dir), _columns(delta_dir),
                         _columns(full.version_dir(1)))
    keep = np.setdiff1d(np.arange(len(IDS)), CHANGED)
    for k in base:
        assert np.array_equal(delta[k][keep], base[k][keep]), k
        assert np.array_equal(delta[k], want[k]), k
    snap2 = reg.load()
    assert snap2.version == v2 and snap2.source == "mmap"
    a = _forecast_values(_engine(reg), IDS, 7)
    b = _forecast_values(_engine(full), IDS, 7)
    assert np.array_equal(a[1], b[1])
    for k in a[2]:
        assert np.array_equal(a[2][k], b[2][k]), k


def test_zero_row_delta_hardlinks_everything(tmp_path, state):
    reg = _registry(tmp_path, state)
    v2 = reg.publish_delta(None, [])
    base_dir, delta_dir = reg.version_dir(1), reg.version_dir(v2)
    for name in os.listdir(delta_dir):
        if name.startswith(snapplane.COL_PREFIX):
            assert os.path.samefile(os.path.join(base_dir, name),
                                    os.path.join(delta_dir, name))
    assert reg.delta_info(v2)["n_changed"] == 0


def test_delta_refusals(tmp_path, state):
    reg = ParamRegistry(str(tmp_path / "empty"), CFG)
    with pytest.raises(RegistryError) as e:
        reg.publish_delta(None, [])
    assert e.value.reason == "no-active-version"
    reg = _registry(tmp_path, state, snapshot_format="npz")
    with pytest.raises(RegistryError) as e:
        reg.publish_delta(None, [])
    assert e.value.reason == "delta-base-missing-plane"
    with pytest.raises(RegistryError) as e:
        reg.publish_delta(None, [], base_version=7)
    assert e.value.reason == "unknown-version"
    reg = _registry(tmp_path, state, name="both")
    with pytest.raises(ValueError):
        reg.publish_delta(None, [1])          # rows without a refit
    sub, _ = reg.load().take(CHANGED)
    with pytest.raises(ValueError):
        reg.publish_delta(sub, [1, 2, 3])     # 2 refit rows for 3


def test_torn_delta_plane_falls_back_to_its_base(tmp_path, state):
    reg = _registry(tmp_path, state)
    sub, _ = reg.load().take(CHANGED)
    v2 = reg.publish_delta(_scaled(sub, 1.02), CHANGED)
    _tear(os.path.join(reg.version_dir(v2), "snapcol_theta.npy"))
    with pytest.warns(RuntimeWarning, match="last good"):
        snap = reg.load()
    assert snap.version == 1 and snap.fallback_from == v2


# -- across packages -----------------------------------------------------------


def _jax_sub(jstate, rows):
    from tsspark_tpu.serve.registry import take_fitstate

    sub = take_fitstate(jstate, rows)
    return sub._replace(theta=jnp.asarray(sub.theta) * 1.02)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_versions_attach_across_packages(tmp_path, state, jax_fitted,
                                         writer):
    """A full version and a delta version over it, published by one
    package, attach in the other's registry: every plane column the
    same bits, and each package's engine serves them within float32
    tolerance of the other's."""
    backend, jstate = jax_fitted
    root = str(tmp_path / "registry")
    if writer == "jax":
        wreg = JaxRegistry(root, JCFG)
        wreg.publish(jstate, IDS, step=np.ones(len(IDS)))
        v2 = wreg.publish_delta(_jax_sub(jstate, CHANGED), CHANGED)
    else:
        wreg = _registry(tmp_path, state)
        sub, _ = wreg.load().take(CHANGED)
        v2 = wreg.publish_delta(_scaled(sub, 1.02), CHANGED)
    preg, jreg = ParamRegistry.open(root), JaxRegistry.open(root)
    assert preg.delta_info(v2)["changed_rows"] == [1, 3]
    assert jreg.delta_info(v2)["changed_rows"] == [1, 3]
    for v in (1, v2):
        vdir = preg.version_dir(v)
        pv = snapplane.attach(vdir, expected_n=len(IDS))
        jv = jsnapplane.attach(vdir, expected_n=len(IDS))
        assert np.array_equal(pv.state.theta.numpy(),
                              np.asarray(jv.state.theta))
        for f in jv.state.meta._fields:
            assert np.array_equal(getattr(pv.state.meta, f),
                                  np.asarray(getattr(jv.state.meta, f)))
        assert np.array_equal(pv.ids, jv.ids)
        assert snapplane.snapshot_nbytes(vdir) == \
            jsnapplane.snapshot_nbytes(vdir)
        snap, jsnap = preg.load(v), jreg.load(v)
        assert snap.source == jsnap.source == "mmap"
    peng = PredictionEngine(preg, cache=ForecastCache(0), device="cpu")
    jeng = JaxEngine(jreg, cache=JaxCache(0))
    got = peng.forecast(IDS, 14)
    want = jeng.forecast(IDS, 14)
    assert got.version == want.version == v2
    np.testing.assert_array_equal(got.ds, want.ds)
    scale = np.asarray(state.meta.y_scale)[:, None]
    for k in ("yhat", "trend"):
        err = np.abs(got.values[k] - np.asarray(want.values[k]))
        assert (err <= 1e-5 * np.abs(np.asarray(want.values[k]))
                + 1e-5 * scale).all(), (k, float(err.max()))
