"""The port's quantile plane (``uncertainty/qplane.py``) and the engine's
interval reads, case for case as the JAX package's ``tests/test_qplane.py``,
on the same fitted batch carried across from the JAX package, and its
delta publish (``write_qplane_delta``) against a full publish of the
delta version.

Beside those, against the JAX package itself: the row samplers
(``_row_quantiles_map`` / ``_row_quantiles_advi``) and ADVI-mode
``compute_rows`` give its bytes on the same inputs (host numpy keyed on
``(seed, global_row)``: the plane's bitwise contract); MAP-mode
``compute_rows`` is within float32 tolerance of its (the deterministic
forecast under the draws is each package's own: rtol 1e-5, atol 1e-5 x
y_scale, as the MAP forecast's tests); and a plane either package
publishes attaches in the other with the same columns.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu.backends.registry import get_backend as jax_get_backend
from tsspark_tpu.config import ProphetConfig as JaxConfig
from tsspark_tpu.config import SeasonalityConfig as JaxSeason
from tsspark_tpu.config import SolverConfig as JaxSolver
from tsspark_tpu.serve import ParamRegistry as JaxRegistry
from tsspark_tpu.uncertainty import advi as jadvi
from tsspark_tpu.uncertainty import qplane as jqplane
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.faults import FaultPlan
from tsspark_tpu_torch.serve import (
    ForecastCache,
    ParamRegistry,
    PredictionEngine,
)
from tsspark_tpu_torch.uncertainty import advi, qplane

torch.set_num_threads(2)

JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
HOT = (7, 14, 28)
QS = qplane.DEFAULT_QUANTILES
N_COLS = 9
IDS = [f"s{i}" for i in range(6)]


@pytest.fixture(scope="module")
def jax_fitted():
    """The JAX package fits tests/test_qplane.py's batch; the port reads
    its weights as numpy leaves."""
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


def _engine(reg, **kw):
    return PredictionEngine(reg, cache=ForecastCache(0), device="cpu", **kw)


def _posterior(state):
    mu = np.nan_to_num(state.theta.numpy().astype(np.float32))
    return advi.AdviPosterior(mu=mu, rho=np.full_like(mu, -2.0),
                              elbo=np.zeros(mu.shape[0], np.float32))


def _quantile_reads(engine, ids, horizons=HOT):
    return {h: engine.quantiles(list(ids), int(h)) for h in horizons}


def _assert_bitwise(got, want):
    for h in want:
        np.testing.assert_array_equal(got[h].ds, want[h].ds)
        assert set(got[h].values) == set(want[h].values)
        for k in want[h].values:
            np.testing.assert_array_equal(
                got[h].values[k], want[h].values[k], err_msg=f"h={h} {k}")


def test_qplane_columns_bitwise_equal_compute_rows(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    pub = qplane.maybe_publish(reg, 1, backend)
    assert pub["status"] == "published" and pub["mode"] == "map"
    assert pub["buckets"] == [8, 16, 32]
    view = qplane.attach(reg.version_dir(1))
    snap = reg.load()
    for hb in view.buckets:
        ref = qplane.compute_rows(snap, CFG, backend, np.arange(len(ids)),
                                  hb)
        for pm in ref:
            np.testing.assert_array_equal(
                np.asarray(view.columns[hb][pm]), ref[pm],
                err_msg=f"hb={hb} q{pm:03d}")
    idx = np.asarray([3, 0, 5])
    rows = qplane.quantile_rows(view, snap, idx, 8)
    for i, row in enumerate(idx):
        for pm in view.columns[8]:
            np.testing.assert_array_equal(
                rows[i][f"q{pm:03d}"], np.asarray(view.columns[8][pm])[row])


def test_engine_quantiles_plane_vs_compute_bitwise(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert qplane.maybe_publish(reg, 1, backend)["status"] == "published"
    eng_plane = _engine(reg)
    eng_disp = _engine(reg)
    eng_disp._qplanes = {1: None}  # force the compute fallback
    got = _quantile_reads(eng_plane, ids)
    want = _quantile_reads(eng_disp, ids)
    _assert_bitwise(got, want)
    assert eng_plane.stats.qplane_hits == len(ids) * len(HOT)
    assert eng_plane.stats.dispatches == 0
    assert eng_disp.stats.qplane_hits == 0
    assert eng_disp.stats.qplane_misses == len(ids) * len(HOT)
    assert eng_disp.stats.snapshot()["qplane_hit_rate"] == 0.0
    assert eng_plane.stats.snapshot()["qplane_hit_rate"] == 1.0


def test_engine_quantile_coverage_rules(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert qplane.maybe_publish(reg, 1, backend)
    eng = _engine(reg)
    long_tail = eng.quantiles(ids[:2], 7, quantiles=(0.25, 0.75))
    assert set(long_tail.values) == {"q250", "q750"}
    assert long_tail.values["q250"].shape == (2, 7)
    assert eng.stats.qplane_hits == 0
    assert eng.stats.qplane_misses == 2
    hot = eng.quantiles(ids[:2], 7)
    assert set(hot.values) == {"q100", "q500", "q900"}
    assert eng.stats.qplane_hits == 2
    assert np.all(hot.values["q100"] <= hot.values["q500"])
    assert np.all(hot.values["q500"] <= hot.values["q900"])


def test_full_kill_point_sweep_every_tear_rejected(tmp_path, fitted,
                                                   monkeypatch):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    snap = reg.load()
    for k in range(N_COLS):
        vdir = str(tmp_path / f"tear{k}")
        os.makedirs(vdir)
        plan = FaultPlan(state_dir=str(tmp_path / "faults" / str(k)))
        plan.fail("qplane_publish", after=k)
        monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
        with pytest.raises(faults.FaultInjected):
            qplane.write_qplane(vdir, snap, CFG, backend)
        monkeypatch.delenv(faults.ENV_VAR)
        assert not qplane.has_qplane(vdir), f"kill point {k}"
        assert not qplane.verify_qplane(vdir), f"kill point {k}"
        with pytest.raises(qplane.QuantilePlaneError) as e:
            qplane.attach(vdir)
        assert e.value.reason == "corrupt", f"kill point {k}"


def test_torn_publish_fallback_then_bitwise_retry(tmp_path, fitted,
                                                  monkeypatch):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    vdir = reg.version_dir(1)
    ref = _quantile_reads(_engine(reg), ids)  # no plane yet: compute

    plan = FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("qplane_publish", after=3)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with pytest.raises(faults.FaultInjected):
        qplane.write_qplane(vdir, reg.load(), CFG, backend)
    monkeypatch.delenv(faults.ENV_VAR)
    assert not qplane.has_qplane(vdir)
    assert not qplane.verify_qplane(vdir)

    eng_mid = _engine(reg)
    mid = _quantile_reads(eng_mid, ids)
    assert eng_mid.stats.qplane_hits == 0
    _assert_bitwise(mid, ref)

    retry = qplane.maybe_publish(reg, 1, backend, force=True)
    assert retry["status"] == "published"
    assert qplane.verify_qplane(vdir)
    assert eng_mid.attach_qplane(1)
    after = _quantile_reads(eng_mid, ids)
    assert eng_mid.stats.qplane_hits > 0
    _assert_bitwise(after, ref)


def test_advi_mode_selected_and_bitwise(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    post = _posterior(state)
    advi.save_posterior(reg.version_dir(1), post, seed=0, num_steps=0)
    pub = qplane.maybe_publish(reg, 1, backend)
    assert pub["status"] == "published" and pub["mode"] == "advi"
    view = qplane.attach(reg.version_dir(1))
    assert view.mode == "advi"
    snap = reg.load()
    for hb in view.buckets:
        ref = qplane.compute_rows(snap, CFG, backend, np.arange(len(ids)),
                                  hb, posterior=post)
        for pm in ref:
            np.testing.assert_array_equal(
                np.asarray(view.columns[hb][pm]), ref[pm],
                err_msg=f"advi hb={hb} q{pm:03d}")
    eng = _engine(reg)
    res = eng.quantiles(ids[:3], 8)
    assert eng.stats.qplane_hits == 3
    np.testing.assert_array_equal(res.values["q500"],
                                  np.asarray(view.columns[8][500])[:3])
    # A quantile the plane does not carry is computed in the plane's ADVI
    # mode (its spec says so and the posterior loads).
    long_tail = eng.quantiles(ids[:3], 8, quantiles=(0.25,))
    assert eng.stats.qplane_misses == 3
    want = qplane.compute_rows(snap, CFG, backend, np.arange(3), 8,
                               quantiles=(0.25,), posterior=post)
    np.testing.assert_array_equal(long_tail.values["q250"], want[250])


def test_advi_publish_on_worker_processes_is_bitwise(tmp_path, fitted,
                                                     monkeypatch):
    """The ADVI-mode plane published with its rows spread over spawned
    worker processes (parts of 2 rows here) is the one-process publish
    byte for byte: every column file and the sentinel's shard CRCs."""
    backend, state, ids = fitted
    post = _posterior(state)
    snap = _registry(tmp_path, fitted).load()
    monkeypatch.setattr(qplane, "_PART_ROWS", 2)
    cols, shards = {}, {}
    for procs in (1, 3):
        vdir = tmp_path / f"procs{procs}"
        vdir.mkdir()
        spec = qplane.write_qplane(str(vdir), snap, CFG, backend,
                                   posterior=post, processes=procs)
        assert spec["mode"] == "advi"
        cols[procs] = {name: (vdir / name).read_bytes()
                       for name in sorted(os.listdir(vdir))
                       if name.startswith(qplane.QCOL_PREFIX)}
        with open(vdir / qplane.QPLANE_OK) as fh:
            shards[procs] = json.load(fh)["shards"]
    assert len(cols[1]) == N_COLS
    assert cols[3] == cols[1]
    assert shards[3] == shards[1]
    assert qplane._publish_processes(qplane.PARALLEL_MIN_ROWS - 1) == 1


def test_map_publish_on_worker_processes_is_bitwise(tmp_path, fitted,
                                                    monkeypatch):
    """The MAP-mode plane published with its rows' sampling spread over
    spawned worker processes (parts of 2 rows here; the deterministic
    components stay in this process) is the one-process publish byte for
    byte: every column file and the sentinel's shard CRCs."""
    backend, state, ids = fitted
    snap = _registry(tmp_path, fitted).load()
    monkeypatch.setattr(qplane, "_PART_ROWS", 2)
    cols, shards = {}, {}
    for procs in (1, 3):
        vdir = tmp_path / f"procs{procs}"
        vdir.mkdir()
        spec = qplane.write_qplane(str(vdir), snap, CFG, backend,
                                   processes=procs)
        assert spec["mode"] == "map"
        cols[procs] = {name: (vdir / name).read_bytes()
                       for name in sorted(os.listdir(vdir))
                       if name.startswith(qplane.QCOL_PREFIX)}
        with open(vdir / qplane.QPLANE_OK) as fh:
            shards[procs] = json.load(fh)["shards"]
    assert len(cols[1]) == N_COLS
    assert cols[3] == cols[1]
    assert shards[3] == shards[1]


def test_attach_rejects_corrupt_column(tmp_path, fitted):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert qplane.maybe_publish(reg, 1, backend)
    vdir = reg.version_dir(1)
    path = os.path.join(vdir, "qcol_h8_q500.npy")
    mm = np.lib.format.open_memmap(path, mode="r+")
    mm[2:3].view(np.uint32)[...] ^= np.uint32(0x5A5A5A5A)
    mm.flush()
    del mm
    assert not qplane.verify_qplane(vdir)
    with pytest.raises(qplane.QuantilePlaneError) as e:
        qplane.attach(vdir)
    assert e.value.reason == "corrupt"
    eng = _engine(reg)
    res = eng.quantiles(ids[:3], 7)
    assert res.version == 1 and eng.stats.qplane_hits == 0
    eng_ref = _engine(reg)
    eng_ref._qplanes = {1: None}
    ref = eng_ref.quantiles(ids[:3], 7)
    for k in ref.values:
        np.testing.assert_array_equal(res.values[k], ref.values[k])


def test_maybe_publish_idempotent_and_kill_switch(tmp_path, fitted,
                                                  monkeypatch):
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    assert qplane.maybe_publish(reg, 1, backend)["status"] == "published"
    again = qplane.maybe_publish(reg, 1, backend)
    assert again == {"status": "present", "version": 1}
    monkeypatch.setenv("TSSPARK_QPLANE", "0")
    reg2 = _registry(tmp_path, fitted, "reg2")
    assert qplane.maybe_publish(reg2, 1, backend) is None
    assert qplane.maybe_publish(reg2, 1, backend, force=True) is None
    assert not qplane.has_qplane(reg2.version_dir(1))


def test_logistic_growth_is_refused(tmp_path, fitted):
    backend, state, ids = fitted
    cfg = ProphetConfig(growth="logistic", n_changepoints=3,
                        seasonalities=CFG.seasonalities)
    reg = ParamRegistry(str(tmp_path / "logistic"), cfg)
    reg.publish(state, ids, step=np.ones(len(ids)))
    assert qplane.maybe_publish(reg, 1, backend) is None
    assert not qplane._advi_eligible(cfg)
    with pytest.raises(qplane.QuantilePlaneError):
        qplane.compute_rows(reg.load(), cfg, backend, np.arange(2), 8)


def test_storage_refusal_returns_none(tmp_path, fitted, monkeypatch):
    import errno

    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)

    def full(*_a, **_k):
        raise OSError(errno.ENOSPC, "no space left")

    monkeypatch.setattr("tsspark_tpu_torch.plane.protocol.atomic_write",
                        full)
    assert qplane.maybe_publish(reg, 1, backend) is None


@pytest.mark.parametrize("mode", ["map", "advi"])
def test_delta_publish_bitwise_base_and_full(tmp_path, fitted, mode):
    """A delta version's quantile plane: unchanged rows' cells are the
    base plane's bytes (hardlinked or copied forward), changed rows'
    cells the bytes a full publish of the delta version lands."""
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    changed = np.asarray([1, 4])
    post = _posterior(state)
    if mode == "advi":
        advi.save_posterior(reg.version_dir(1), post, seed=0, num_steps=0)
    assert qplane.maybe_publish(reg, 1, backend)["mode"] == mode
    sub, step_sub = reg.load().take(changed)
    v2 = reg.publish_delta(sub._replace(theta=sub.theta * 1.03), changed,
                           step_sub=step_sub)
    full_theta = state.theta.clone()
    full_theta[torch.as_tensor(changed)] *= 1.03
    full = ParamRegistry(str(tmp_path / "full"), CFG)
    full.publish(state._replace(theta=full_theta), ids,
                 step=np.ones(len(ids)))
    if mode == "advi":
        mu = post.mu.copy()
        mu[changed] *= 1.03
        post2 = advi.AdviPosterior(mu=mu, rho=post.rho, elbo=post.elbo)
        for r in (reg, full):
            advi.save_posterior(r.version_dir(r.active_version()), post2,
                                seed=0, num_steps=0)
    pub = qplane.maybe_publish(reg, v2, backend)
    assert pub["status"] == "published-delta" and pub["mode"] == mode
    assert qplane.maybe_publish(full, 1, backend)["mode"] == mode
    base = qplane.attach(reg.version_dir(1))
    delta = qplane.attach(reg.version_dir(v2))
    want = qplane.attach(full.version_dir(1))
    keep = np.setdiff1d(np.arange(len(ids)), changed)
    for hb in base.buckets:
        for pm in base.columns[hb]:
            d = np.asarray(delta.columns[hb][pm])
            np.testing.assert_array_equal(
                d[keep], np.asarray(base.columns[hb][pm])[keep])
            np.testing.assert_array_equal(
                d, np.asarray(want.columns[hb][pm]))
            assert not np.array_equal(
                d[changed], np.asarray(base.columns[hb][pm])[changed])
    eng = _engine(reg)
    got = eng.quantiles(ids, 14)
    assert eng.stats.qplane_hits == len(ids) and got.version == v2


def test_delta_publish_full_when_the_recipe_changed(tmp_path, fitted):
    """An ADVI-mode base with no posterior in the delta version: the
    recipe cannot be followed, so the delta version publishes full (MAP
    mode)."""
    backend, state, ids = fitted
    reg = _registry(tmp_path, fitted)
    advi.save_posterior(reg.version_dir(1), _posterior(state), seed=0,
                        num_steps=0)
    assert qplane.maybe_publish(reg, 1, backend)["mode"] == "advi"
    sub, _ = reg.load().take(np.asarray([2]))
    v2 = reg.publish_delta(sub, [2])
    pub = qplane.maybe_publish(reg, v2, backend)
    assert pub["status"] == "published" and pub["mode"] == "map"


# -- against the JAX package ---------------------------------------------------


def _row_inputs(seed=0, t_len=32, n_cp=3):
    rng = np.random.default_rng(seed)
    p = 3 + n_cp + 4
    t = (1.0 + np.arange(1, t_len + 1) / 150.0).astype(np.float32)
    return {
        "det_trend": 10 + rng.normal(0, 1, t_len),
        "det_add": rng.normal(0, 0.5, t_len),
        "det_mult": rng.normal(0, 0.05, t_len).astype(np.float32),
        "t": t,
        "theta": rng.normal(0, 0.3, p).astype(np.float32),
        "mu": rng.normal(0, 0.3, p).astype(np.float32),
        "rho": (-2 + 0.3 * rng.normal(0, 1, p)).astype(np.float32),
        "s": np.sort(rng.uniform(0.1, 0.9, n_cp)).astype(np.float32),
        "x": rng.normal(0, 1, (t_len, 4)).astype(np.float32),
        "mm": np.asarray([0, 1, 0, 1], np.float32),
    }


@pytest.mark.parametrize("row", [0, 5, 123456])
@pytest.mark.parametrize("growth", ["linear", "flat"])
def test_row_samplers_give_the_jax_packages_bytes(growth, row):
    cfg = ProphetConfig(growth=growth, n_changepoints=3,
                        seasonalities=CFG.seasonalities)
    jcfg = JaxConfig(growth=growth, n_changepoints=3,
                     seasonalities=JCFG.seasonalities)
    d = _row_inputs(row % 7)
    args_map = (d["det_trend"], d["det_add"], d["det_mult"], d["t"],
                d["theta"], 3.5, 1.25)
    tail = (QS, 256, 11, row)
    np.testing.assert_array_equal(
        qplane._row_quantiles_map(*args_map, cfg, *tail),
        jqplane._row_quantiles_map(*args_map, jcfg, *tail))
    args_advi = (d["mu"], d["rho"], d["s"], d["x"], d["mm"], d["t"], 3.5,
                 1.25)
    np.testing.assert_array_equal(
        qplane._row_quantiles_advi(*args_advi, cfg, *tail),
        jqplane._row_quantiles_advi(*args_advi, jcfg, *tail))


@pytest.fixture
def both_registries(tmp_path, fitted, jax_fitted):
    jreg = JaxRegistry(str(tmp_path / "jax_registry"), JCFG)
    jreg.publish(jax_fitted[1], IDS, step=np.ones(len(IDS)))
    return _registry(tmp_path, fitted), jreg


def test_compute_rows_against_the_jax_package(both_registries, fitted,
                                              jax_fitted):
    reg, jreg = both_registries
    backend, state, _ = fitted
    snap, jsnap = reg.load(), jreg.load()
    post = _posterior(state)
    jpost = jadvi.AdviPosterior(mu=post.mu, rho=post.rho, elbo=post.elbo)
    idx = np.arange(len(IDS))
    y_scale = np.asarray(state.meta.y_scale)[:, None]
    for hb in (8, 32):
        got = qplane.compute_rows(snap, CFG, backend, idx, hb,
                                  posterior=post)
        want = jqplane.compute_rows(jsnap, JCFG, jax_fitted[0], idx, hb,
                                    posterior=jpost)
        for pm in want:
            np.testing.assert_array_equal(got[pm], want[pm])
        got = qplane.compute_rows(snap, CFG, backend, idx, hb)
        want = jqplane.compute_rows(jsnap, JCFG, jax_fitted[0], idx, hb)
        for pm in want:
            err = np.abs(got[pm] - want[pm]) - 1e-5 * np.abs(want[pm])
            assert (err <= 1e-5 * y_scale).all(), float(err.max())


@pytest.mark.parametrize("mode", ["map", "advi"])
def test_planes_attach_across_packages(both_registries, fitted, jax_fitted,
                                       mode):
    reg, jreg = both_registries
    backend, state, _ = fitted
    if mode == "advi":
        post = _posterior(state)
        advi.save_posterior(reg.version_dir(1), post, seed=0, num_steps=0)
        jadvi.save_posterior(jreg.version_dir(1), jadvi.AdviPosterior(
            mu=post.mu, rho=post.rho, elbo=post.elbo), seed=0, num_steps=0)
    assert qplane.maybe_publish(reg, 1, backend)["mode"] == mode
    assert jqplane.maybe_publish(jreg, 1, jax_fitted[0])["mode"] == mode
    port_dir, jax_dir = reg.version_dir(1), jreg.version_dir(1)
    for attach in (qplane.attach, jqplane.attach):
        for vdir in (port_dir, jax_dir):
            view = attach(vdir, expected_n=len(IDS))
            assert view.mode == mode and view.buckets == (8, 16, 32)
    pv, jv = qplane.attach(port_dir), jqplane.attach(port_dir)
    for hb in pv.buckets:
        for pm in pv.columns[hb]:
            np.testing.assert_array_equal(np.asarray(jv.columns[hb][pm]),
                                          np.asarray(pv.columns[hb][pm]))
            if mode == "advi":  # host sampling: the same bytes
                np.testing.assert_array_equal(
                    np.asarray(jqplane.attach(jax_dir).columns[hb][pm]),
                    np.asarray(pv.columns[hb][pm]))
    assert qplane.qplane_nbytes(port_dir) == jqplane.qplane_nbytes(jax_dir)
