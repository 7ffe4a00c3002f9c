"""The port's delta-refit cycle (``tsspark_tpu_torch.refit``) on the CPU:
detect, the resident fit of the changed rows on the forced host mesh,
the copy-forward delta publish (snapshot, forecast and quantile planes,
the ADVI posterior) and the flip, held against the JAX package's
invariants and its plan format.

Sizes are the reference tests' (``tests/test_refit.py``): the
``demo_weekly`` plane dataset, 24 series x 64 days in 8-row shards,
8-row waves, 20 solver iterations.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsspark_tpu import refit as jrefit
from tsspark_tpu.chaos import invariants as jinv
from tsspark_tpu_torch import orchestrate, refit, resident
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data import plane
from tsspark_tpu_torch.parallel import mesh as tmesh
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.engine import PredictionEngine
from tsspark_tpu_torch.serve.registry import ParamRegistry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ProphetConfig(
    seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
    n_changepoints=3,
)
SOLVER = SolverConfig(max_iters=20)
N, T, SHARD, CHUNK = 24, 64, 8, 8


@pytest.fixture(autouse=True)
def host_mesh(monkeypatch):
    """Every test runs on the virtual host mesh of 8 CPU entries (the
    reference's tests run on its 8 virtual devices); restored after."""
    monkeypatch.setenv(tmesh.HOST_MESH_ENV, "8")


def _setup(tmp_path, seed=2):
    """Fresh plane dataset + cold resident fit + published registry."""
    spec = plane.DatasetSpec("demo_weekly", N, T, seed=seed,
                             shard_rows=SHARD)
    dset = plane.ensure(spec, root=str(tmp_path / "plane"))
    ids = plane.series_ids(spec)
    out = str(tmp_path / "cold_out")
    os.makedirs(out, exist_ok=True)
    orchestrate.save_run_config(out, CFG, SOLVER)
    st = resident.run_resident(data_dir=dset, out_dir=out, series=N,
                               chunk=CHUNK, phase1_iters=0,
                               no_phase1_tune=True, device="cpu")
    assert st["complete"] and st["fit_path"] == "resident"
    reg = ParamRegistry(str(tmp_path / "registry"), CFG)
    v1 = orchestrate.publish_fit_state(
        reg, out, ids, data_stamp=plane.delta_seq(dset)
    )
    return spec, dset, reg, ids, v1


def _vdir(reg, v):
    return os.path.join(reg.root, f"v{v:06d}")


def _cycle(dset, reg, tmp_path, name="refit", **kw):
    kw.setdefault("solver_config", SOLVER)
    return refit.run_refit(data_dir=dset, registry=reg,
                           scratch=str(tmp_path / name), chunk=CHUNK,
                           device="cpu", **kw)


def _rows_equal(base_vdir, new_vdir, prefix, rows) -> list:
    """Names of the ``prefix`` columns whose ``rows`` differ."""
    bad = []
    names = sorted(n for n in os.listdir(new_vdir) if n.startswith(prefix))
    assert names, prefix
    for name in names:
        a = np.load(os.path.join(base_vdir, name), mmap_mode="r")
        b = np.load(os.path.join(new_vdir, name), mmap_mode="r")
        if not np.array_equal(np.asarray(a[rows]), np.asarray(b[rows])):
            bad.append(name)
    return bad


# ---------------------------------------------------------------------------
# detect and plan
# ---------------------------------------------------------------------------


def test_detect_is_the_deltas_rows_and_widens_on_a_lost_patch(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    rec = plane.land_synthetic_delta(dset, 0.25)
    os.makedirs(tmp_path / "s")
    plan, resumed = refit.resolve_plan(dset, reg, str(tmp_path / "s"), v1)
    assert not resumed and plan["n_changed"] == rec["n_changed"] == 6
    assert plan["changed_rows"] == plane.advanced_since(dset, 0).tolist()
    assert plan["base_stamp"] == 0 and plan["plan_stamp"] == 1
    # A lost patch widens its touched shards into the plan.
    p = plane._delta_patch_path(dset, 1)
    size = os.path.getsize(p)
    with open(p, "r+b") as fh:
        fh.seek(size // 2)
        fh.write(b"\xff" * 16)
    with pytest.warns(RuntimeWarning, match="widening"):
        wide = refit.draft_plan(dset, 0, base_version=v1)
    assert set(plan["changed_rows"]) <= set(wide["changed_rows"])
    for si in rec["shards"]:
        lo, hi = si * SHARD, min((si + 1) * SHARD, N)
        assert set(range(lo, hi)) <= set(wide["changed_rows"])


def test_refit_plan_crosses_packages(tmp_path):
    """``refit_plan.json`` is one format: each package reads and resumes
    the other's plan, and both name the same cycle dirs."""
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    os.makedirs(s1)
    os.makedirs(s2)
    plan, _ = refit.resolve_plan(dset, reg, s1, v1)
    assert jrefit.read_refit_plan(s1) == plan == refit.read_refit_plan(s1)
    assert jrefit.cycle_paths(s1, plan) == refit.cycle_paths(s1, plan)
    # A JAX-package draft pinned in a scratch dir: the port resumes it.
    jplan = jrefit.pin_drafted(s2, jrefit.draft_plan(dset, 0), v1)
    got, resumed = refit.resolve_plan(dset, reg, s2, v1)
    assert resumed and got == jplan
    # A complete plan is never resumed: a fresh detect is pinned.
    refit._write_refit_plan(s2, dict(jplan, complete=True))
    _, resumed = refit.resolve_plan(dset, reg, s2, v1)
    assert not resumed


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warm_theta_gather_is_the_references(dtype):
    """The reference's rows on a NaN; every row finite float32, also
    where a float64 inf overflows the reference's scrub-then-cast."""
    theta = np.arange(24.0, dtype=dtype).reshape(6, 4)
    theta[2, 1] = np.nan
    idx = np.asarray([2, 4, 0])
    ref = jrefit.warm_theta_gather(theta, idx)
    for th in (theta, torch.from_numpy(theta)):
        got = refit.warm_theta_gather(th, idx)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == np.float32 and got.shape == (3, 4)
        np.testing.assert_array_equal(got, ref)
    theta[4, 0] = np.inf
    for th in (theta, torch.from_numpy(theta)):
        got = np.asarray(refit.warm_theta_gather(th, idx))
        assert np.isfinite(got).all()
        assert got[1, 0] == np.finfo(np.float32).max


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------


def test_warm_refit_publishes_copy_forward_delta(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    res = _cycle(dset, reg, tmp_path, warm_start=True)
    assert res["complete"] and res["warm_start"]
    assert res["n_changed"] == 6 and res["fit_path"] == "resident"
    assert res["fit_dispatches"] >= 1
    v2 = res["version"]
    assert reg.active_version() == v2
    info = reg.delta_info(v2)
    assert info["base_version"] == v1 and info["n_changed"] == 6
    assert reg.version_stamp(v2) == 1
    check = jinv.refit_unchanged_bitwise(_vdir(reg, v1), _vdir(reg, v2),
                                         info["changed_rows"])
    assert check["ok"], check
    t1 = np.load(os.path.join(_vdir(reg, v1), "snapcol_theta.npy"),
                 mmap_mode="r")
    t2 = np.load(os.path.join(_vdir(reg, v2), "snapcol_theta.npy"),
                 mmap_mode="r")
    rows = np.asarray(info["changed_rows"])
    assert not np.array_equal(np.asarray(t1[rows]), np.asarray(t2[rows]))
    assert (os.stat(os.path.join(_vdir(reg, v1), "snapcol_ids.npy")).st_ino
            == os.stat(os.path.join(_vdir(reg, v2),
                                    "snapcol_ids.npy")).st_ino)


def test_cold_refit_bitwise_matches_cold_resident(tmp_path):
    """warm_start=False IS the cold resident path over the compacted
    changed set, bitwise."""
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    res = _cycle(dset, reg, tmp_path, warm_start=False)
    v2 = res["version"]
    rows = np.asarray(reg.delta_info(v2)["changed_rows"], np.int64)
    batch = plane.open_batch(dset)
    ddir = str(tmp_path / "ref_data")
    sub = lambda a: (None if a is None  # noqa: E731
                     else np.ascontiguousarray(a[rows]))
    orchestrate.spill_data(ddir, np.asarray(batch.ds), sub(batch.y),
                           mask=sub(batch.mask),
                           regressors=sub(batch.regressors),
                           cap=sub(batch.cap))
    ref_out = str(tmp_path / "ref_out")
    os.makedirs(ref_out)
    orchestrate.save_run_config(ref_out, CFG, SOLVER)
    st = resident.run_resident(data_dir=ddir, out_dir=ref_out,
                               series=len(rows), chunk=CHUNK,
                               phase1_iters=0, no_phase1_tune=True,
                               device="cpu")
    assert st["complete"]
    ref = orchestrate.load_fit_state(ref_out, len(rows))
    t2 = np.load(os.path.join(_vdir(reg, v2), "snapcol_theta.npy"),
                 mmap_mode="r")
    np.testing.assert_array_equal(np.asarray(t2[rows]),
                                  ref.theta.numpy())


def test_warm_refit_matches_cold_accuracy(tmp_path):
    """Warm-started refits land at the cold fits' quality: in-sample
    sMAPE within 0.05 (median gap) at a converged solver depth."""
    from tsspark_tpu_torch.eval import metrics
    from tsspark_tpu_torch.models.prophet.model import ProphetModel

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    deep = SolverConfig(max_iters=120)

    def smape_of(scratch, warm):
        reg2 = ParamRegistry(reg.root, CFG)
        res = _cycle(dset, reg2, tmp_path, name=scratch,
                     solver_config=deep, warm_start=warm, activate=False)
        rows = np.asarray(reg2.delta_info(res["version"])["changed_rows"],
                          np.int64)
        state, _ = reg2.load(res["version"], fallback=False).take(rows)
        batch = plane.open_batch(dset)
        fc = ProphetModel(CFG, SOLVER, device="cpu").predict(
            state, np.asarray(batch.ds), num_samples=0)
        y = np.nan_to_num(np.ascontiguousarray(batch.y[rows]))
        m = np.ascontiguousarray(batch.mask[rows])
        return np.asarray(metrics.smape(y, fc["yhat"], mask=m))

    s_warm = smape_of("refit_warm", True)
    s_cold = smape_of("refit_cold", False)
    assert float(np.median(np.abs(s_warm - s_cold))) < 0.05


def test_zero_delta_fast_path_hardlinks_everything(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    engine = PredictionEngine(reg, cache=ForecastCache(64), device="cpu")
    before = engine.forecast([str(ids[0]), str(ids[5])], 7)
    res = _cycle(dset, reg, tmp_path)
    assert res["n_changed"] == 0
    assert res["fit_dispatches"] == 0 and res["fit_s"] == 0.0
    v2 = res["version"]
    assert reg.active_version() == v2
    for name in os.listdir(_vdir(reg, v1)):
        if name.startswith("snapcol_"):
            assert (os.stat(os.path.join(_vdir(reg, v1), name)).st_ino
                    == os.stat(os.path.join(_vdir(reg, v2), name)).st_ino)
    after = engine.forecast([str(ids[0]), str(ids[5])], 7)
    assert after.version == v2
    assert np.array_equal(np.asarray(before.ds), np.asarray(after.ds))
    for k in before.values:
        assert np.array_equal(np.asarray(before.values[k]),
                              np.asarray(after.values[k])), k


def test_cache_carries_unchanged_series_across_delta_flip(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    engine = PredictionEngine(reg, cache=ForecastCache(256), device="cpu")
    hot = [str(s) for s in ids[:12]]
    engine.materialize(hot, (7,))
    before = {s: engine.forecast([s], 7) for s in hot}
    plane.land_synthetic_delta(dset, 0.25)
    res = _cycle(dset, reg, tmp_path)
    v2 = res["version"]
    changed_ids = set(reg.delta_info(v2)["changed_ids"])
    assert engine.cache.stats()["carried"] > 0
    dispatches0 = engine.stats.dispatches
    after = {s: engine.forecast([s], 7) for s in hot}
    for s in hot:
        assert after[s].version == v2
        same = all(
            np.array_equal(np.asarray(before[s].values[k]),
                           np.asarray(after[s].values[k]))
            for k in before[s].values
        )
        if s in changed_ids:
            assert not same, f"changed {s} kept its stale forecast"
        else:
            assert same, f"unchanged {s} forecast drifted"
            assert after[s].from_cache == 1
    assert engine.stats.dispatches - dispatches0 <= len(
        [s for s in hot if s in changed_ids])


def test_posterior_and_planes_advance_as_deltas(tmp_path):
    """A base with an ADVI posterior and forecast / quantile planes: the
    cycle refits the changed rows' posteriors (unchanged rows copied
    forward bitwise), and both planes publish as deltas whose unchanged
    rows are the base's bytes."""
    from tsspark_tpu_torch.serve import fplane
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    snap = reg.load(v1, fallback=False)
    theta = np.asarray(snap.state.theta, np.float32)
    advi_mod.save_posterior(
        _vdir(reg, v1),
        advi_mod.AdviPosterior(mu=theta, rho=np.full_like(theta, -3.0),
                               elbo=np.zeros(N, np.float32)),
        seed=7, num_steps=20)
    bk = get_backend("cuda", CFG, SolverConfig(), device="cpu")
    assert fplane.maybe_publish(reg, v1, bk)["status"] == "published"
    assert qplane.maybe_publish(reg, v1, bk)["status"] == "published"
    plane.land_synthetic_delta(dset, 0.25)
    res = _cycle(dset, reg, tmp_path)
    assert res["fplane"] == "published-delta"
    assert res["qplane"] == "published-delta"
    v2 = res["version"]
    rows = np.asarray(reg.delta_info(v2)["changed_rows"], np.int64)
    keep = np.setdiff1d(np.arange(N), rows)
    p1, h1 = advi_mod.load_posterior(_vdir(reg, v1))
    p2, h2 = advi_mod.load_posterior(_vdir(reg, v2))
    assert h2["seed"] == 7 and h2["num_steps"] == 20
    for f in ("mu", "rho", "elbo"):
        np.testing.assert_array_equal(np.asarray(getattr(p2, f))[keep],
                                      np.asarray(getattr(p1, f))[keep])
    assert not np.array_equal(np.asarray(p2.mu)[rows],
                              np.asarray(p1.mu)[rows])
    assert np.isfinite(np.asarray(p2.mu)).all()
    assert _rows_equal(_vdir(reg, v1), _vdir(reg, v2), fplane.FCOL_PREFIX,
                       keep) == []
    assert _rows_equal(_vdir(reg, v1), _vdir(reg, v2), qplane.QCOL_PREFIX,
                       keep) == []
    assert refit.posterior_seed(7, 2) != refit.posterior_seed(7, 3)


def _direct_advance(scratch, plan, seed, version, num_steps):
    """The changed rows' posterior as ``fit_advi`` gives it directly: the
    cycle's own fit of its spill (``state_sub``), that spill's data, a
    generator at ``posterior_seed(seed, version)``."""
    from tsspark_tpu_torch.config import AdviConfig
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    _c, ddir, out = refit.cycle_paths(scratch, plan)
    state_sub = orchestrate.load_fit_state(out, plan["n_changed"])
    data, _ = prepare_fit_data(np.load(os.path.join(ddir, "ds.npy")),
                               np.load(os.path.join(ddir, "y.npy")), CFG,
                               mask=np.load(os.path.join(ddir, "mask.npy")))
    gen = torch.Generator().manual_seed(refit.posterior_seed(seed, version))
    return advi_mod.fit_advi(np.asarray(state_sub.theta, np.float32), data,
                             gen, CFG, AdviConfig(num_steps=num_steps),
                             device="cpu")


def _base_posterior(reg, v1, num_steps):
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    theta = np.asarray(reg.load(v1, fallback=False).state.theta, np.float32)
    advi_mod.save_posterior(
        _vdir(reg, v1),
        advi_mod.AdviPosterior(mu=theta, rho=np.full_like(theta, -3.0),
                               elbo=np.zeros(N, np.float32)),
        seed=7, num_steps=num_steps)


def test_posterior_advance_is_the_direct_fit_of_the_cycles_rows(
        tmp_path, monkeypatch):
    """The advanced rows are bitwise ``fit_advi`` on THIS cycle's theta
    of those rows (not the base's), over the spill rows of the same
    series, at the generator ``posterior_seed(seed, new version)``: a
    wrong row map, theta or seed changes the bits."""
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    monkeypatch.setattr(refit, "reap_cycles", lambda *a, **k: None)
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    _base_posterior(reg, v1, 20)
    plane.land_synthetic_delta(dset, 0.25)
    res = _cycle(dset, reg, tmp_path)
    v2 = res["version"]
    plan = refit.read_refit_plan(str(tmp_path / "refit"))
    rows = np.asarray(plan["changed_rows"], np.int64)
    assert rows.tolist() == reg.delta_info(v2)["changed_rows"]
    want = _direct_advance(str(tmp_path / "refit"), plan, 7, v2, 20)
    got, _ = advi_mod.load_posterior(_vdir(reg, v2))
    for f in ("mu", "rho", "elbo"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[rows],
                                      getattr(want, f).numpy(), err_msg=f)
    # A wrong seed, or a wrong row map, gives other bits.
    wrong_seed = _direct_advance(str(tmp_path / "refit"), plan, 7, v1, 20)
    assert not np.array_equal(np.asarray(got.mu)[rows],
                              wrong_seed.mu.numpy())
    assert not np.array_equal(np.asarray(got.mu)[rows],
                              np.asarray(got.mu)[rows[::-1]])


# The advanced posterior against the JAX package's, in distribution (the
# packages draw from different generators): ``tests/test_torch_advi.py``'s
# statistics and limits, the median over (row, parameter) of |d mu| /
# sd_ref and the largest over rows of |mean d rho|, at its 200 steps
# (read here: 0.284 and 0.108).
ADVI_STEPS = 200
DIST_LIMITS = {"dmu_sd_median": 0.6, "drho_series_mean": 0.4}


def test_refit_cycle_against_the_jax_packages_cycle(tmp_path):
    """One warm cycle in each package on copies of the same plane (the
    same delta landed) and registry (the same v1 and ADVI posterior),
    each on its 8-entry mesh: the same changed rows; the refit rows'
    loss and theta at rtol 1e-3, atol 1e-2 (the port's
    worker-against-worker tolerance), the same converged rows, a stop
    reason differing only among FTOL / FLOOR / STALLED; the unchanged
    rows and their posterior the base's bytes in both; the advanced
    posterior in distribution.

    The cycle runs at the converged depth of
    ``test_warm_refit_matches_cold_accuracy`` (120 iterations; read: loss
    within 2.4e-3 nats, theta within 6.1e-3).  At 20 every row stops at
    the iteration cap and the two float32 solvers' unconverged iterates
    part by up to 0.65 nats (0.33%; 0.35 at 40)."""
    import shutil

    from tsspark_tpu import config as jcfg
    from tsspark_tpu.serve.registry import ParamRegistry as JRegistry
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    _base_posterior(reg, v1, ADVI_STEPS)
    plane.land_synthetic_delta(dset, 0.25)
    jdset = str(tmp_path / "jplane")
    jroot = str(tmp_path / "jregistry")
    shutil.copytree(dset, jdset)
    shutil.copytree(reg.root, jroot)
    deep = 120
    res = _cycle(dset, reg, tmp_path,
                 solver_config=SolverConfig(max_iters=deep))
    jcf = jcfg.ProphetConfig(
        seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3)
    jres_ = jrefit.run_refit(
        data_dir=jdset, registry=JRegistry(jroot, jcf),
        scratch=str(tmp_path / "jrefit"), chunk=CHUNK,
        solver_config=jcfg.SolverConfig(max_iters=deep))
    assert res["complete"] and jres_["complete"]
    assert res["fit_path"] == "resident"
    assert res["version"] == jres_["version"] == 2
    jreg = ParamRegistry(jroot, CFG)  # the port reads either registry
    rows = np.asarray(reg.delta_info(2)["changed_rows"], np.int64)
    assert rows.tolist() == jreg.delta_info(2)["changed_rows"]
    got, _ = reg.load(2, fallback=False).take(rows)
    ref, _ = jreg.load(2, fallback=False).take(rows)
    for k in ("loss", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(ref, k)),
                                   rtol=1e-3, atol=1e-2, err_msg=k)
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    st, jst = np.asarray(got.status), np.asarray(ref.status)
    np.testing.assert_array_equal(st == 0, jst == 0)
    assert np.isin(st[st != jst], (2, 3, 4)).all()
    for k in ("y_scale", "ds_start", "ds_span", "changepoints"):
        np.testing.assert_array_equal(np.asarray(getattr(got.meta, k)),
                                      np.asarray(getattr(ref.meta, k)))
    keep = np.setdiff1d(np.arange(N), rows)
    for r in (reg, jreg):
        check = jinv.refit_unchanged_bitwise(_vdir(r, 1), _vdir(r, 2), rows)
        assert check["ok"], check
    p1, _ = advi_mod.load_posterior(_vdir(reg, 1))
    p2, h2 = advi_mod.load_posterior(_vdir(reg, 2))
    j2, jh2 = advi_mod.load_posterior(_vdir(jreg, 2))
    assert h2 == jh2
    for f in ("mu", "rho", "elbo"):
        for post in (p2, j2):
            np.testing.assert_array_equal(np.asarray(getattr(post, f))[keep],
                                          np.asarray(getattr(p1, f))[keep])
    mu, rho = np.asarray(p2.mu)[rows], np.asarray(p2.rho)[rows]
    ref_mu, ref_rho = np.asarray(j2.mu)[rows], np.asarray(j2.rho)[rows]
    assert np.isfinite(mu).all() and np.isfinite(rho).all()
    dmu = float(np.median(np.abs(mu - ref_mu) / np.exp(ref_rho)))
    drho = float(np.abs((rho - ref_rho).mean(-1)).max())
    assert (dmu <= DIST_LIMITS["dmu_sd_median"]
            and drho <= DIST_LIMITS["drho_series_mean"]), (dmu, drho)


def test_pool_flip_serves_delta_version_bitwise(tmp_path, monkeypatch):
    from tsspark_tpu_torch.serve.pool import ReplicaPool

    monkeypatch.delenv("TSSPARK_SNAPSHOT_FORMAT", raising=False)
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    pool = ReplicaPool(str(tmp_path / "pool"), reg.root, n_replicas=1,
                       device="cpu")
    pool.start()
    try:
        plane.land_synthetic_delta(dset, 0.25)
        changed_pre = set(plane.advanced_since(dset, 0).tolist())
        probe = next(str(ids[i]) for i in range(N) if i not in changed_pre)
        r1 = pool.forecast([probe], 7)
        assert r1.get("ok") and r1["version"] == v1
        res = _cycle(dset, reg, tmp_path, pool=pool,
                     hot_series=[str(s) for s in ids[:6]], horizons=(7,))
        v2 = res["version"]
        assert pool.expected_version == v2
        r2 = pool.forecast([probe], 7)
        assert r2.get("ok") and r2["version"] == v2
        assert r1["yhat"] == r2["yhat"]
        assert pool.wrong_version == 0
    finally:
        pool.stop()


def test_refit_resumes_after_delta_publish_kill(tmp_path):
    """The CLI child (``--device cpu``) dies at an armed
    ``delta_publish`` point mid copy-forward; the active version is
    untouched, and the in-process successor resumes with ZERO fit
    dispatches (the waves landed) and lands the same bits."""
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    scratch = str(tmp_path / "refit")
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("delta_publish", attempts=1, after=2, mode="exit",
              rc=23, tag="refit-kill")
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env[faults.ENV_VAR] = plan.to_env()
    env.pop(tmesh.HOST_MESH_ENV, None)  # the CLI forces it for --device cpu
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.refit",
         "--data", dset, "--registry", reg.root, "--scratch", scratch,
         "--chunk", str(CHUNK), "--max-iters", str(SOLVER.max_iters),
         "--no-activate", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 23, proc.stderr[-2000:]
    assert reg.active_version() == v1
    plan_rec = refit.read_refit_plan(scratch)
    assert plan_rec is not None and not plan_rec.get("complete")
    _c, _d, out_dir = refit.cycle_paths(scratch, plan_rec)
    landed = orchestrate.load_fit_state(out_dir, plan_rec["n_changed"])
    with open(os.path.join(out_dir, resident.RESIDENT_STATE_FILE)) as fh:
        assert json.load(fh)["mesh"] == [8, 1]
    res = _cycle(dset, reg, tmp_path, name="refit")
    assert res["resumed"] and res["complete"]
    assert res["fit_dispatches"] == 0
    v2 = res["version"]
    info = reg.delta_info(v2)
    check = jinv.refit_unchanged_bitwise(_vdir(reg, v1), _vdir(reg, v2),
                                         info["changed_rows"])
    assert check["ok"], check
    t2 = np.load(os.path.join(_vdir(reg, v2), "snapcol_theta.npy"),
                 mmap_mode="r")
    np.testing.assert_array_equal(
        np.asarray(t2[np.asarray(info["changed_rows"])]),
        landed.theta.numpy())


def test_delta_bench_cli_writes_its_reports(tmp_path):
    """``python -m tsspark_tpu_torch.refit --delta-bench smoke --device
    cpu``: the churn sweep on the CPU's host mesh, exit 0 (``sweep_ok``),
    one ``BENCH_delta_*`` report a churn in the working directory, naming
    the CPU; the scratch under the child's temporary directory."""
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env["TMPDIR"] = str(tmp_path / "tmp")
    env["TSSPARK_SENTINEL"] = "0"
    os.makedirs(env["TMPDIR"])
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.refit", "--delta-bench",
         "smoke", "--churns", "0.1", "--device", "cpu"],
        cwd=str(cwd), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    reports = sorted(os.listdir(cwd))
    assert len(reports) == 1 and reports[0].startswith(
        "BENCH_delta_smoke_c0100_")
    with open(cwd / reports[0]) as fh:
        rep = json.load(fh)
    assert rep["extra"]["complete"] and rep["extra"]["device"] == "cpu"
    assert rep["extra"]["fit_path"] == "resident"
    assert refit.sweep_ok([rep])
