"""The port's device mesh and sharded fit (``tsspark_tpu_torch.parallel.
{mesh,sharding}``, ``CudaBackend(mesh=)``, ``utils.{platform,profiling}``)
against the JAX package's, on the CPU.

The JAX package runs on the 8-device virtual CPU mesh ``tests/conftest.py``
forces; the port's meshes are grids of CPU entries, whose shards run one
after another on the one CPU.  Series-axis sharding is held bitwise to the
port's meshless fit; time-axis sharding adds each block's partial sums in
another float32 order and is held at tolerance.
"""

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.parallel import mesh as jmesh
from tsspark_tpu.parallel import sharding as jshard
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet.loss import (
    fan_value_closed_form,
    value_and_grad_batch,
)
from tsspark_tpu_torch.parallel import mesh as tmesh
from tsspark_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _cfg(mod):
    return mod.ProphetConfig(
        seasonalities=(mod.SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=4,
    )


def _cfg_reg(mod):
    return mod.ProphetConfig(
        seasonalities=(mod.SeasonalityConfig("weekly", 7.0, 3),),
        regressors=(mod.RegressorConfig("holiday", standardize=False),
                    mod.RegressorConfig("price"),
                    mod.RegressorConfig("promo", standardize=False)),
        n_changepoints=5,
    )


@pytest.fixture(scope="module")
def batch():
    return datasets.m5_like(n_series=22, n_days=120, seed=3)


def _packed(mod_design, mod_cfg, batch, regressors=True):
    cfg = _cfg_reg(mod_cfg) if regressors else _cfg(mod_cfg)
    ds = np.asarray(batch.ds)
    reg = batch.regressors if regressors else None
    if mod_design is tdesign:
        data, meta = tdesign.prepare_fit_data(ds, batch.y, cfg,
                                              mask=batch.mask,
                                              regressors=reg)
    else:
        data, meta = jdesign.prepare_fit_data(ds, batch.y, cfg,
                                              mask=batch.mask,
                                              regressors=reg,
                                              as_numpy=True)
    packed, u8 = mod_design.pack_fit_data(data, meta, ds,
                                          collapse_cap=True)
    return cfg, data, packed, u8


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns,nt,n", [(None, 1, 8), (4, 2, 8), (None, 2, 8),
                                     (2, 2, 4), (3, 3, 8), (None, 3, 8),
                                     (8, 2, 8)])
def test_make_mesh_matches_the_reference(ns, nt, n):
    """Same grid shape and axis names, or the same ValueError."""
    jdevs = jax.devices()[:n]
    tdevs = [CPU] * n
    try:
        jm = jmesh.make_mesh(ns, nt, devices=jdevs)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.make_mesh(ns, nt, devices=tdevs)
        return
    tm = tmesh.make_mesh(ns, nt, devices=tdevs)
    assert tm.axis_names == tuple(jm.axis_names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape
    assert tm.size == n


def test_make_mesh_names_axes_from_the_config():
    sc = dict(series_axis="rows", time_axis="steps")
    tm = tmesh.make_mesh(2, 2, devices=[CPU] * 4,
                         config=tcfg.ShardingConfig(**sc))
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4],
                         config=jcfg.ShardingConfig(**sc))
    assert tm.axis_names == tuple(jm.axis_names) == ("rows", "steps")


def test_default_devices_host_mesh_and_card(monkeypatch):
    """Forced host mesh: n CPU entries (an existing setting wins);
    otherwise the CUDA devices, none on a machine without a card."""
    monkeypatch.setenv(tmesh.HOST_MESH_ENV, "1")  # restored at teardown
    monkeypatch.delenv(tmesh.HOST_MESH_ENV)
    if not torch.cuda.is_available():
        assert tmesh.default_devices() == []
    tmesh.force_virtual_host_mesh(8)
    assert tmesh.default_devices() == [CPU] * 8
    tmesh.force_virtual_host_mesh(2)
    assert len(tmesh.default_devices()) == 8
    m = tmesh.make_mesh()
    assert dict(m.shape) == {"series": 8, "time": 1}


# ---------------------------------------------------------------------------
# partition specs, rules, padding, shard/gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_series", [False, True])
def test_resident_partition_rules_match_the_reference(batch, per_series):
    """The same rules give every field of the same packed tree the same
    spec in both packages."""
    _, _, tp, _ = _packed(tdesign, tcfg, batch)
    _, _, jp, _ = _packed(jdesign, jcfg, batch)
    if per_series:
        xs = np.zeros((22, 120, 6), np.float32)
        tp, jp = tp._replace(X_season=xs), jp._replace(X_season=xs)
    t_specs = tshard.match_partition_rules(
        tshard.resident_partition_rules("series", per_series), tp)
    j_specs = jshard.match_partition_rules(
        jshard.resident_partition_rules("series", per_series), jp)
    assert t_specs._fields == j_specs._fields
    for f in t_specs._fields:
        assert tuple(getattr(t_specs, f)) == tuple(getattr(j_specs, f)), f


def test_match_partition_rules_raises_on_an_unmatched_field(batch):
    _, _, tp, _ = _packed(tdesign, tcfg, batch)
    with pytest.raises(ValueError, match="no partition rule"):
        tshard.match_partition_rules((("^y$", tshard.P("series")),), tp)


@pytest.mark.parametrize("time_axis", [None, "time"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_data_and_packed_shardings_match_the_reference(batch, time_axis,
                                                       shape):
    _, jd, jp, _ = _packed(jdesign, jcfg, batch)
    _, td, tp, _ = _packed(tdesign, tcfg, batch)
    n = shape[0] * shape[1]
    jm = jmesh.make_mesh(*shape, devices=jax.devices()[:n])
    tm = tmesh.make_mesh(*shape, devices=[CPU] * n)
    jsc = jcfg.ShardingConfig(time_axis=time_axis)
    tsc = tcfg.ShardingConfig(time_axis=time_axis)
    for t_specs, j_specs in (
            (tshard.data_shardings(tm, td, tsc),
             jshard.data_shardings(jm, jd, jsc)),
            (tshard.packed_shardings(tm, tp, tsc),
             jshard.packed_shardings(jm, jp, jsc))):
        for f in t_specs._fields:
            assert tuple(getattr(t_specs, f)) == \
                tuple(getattr(j_specs, f)), f


def test_pad_packed_rows_is_the_references(batch):
    _, _, tp, _ = _packed(tdesign, tcfg, batch)
    _, _, jp, _ = _packed(jdesign, jcfg, batch)
    tpad = tshard.pad_packed_rows(tp, 3)
    jpad = jshard.pad_packed_rows(jp, 3)
    assert tshard.pad_packed_rows(tp, 0) is tp
    for f in tpad._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tpad, f)),
                                      np.asarray(getattr(jpad, f)),
                                      err_msg=f)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (4, 2)])
def test_shard_and_gather_round_trip(batch, shape):
    """Each mesh entry holds exactly its block; gathering gives back the
    host bytes."""
    _, _, tp, _ = _packed(tdesign, tcfg, batch)
    tp = tshard.pad_packed_rows(tp, (-22) % shape[0])
    n = shape[0] * shape[1]
    m = tmesh.make_mesh(*shape, devices=[CPU] * n)
    specs = tshard.packed_shardings(m, tp, tcfg.ShardingConfig())
    shard, gather = tshard.make_shard_and_gather_fns(m, specs)
    placed = tshard.apply_fns(shard, tp)
    back = tshard.apply_fns(gather, placed)
    for f in tp._fields:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(tp, f)),
                                      err_msg=f)
    y = placed.y
    b_pad, t_len = np.shape(tp.y)
    assert tuple(y.blocks[0][0].shape) == (b_pad // shape[0],
                                           t_len // shape[1])


def test_compacted_width_takes_the_shard_multiple():
    for n, m in ((5, 1), (5, 3), (100, 8), (1, 6), (33, 4)):
        assert tshard.compacted_width(n, multiple=m) == \
            jshard.compacted_width(n, multiple=m)


# ---------------------------------------------------------------------------
# the time split's partial sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [2, 3])
def test_time_blocks_partial_sums_add_to_the_whole(batch, n_blocks):
    """K3's and K4's plain versions on each time block, the priors on the
    first only (every scale +inf elsewhere): the sums are the whole
    problem's value, gradient and fan at float32 tolerance."""
    cfg, data, _, _ = _packed(tdesign, tcfg, batch)
    full = tdesign.fitdata_to_device(data, CPU)
    m = tmesh.make_mesh(1, n_blocks, devices=[CPU] * n_blocks)
    blocks = tshard._time_blocks(full, m, tcfg.ShardingConfig())[0]
    bare = tshard._priorless(cfg)
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(
        rng.normal(0, 0.1, (22, cfg.num_params)).astype(np.float32))
    d = torch.from_numpy(
        rng.normal(0, 0.05, (22, cfg.num_params)).astype(np.float32))
    ladder = torch.from_numpy(
        np.tile(np.float32([1.0, 0.5, 0.25])[:, None], (1, 22)))
    f_full, g_full = value_and_grad_batch(theta, full, cfg)
    fan_full = fan_value_closed_form(theta, d, ladder, full, cfg)
    f = g = fan = 0
    for j, b in enumerate(blocks):
        c = cfg if j == 0 else bare
        if j:
            b = b._replace(prior_scales=torch.full_like(b.prior_scales,
                                                        math.inf))
        fb, gb = value_and_grad_batch(theta, b, c)
        f, g = f + fb, g + gb
        fan = fan + fan_value_closed_form(theta, d, ladder, b, c)
    np.testing.assert_allclose(f.numpy(), f_full.numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), g_full.numpy(), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(fan.numpy(), fan_full.numpy(), rtol=1e-5,
                               atol=1e-3)


def test_priorless_config_zeroes_every_prior(batch):
    """A block with every prior scale at +inf carries the likelihood
    alone: at a point with no observation the loss is exactly 0."""
    cfg, data, _, _ = _packed(tdesign, tcfg, batch)
    full = tdesign.fitdata_to_device(data, CPU)
    empty = full._replace(mask=torch.zeros_like(full.mask),
                          prior_scales=torch.full_like(full.prior_scales,
                                                       math.inf))
    theta = torch.full((22, cfg.num_params), 0.3)
    f, g = value_and_grad_batch(theta, empty, tshard._priorless(cfg))
    assert torch.equal(f, torch.zeros_like(f))
    assert torch.equal(g, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# the sharded fits against the JAX package's and the port's meshless fit
# ---------------------------------------------------------------------------

SOLVER_ITERS = 80


@pytest.fixture(scope="module")
def jax_sharded(batch):
    """The JAX package's fit_sharded / fit_sharded_packed on 4x1 and 2x2
    meshes of its virtual devices (ridge init inside the program)."""
    cfg, jd, jp, u8 = _packed(jdesign, jcfg, batch, regressors=False)
    solver = jcfg.SolverConfig(max_iters=SOLVER_ITERS)
    out = {}
    for shape in ((4, 1), (2, 2)):
        m = jmesh.make_mesh(*shape, devices=jax.devices()[:4])
        sc = jcfg.ShardingConfig(time_axis="time")
        out[("plain", shape)] = jshard.fit_sharded(
            jax.tree.map(jax.numpy.asarray, jd), None, cfg, solver, m, sc)
        out[("packed", shape)] = jshard.fit_sharded_packed(
            jp, u8, None, cfg, solver, m, sc)
    return out


@pytest.mark.parametrize("kind", ["plain", "packed"])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_fit_sharded_against_the_reference(batch, jax_sharded, kind,
                                           shape):
    """The port's sharded fit against the JAX package's on the same mesh
    shape: losses at rtol 1e-3, atol 1e-2 (two float32 lockstep solvers
    stop at the noise floor at different points); converged rows agree
    but for a few at the noise floor."""
    cfg, td, tp, u8 = _packed(tdesign, tcfg, batch, regressors=False)
    solver = tcfg.SolverConfig(max_iters=SOLVER_ITERS)
    m = tmesh.make_mesh(*shape, devices=[CPU] * 4)
    sc = tcfg.ShardingConfig(time_axis="time")
    if kind == "plain":
        got = tshard.fit_sharded(td, None, cfg, solver, m, sc)
    else:
        got = tshard.fit_sharded_packed(tp, u8, None, cfg, solver, m, sc)
    ref = jax_sharded[(kind, shape)]
    assert tuple(got.theta.shape) == (22, cfg.num_params)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f),
                               rtol=1e-3, atol=1e-2)
    assert (got.converged.numpy() != np.asarray(ref.converged)).sum() <= 2


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (8, 1)])
def test_series_sharded_packed_fit_is_the_meshless_fit_bitwise(batch,
                                                               shape):
    """On a series-only mesh each shard runs fit_core_packed over its
    rows; on the CPU a row's fit is the same bits at any width, so the
    result is the one-device fit's, padding rows sliced away."""
    from tsspark_tpu_torch.models.prophet.model import fit_core_packed

    cfg, _, tp, u8 = _packed(tdesign, tcfg, batch)
    solver = tcfg.SolverConfig(max_iters=SOLVER_ITERS)
    th, st = fit_core_packed(tdesign.packed_to_device(tp, CPU), None, cfg,
                             solver, reg_u8_cols=u8)
    m = tmesh.make_mesh(*shape, devices=[CPU] * shape[0])
    got = tshard.fit_sharded_packed(tp, u8, None, cfg, solver, m)
    assert torch.equal(got.theta, th)
    assert torch.equal(got.f, st[0])


def test_fit_resident_core_is_fit_core_packed_per_shard(batch):
    """The resident program on a 2-entry mesh, with and without a warm
    start (use_theta0_dynamic), against fit_core_packed over each half;
    the gathered results are host numpy."""
    from tsspark_tpu_torch.models.prophet.model import fit_core_packed

    cfg, _, tp, u8 = _packed(tdesign, tcfg, batch)
    tp = tshard.pad_packed_rows(tp, 2)
    solver = tcfg.SolverConfig(max_iters=SOLVER_ITERS)
    m = tmesh.make_mesh(2, 1, devices=[CPU] * 2)
    specs = tshard.match_partition_rules(
        tshard.resident_partition_rules("series", False), tp)
    shard = tshard.make_shard_and_gather_fns(m, specs)[0]
    warm = np.random.default_rng(1).normal(
        0, 0.1, (24, cfg.num_params)).astype(np.float32)
    for use in (False, True):
        th0 = tshard.shard_array(m, tshard.P("series", None), warm.copy())
        th, st = tshard.fit_resident_core(
            tshard.apply_fns(shard, tp), th0, cfg, solver,
            reg_u8_cols=u8, max_iters_dynamic=40, gn_precond_dynamic=False,
            use_theta0_dynamic=use)
        th, st = np.asarray(th), np.asarray(st)
        sub = dataclasses.replace(solver, max_iters=40, precond="none")
        for lo in (0, 12):
            shared = ("ds_rel", "prior_scales", "mult_mask", "X_season")
            half = type(tp)(**{
                f: (getattr(tp, f) if f in shared
                    else np.asarray(getattr(tp, f))[lo:lo + 12])
                for f in tp._fields})
            rth, rst = fit_core_packed(
                tdesign.packed_to_device(half, CPU),
                torch.from_numpy(warm[lo:lo + 12]) if use else None,
                cfg, sub, reg_u8_cols=u8)
            np.testing.assert_array_equal(th[lo:lo + 12], rth.numpy())
            np.testing.assert_array_equal(st[:, lo:lo + 12], rst.numpy())


# ---------------------------------------------------------------------------
# CudaBackend(mesh=)
# ---------------------------------------------------------------------------

def _fit(batch, **kw):
    cfg = _cfg(tcfg)
    solver = tcfg.SolverConfig(max_iters=SOLVER_ITERS)
    return get_backend("cuda", cfg, solver, device="cpu", **kw).fit(
        np.asarray(batch.ds), batch.y, mask=batch.mask)


def test_backend_mesh_route_on_two_entries_is_the_meshless_fit(batch):
    """A 2-entry series mesh: every chunk (and the rescue pass) through
    fit_sharded_packed, bitwise the meshless fit."""
    plain = _fit(batch)
    m = tmesh.make_mesh(2, 1, devices=[CPU] * 2)
    got = _fit(batch, mesh=m)
    assert torch.equal(got.theta, plain.theta)
    for f in ("loss", "grad_norm", "converged", "n_iters", "status"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f),
                                      err_msg=f)
    for a, b in zip(got.meta, plain.meta):
        np.testing.assert_array_equal(a, b)


def test_backend_time_mesh_against_the_meshless_fit(batch):
    """A 2x2 (series x time) mesh: losses within the reference's
    mesh-routing bound (rtol 2e-3, atol 2e-3 of tests/test_sharding.py)
    of the meshless fit; the forecast path is unchanged."""
    plain = _fit(batch)
    m = tmesh.make_mesh(2, 2, devices=[CPU] * 4)
    got = _fit(batch, mesh=m)
    np.testing.assert_allclose(got.loss, plain.loss, rtol=2e-3, atol=2e-3)
    assert np.isfinite(np.asarray(got.theta)).all()


def test_backend_mesh_conditions():
    """The reference's conditions: iter_segment refuses, resilient=True
    counts the mesh as ineligible, the compacted-width multiple reads the
    series axis (named by position, "series" or the config)."""
    from tsspark_tpu_torch.backends import cuda

    cfg = _cfg(tcfg)
    m = tmesh.make_mesh(4, 2, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="iter_segment"):
        get_backend("cuda", cfg, device="cpu", mesh=m, iter_segment=4)
    bk = get_backend("cuda", cfg, device="cpu", mesh=m)
    assert bk._compact_multiple() == 4
    assert get_backend("cuda", cfg, device="cpu")._compact_multiple() == 1
    assert "the backend is mesh-sharded (mesh=)" in \
        cuda._resilient_ineligibility(None, None, True, m)
    assert cuda._resilient_ineligibility(None, None, True) == []
    swapped = tmesh.Mesh(m.devices.T, ("time", "rows"))
    assert cuda._mesh_series_axis(swapped) == "rows"
    assert cuda._mesh_series_axis(m) == "series"
    assert cuda._mesh_series_axis(
        m, tcfg.ShardingConfig(series_axis="time")) == "time"


# ---------------------------------------------------------------------------
# utils.platform and utils.profiling
# ---------------------------------------------------------------------------

def test_platform_helpers(monkeypatch):
    from tsspark_tpu.utils import platform as jplat
    from tsspark_tpu_torch import orchestrate
    from tsspark_tpu_torch.utils import platform

    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")
    assert platform.honor_env_platforms() == CPU
    monkeypatch.delenv(platform.DEVICE_ENV)
    assert platform.honor_env_platforms("cpu") == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.honor_env_platforms()
    assert platform.host_cpu_tag() == jplat.host_cpu_tag()
    # A worker given no --device takes the environment's; --device wins.
    seen = []
    monkeypatch.setattr(orchestrate, "fit_worker",
                        lambda a: seen.append(a.device) or 0)
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")
    argv = ["--_fit", "--data", "d", "--out", "o"]
    assert orchestrate._worker_main(list(argv)) == 0
    assert orchestrate._worker_main(argv + ["--device", "cuda"]) == 0
    assert seen == ["cpu", "cuda"]


def test_profiling_trace_annotate_and_timers(tmp_path):
    from tsspark_tpu_torch.utils import profiling

    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tsspark.block"):
            torch.ones(64).sum()
    path = tmp_path / f"trace_{os.getpid()}.json"
    assert path.exists()
    assert "tsspark.block" in json.dumps(json.loads(path.read_text()))
    t = profiling.Timers()
    for _ in range(3):
        with t.section("a"):
            pass
    s = t.summary()
    assert s["a"]["count"] == 3 and s["a"]["total_s"] >= 0.0
