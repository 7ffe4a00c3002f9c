"""The port's mesh-resident fit (``tsspark_tpu_torch.resident``) on the CPU:
against the port's own file protocol (bitwise, the contract its docstring
states) and against the JAX package's resident run (at tolerance).

Sizes are the reference tests' (``tests/test_resident.py``):
``m5_like(96, 128)``, 32-row waves, 6 phase-1 iterations, a virtual host
mesh of 8 CPU entries (the JAX package's 8 virtual devices).
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu import orchestrate as jorch
from tsspark_tpu import resident as jres
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch import orchestrate, resident
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SERIES, DAYS, CHUNK, PHASE1 = 96, 128, 32, 6
STATE_FIELDS = ("theta", "loss", "grad_norm", "converged", "n_iters",
                "status")


def _model_config(mod):
    return mod.ProphetConfig(
        seasonalities=(
            mod.SeasonalityConfig("yearly", 365.25, 8),
            mod.SeasonalityConfig("weekly", 7.0, 3),
        ),
        regressors=(
            mod.RegressorConfig("holiday", prior_scale=10.0,
                                standardize=False),
            mod.RegressorConfig("price"),
            mod.RegressorConfig("promo", standardize=False),
        ),
        n_changepoints=25,
    )


def _setup(tmp_path, name, mod=tcfg, save=orchestrate.save_run_config):
    """A spill dir of ``m5_like(96, 128)`` and an out dir holding
    ``mod``'s run config."""
    batch = datasets.m5_like(n_series=SERIES, n_days=DAYS)
    dd = tmp_path / name / "data"
    od = tmp_path / name / "out"
    dd.mkdir(parents=True)
    od.mkdir(parents=True)
    np.save(dd / "ds.npy", batch.ds.astype(np.float32))
    np.save(dd / "y.npy", np.nan_to_num(batch.y).astype(np.float32))
    np.save(dd / "mask.npy", batch.mask.astype(np.float32))
    np.save(dd / "reg.npy", batch.regressors.astype(np.float32))
    save(str(od), _model_config(mod), mod.SolverConfig(max_iters=120))
    return str(dd), str(od)


def _same(a, b):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for x, y, f in zip(a.meta, b.meta, a.meta._fields):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"meta.{f}")


@pytest.fixture(scope="module")
def fileproto(tmp_path_factory):
    """The port's file protocol: one chunk worker over the same data."""
    tmp = tmp_path_factory.mktemp("fileproto")
    dd, od = _setup(tmp, "fp")
    args = argparse.Namespace(
        data=dd, out=od, lo=0, hi=SERIES, chunk=CHUNK, segment=0,
        series=SERIES, phase1_iters=PHASE1, no_phase1_tune=True,
        max_ahead=6, autotune=False, device="cpu",
    )
    assert orchestrate.fit_worker(args) == 0
    return orchestrate.load_fit_state(od, SERIES)


def _mesh(n):
    return tmesh.make_mesh(n, 1, devices=[CPU] * n)


def _times(od):
    with open(os.path.join(od, "times.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("n", [1, 8])
def test_resident_is_the_file_protocol_bitwise(tmp_path, fileproto, n,
                                               depth):
    """N = 1 and N = 8 CPU entries, serialized and pipelined: the
    assembled FitState (solver outputs and scaling meta) is the file
    protocol's bits, through the same chunk files, with the flush-state
    artifact and the times rows proving the resident path ran."""
    dd, od = _setup(tmp_path, "res")
    out = resident.run_resident(
        data_dir=dd, out_dir=od, series=SERIES, chunk=CHUNK,
        phase1_iters=PHASE1, no_phase1_tune=True, mesh=_mesh(n),
        pipeline_depth=depth,
    )
    assert out["complete"] and out["fit_path"] == "resident"
    _same(orchestrate.load_fit_state(od, SERIES), fileproto)
    assert sorted(os.path.basename(p) for p in
                  glob.glob(od + "/chunk_*.npz")) == [
        "chunk_000000_000032.npz", "chunk_000032_000064.npz",
        "chunk_000064_000096.npz"]
    with open(os.path.join(od, resident.RESIDENT_STATE_FILE)) as fh:
        st = json.load(fh)
    assert st["path"] == "resident" and st["mesh"] == [n, 1]
    assert st["landed"] == SERIES and st["wave"] == 3
    rows = _times(od)
    waves = [r for r in rows if r.get("path") == "resident"]
    assert len(waves) == 3 and all(r["shards"] == n for r in waves)
    assert any(r.get("phase2_mode") == "resident-sharded" for r in rows)


def test_a_row_has_the_same_bits_at_any_width_on_the_cpu():
    """The measurement behind the N > 1 contract: fit_core_packed over 32
    rows and over each 4-row slice of them give every row the same bits
    on the CPU (cold ridge init and warm start both)."""
    from tsspark_tpu_torch.models.prophet.design import (
        pack_fit_data, packed_to_device, prepare_fit_data)
    from tsspark_tpu_torch.models.prophet.model import fit_core_packed

    batch = datasets.m5_like(n_series=32, n_days=DAYS)
    cfg = _model_config(tcfg)
    solver = tcfg.SolverConfig(max_iters=40, precond="none")
    ds = np.asarray(batch.ds)
    data, meta = prepare_fit_data(ds, batch.y, cfg, mask=batch.mask,
                                  regressors=batch.regressors)
    packed, u8 = pack_fit_data(data, meta, ds, collapse_cap=True)
    shared = ("ds_rel", "prior_scales", "mult_mask", "X_season")
    warm = np.random.default_rng(0).normal(
        0, 0.05, (32, cfg.num_params)).astype(np.float32)
    for init in (None, warm):
        th, st = fit_core_packed(
            packed_to_device(packed, CPU),
            None if init is None else torch.from_numpy(init), cfg, solver,
            reg_u8_cols=u8)
        for lo in range(0, 32, 4):
            part = type(packed)(**{
                f: (getattr(packed, f) if f in shared
                    else np.asarray(getattr(packed, f))[lo:lo + 4])
                for f in packed._fields})
            th_k, st_k = fit_core_packed(
                packed_to_device(part, CPU),
                None if init is None else torch.from_numpy(init[lo:lo + 4]),
                cfg, solver, reg_u8_cols=u8)
            assert torch.equal(th_k, th[lo:lo + 4])
            assert torch.equal(st_k, st[:, lo:lo + 4])


def test_crash_resume_through_the_resident_worker(tmp_path, fileproto):
    """``python -m tsspark_tpu_torch.orchestrate --_resident --device cpu``
    on the forced host mesh, killed after two flushes (rc 17), then
    resumed in process: coverage exactly once and the file protocol's
    bits."""
    dd, od = _setup(tmp_path, "crash")
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env["TSSPARK_TEST_CRASH_AFTER"] = "2"
    env[tmesh.HOST_MESH_ENV] = "8"
    env.pop("TSSPARK_TRACE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.orchestrate",
         "--_resident", "--data", dd, "--out", od, "--series",
         str(SERIES), "--chunk", str(CHUNK), "--phase1-iters", str(PHASE1),
         "--no-phase1-tune", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 17, proc.stderr[-2000:]
    landed = orchestrate.completed_ranges(od)
    assert landed and orchestrate.missing_ranges(landed, SERIES)
    assert json.load(open(os.path.join(
        od, resident.RESIDENT_STATE_FILE)))["mesh"] == [8, 1]
    out = resident.run_resident(
        data_dir=dd, out_dir=od, series=SERIES, chunk=CHUNK,
        phase1_iters=PHASE1, no_phase1_tune=True, mesh=_mesh(8),
    )
    assert out["complete"] and out["fit_path"] == "resident"
    cur = 0
    for lo, hi in sorted(orchestrate.completed_ranges(od)):
        assert lo == cur, f"gap or overlap at {lo} (covered to {cur})"
        cur = hi
    assert cur == SERIES
    _same(orchestrate.load_fit_state(od, SERIES), fileproto)


def test_resident_mode_without_a_mesh_runs_the_chunk_worker(tmp_path,
                                                            fileproto):
    """``--_resident --device cpu`` with no host mesh: one CPU entry is no
    mesh, so the child runs the chunk-worker body in its own process (as
    the reference's meshless child does) and lands the same bits."""
    dd, od = _setup(tmp_path, "meshless")
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env.pop(tmesh.HOST_MESH_ENV, None)
    env.pop("TSSPARK_TEST_CRASH_AFTER", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.orchestrate",
         "--_resident", "--data", dd, "--out", od, "--series",
         str(SERIES), "--chunk", str(CHUNK), "--phase1-iters", str(PHASE1),
         "--no-phase1-tune", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert not os.path.exists(os.path.join(od, resident.RESIDENT_STATE_FILE))
    assert any("worker" in r for r in _times(od))
    _same(orchestrate.load_fit_state(od, SERIES), fileproto)


def test_meshless_run_degrades_with_a_single_warning(tmp_path, monkeypatch):
    """No usable mesh: ONE RuntimeWarning, then the chunk-file protocol
    serves the run with the caller's sizing and device forwarded."""
    calls = []

    def stub_run_resilient(**kwargs):
        calls.append(kwargs)
        return dict(kwargs.get("state") or {}, complete=True)

    monkeypatch.setattr(resident, "usable_mesh", lambda *a, **k: None)
    monkeypatch.setattr(orchestrate, "run_resilient", stub_run_resilient)
    monkeypatch.setattr(resident, "_MESHLESS_WARNED", False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = resident.run_resident(
            data_dir=str(tmp_path / "d"), out_dir=str(tmp_path / "o"),
            series=64, chunk=16, phase1_iters=6, device="cpu",
        )
        out2 = resident.run_resident(
            data_dir=str(tmp_path / "d"), out_dir=str(tmp_path / "o"),
            series=64, chunk=16, phase1_iters=6,
        )
    meshless = [w for w in rec if "no usable device mesh" in str(w.message)]
    assert len(meshless) == 1
    assert out["fit_path"] == "fileproto" and out["complete"]
    assert out2["fit_path"] == "fileproto"
    assert len(calls) == 2
    assert calls[0]["series"] == 64 and calls[0]["chunk"] == 16
    assert calls[0]["phase1_iters"] == 6 and calls[0]["device"] == "cpu"
    assert calls[0]["min_chunk"] == 16 and calls[0]["segment"] == 0


def test_usable_mesh(monkeypatch):
    monkeypatch.setenv(tmesh.HOST_MESH_ENV, "8")
    m = resident.usable_mesh()
    assert dict(m.shape) == {"series": 8, "time": 1}
    assert resident.usable_mesh(min_devices=9) is None
    assert resident.usable_mesh(device="cuda") is None
    monkeypatch.delenv(tmesh.HOST_MESH_ENV)
    assert resident.usable_mesh(device="cpu") is None
    if not torch.cuda.is_available():
        assert resident.usable_mesh() is None


@pytest.mark.parametrize("width", [1, 2, 4, 6, 8, 12, 16, 24, 32, 96, 1024])
def test_shards_for_width_is_the_references(width):
    for n in (1, 2, 4, 8):
        assert resident._shards_for_width(width, n) == \
            jres._shards_for_width(width, n)
    assert resident.MIN_ROWS_PER_SHARD == jres.MIN_ROWS_PER_SHARD


def test_autotuner_shard_width_multiple():
    """The shard-width hook: every size the port's tuner emits respects
    the multiple (floor included), step for step the JAX package's."""
    from tsspark_tpu.perf import ChunkAutotuner as JTuner
    from tsspark_tpu_torch.perf import ChunkAutotuner

    t = ChunkAutotuner(cap=1024, floor=16, multiple=64)
    j = JTuner(cap=1024, floor=16, multiple=64)
    assert t.floor == j.floor == 64
    for _ in range(8):
        size = t.next_size()
        assert size == j.next_size()
        assert size % 64 == 0 and size <= 1024
        t.record(size, size, 0.5)
        j.record(size, size, 0.5)
    t3 = ChunkAutotuner.load("/nonexistent/autotune.json", cap=512,
                             floor=4, multiple=8)
    assert t3.floor == 8 and t3.next_size() % 8 == 0


@pytest.mark.parametrize("source", ["spill", "plane"])
def test_resident_against_the_jax_packages_resident_run(tmp_path, source):
    """Both packages' resident runs on the same data dir (a spill dir, or
    a plane dataset the port ingested: claims gated on its landed
    coverage), each with its own run config and 8-entry mesh: losses at
    rtol 1e-3, atol 1e-2 (the port's worker-against-worker tolerance),
    the same converged rows and scaling meta, and flush-state artifacts
    of the same keys and values (each package reads the other's
    ``resident.json``)."""
    dd, od = _setup(tmp_path, "port")
    _, jod = _setup(tmp_path, "jax", mod=jcfg, save=jorch.save_run_config)
    if source == "plane":
        from tsspark_tpu_torch.data import plane

        dd = plane.ensure(plane.DatasetSpec("m5", SERIES, DAYS, seed=2,
                                            shard_rows=32),
                          root=str(tmp_path / "plane"))
    out = resident.run_resident(
        data_dir=dd, out_dir=od, series=SERIES, chunk=CHUNK,
        phase1_iters=PHASE1, no_phase1_tune=True, mesh=_mesh(8))
    jout = jres.run_resident(
        data_dir=dd, out_dir=jod, series=SERIES, chunk=CHUNK,
        phase1_iters=PHASE1, no_phase1_tune=True)
    assert out["complete"] and jout["complete"]
    assert out["fit_path"] == jout["fit_path"] == "resident"
    got = orchestrate.load_fit_state(od, SERIES)
    ref = jorch.load_fit_state(jod, SERIES)
    np.testing.assert_allclose(np.asarray(got.loss), np.asarray(ref.loss),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    for k in ("y_scale", "ds_start", "ds_span", "changepoints"):
        np.testing.assert_array_equal(np.asarray(getattr(got.meta, k)),
                                      np.asarray(getattr(ref.meta, k)))
    st = json.load(open(os.path.join(od, resident.RESIDENT_STATE_FILE)))
    jst = json.load(open(os.path.join(jod, jres.RESIDENT_STATE_FILE)))
    assert set(st) == set(jst)
    for k in ("wave", "landed", "series", "mesh", "width", "path"):
        assert st[k] == jst[k], k
    # Either package loads the other's chunk coverage.
    _same(jorch.load_fit_state(od, SERIES), got)
