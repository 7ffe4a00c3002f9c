"""The port's orchestrator (``tsspark_tpu_torch.orchestrate``) against the
JAX package's, on the CPU: the claim functions, leases, the chunk / prep
/ lease files across the two packages, the fit worker in process (its
two phases, resume, the prep cache) and its results against the port's
``fit_twophase`` (bitwise) and the JAX package's worker.

Sizes are the reference tests' (``tests/test_orchestrate.py``):
``m5_like(96, 128)``, 32-row chunks, 6 phase-1 iterations.
"""

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu import orchestrate as jorch
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.backends.cuda import CudaBackend
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.models.prophet.design import (
    _indicator_reg_cols,
    pack_fit_data,
    prepare_fit_data,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _args(tmp_path, series=96, days=128, chunk=32, phase1=6, segment=0,
          jax_out=False):
    """The reference test's data dir and worker args (the port's run
    config; ``jax_out`` adds an out dir holding the JAX package's)."""
    data_dir = tmp_path / "data"
    out_dir = tmp_path / "out"
    data_dir.mkdir()
    out_dir.mkdir()
    batch = datasets.m5_like(n_series=series, n_days=days)
    np.save(data_dir / "ds.npy", batch.ds.astype(np.float32))
    np.save(data_dir / "y.npy", np.nan_to_num(batch.y).astype(np.float32))
    np.save(data_dir / "mask.npy", batch.mask.astype(np.float32))
    np.save(data_dir / "reg.npy", batch.regressors.astype(np.float32))
    orchestrate.save_run_config(
        str(out_dir), _model_config(tcfg), tcfg.SolverConfig(max_iters=120)
    )
    if jax_out:
        (tmp_path / "jout").mkdir()
        jorch.save_run_config(str(tmp_path / "jout"), _model_config(jcfg),
                              jcfg.SolverConfig(max_iters=120))
    return argparse.Namespace(
        data=str(data_dir), out=str(out_dir), lo=0, hi=series, chunk=chunk,
        segment=segment, series=series, phase1_iters=phase1,
        no_phase1_tune=False, max_ahead=6, device="cpu",
    )


def _data(args):
    return tuple(np.load(os.path.join(args.data, f"{k}.npy"))
                 for k in ("ds", "y", "mask", "reg"))


def _times(out):
    with open(os.path.join(out, "times.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _fake_state(n=4, p=3, seed=0):
    """A FitState with the dtypes a fit writes (theta float32, the
    diagnostics float32 / bool / int32, the meta float64)."""
    from tsspark_tpu_torch.models.prophet.design import ScalingMeta
    from tsspark_tpu_torch.models.prophet.model import FitState

    rng = np.random.default_rng(seed)
    f64 = lambda *s: rng.normal(size=s)  # noqa: E731
    return FitState(
        theta=torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)),
        loss=rng.normal(size=n).astype(np.float32),
        grad_norm=rng.uniform(size=n).astype(np.float32),
        converged=rng.uniform(size=n) < 0.7,
        n_iters=rng.integers(1, 60, n).astype(np.int32),
        status=rng.integers(0, 5, n).astype(np.int32),
        meta=ScalingMeta(
            y_scale=np.abs(f64(n)) + 1, floor=f64(n), ds_start=f64(n),
            ds_span=np.abs(f64(n)) + 1, reg_mean=f64(n, 2),
            reg_std=np.abs(f64(n, 2)) + 1, changepoints=f64(n, 5),
        ),
    )


_FIELDS = ("theta", "loss", "grad_norm", "converged", "n_iters", "status")


def _same_state(a, b):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for f in a.meta._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a.meta, f)),
                                      np.asarray(getattr(b.meta, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# claims and leases
# ---------------------------------------------------------------------------


def test_claims_equal_the_reference_over_a_grid():
    """``missing_ranges`` and ``plan_chunks`` over random done-sets (lo
    past 999,999 included) give the JAX package's lists."""
    rng = np.random.default_rng(0)
    for base in (0, 999_000, 1_000_448):
        for _ in range(60):
            total = base + int(rng.integers(1, 3000))
            cuts = base + np.sort(rng.choice(total - base + 1,
                                             size=int(rng.integers(0, 12)),
                                             replace=False))
            pairs = list(zip(cuts[0::2], cuts[1::2]))
            done = [(int(a), int(b)) for a, b in pairs if a < b]
            rng.shuffle(done)
            assert orchestrate.missing_ranges(done, total) \
                == jorch.missing_ranges(done, total)
            for chunk in (1, 7, 512):
                lo = base + int(rng.integers(0, total - base))
                assert orchestrate.plan_chunks(done, lo, total, chunk) \
                    == jorch.plan_chunks(done, lo, total, chunk)


def test_completed_ranges_sort_numerically_as_the_reference(tmp_path):
    """Past 999,999 series the names' lexical order is wrong; both
    packages return the numeric order."""
    out = str(tmp_path)
    ranges = [(999_936, 1_000_448), (998_912, 999_936),
              (1_000_448, 1_000_960), (0, 512), (512, 998_912)]
    for lo, hi in ranges:
        open(orchestrate._chunk_path(out, lo, hi), "w").close()
    got = orchestrate.completed_ranges(out)
    assert got == sorted(ranges) == jorch.completed_ranges(out)
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(out, "chunk_*.npz")))
    lex = [tuple(map(int, n[len("chunk_"):-len(".npz")].split("_")))
           for n in names]
    assert lex != got


def test_chunk_lease_claim_steal_and_fence(tmp_path):
    """A live lease blocks rivals (on the exact range and on overlapping
    ones), a stale one (expired, dead owner, torn) is stolen, the loser
    of a steal is fenced, and only the holder releases
    (``tests/test_orchestrate.py::test_chunk_lease_claim_steal_and_fence``)."""
    out = str(tmp_path)
    assert orchestrate.claim_lease(out, 0, 32, "w1")
    assert not orchestrate.claim_lease(out, 0, 32, "w2")
    assert orchestrate.claim_lease(out, 0, 32, "w1")
    assert orchestrate.holds_lease(out, 0, 32, "w1")
    assert not orchestrate.holds_lease(out, 0, 32, "w2")

    with open(orchestrate._lease_path(out, 0, 32), "w") as fh:
        json.dump({"token": "w1", "pid": os.getpid(),
                   "expires_unix": 0.0}, fh)
    assert orchestrate.claim_lease(out, 0, 32, "w2")
    assert not orchestrate.holds_lease(out, 0, 32, "w1")  # fenced
    assert orchestrate.holds_lease(out, 0, 32, "w2")

    dead = subprocess.Popen(["true"])
    dead.wait()  # reaped: its pid no longer exists
    with open(orchestrate._lease_path(out, 64, 96), "w") as fh:
        json.dump({"token": "gone", "pid": dead.pid,
                   "expires_unix": 4e12}, fh)
    assert orchestrate.claim_lease(out, 64, 96, "w3")

    with open(orchestrate._lease_path(out, 96, 128), "w") as fh:
        fh.write('{"token": "to')
    assert orchestrate.claim_lease(out, 96, 128, "w4")

    assert orchestrate.claim_lease(out, 128, 160, "wa")
    assert not orchestrate.claim_lease(out, 136, 144, "wb")  # inside
    assert not orchestrate.claim_lease(out, 152, 176, "wb")  # straddles
    assert orchestrate.claim_lease(out, 160, 192, "wb")      # adjacent
    assert orchestrate.claim_lease(out, 136, 144, "wa")      # own grid

    orchestrate.release_lease(out, 0, 32, "w1")  # loser: no-op
    assert orchestrate.holds_lease(out, 0, 32, "w2")
    orchestrate.release_lease(out, 0, 32, "w2")
    assert orchestrate.read_lease(out, 0, 32) is None
    assert orchestrate.claim_lease(out, 0, 32, "w5")


def test_leases_cross_packages(tmp_path):
    """A lease either package writes blocks and fences the other's
    claimants: one record format, one file name."""
    out = str(tmp_path)
    assert jorch.claim_lease(out, 0, 32, "jax-worker")
    assert not orchestrate.claim_lease(out, 0, 32, "port-worker")
    assert not orchestrate.claim_lease(out, 16, 48, "port-worker")
    assert orchestrate.read_lease(out, 0, 32) == jorch.read_lease(out, 0, 32)
    assert orchestrate.claim_lease(out, 32, 64, "port-worker")
    assert not jorch.claim_lease(out, 40, 48, "jax-worker")
    assert jorch.holds_lease(out, 32, 64, "port-worker")
    jorch.release_lease(out, 32, 64, "port-worker")
    assert orchestrate.read_lease(out, 32, 64) is None


# ---------------------------------------------------------------------------
# chunk, prep files across packages; integrity
# ---------------------------------------------------------------------------


def test_chunk_files_cross_packages_bitwise(tmp_path):
    """A scratch dir the port wrote assembles in the JAX package's
    ``load_fit_state`` (and the other way round) to the same bits, CRC
    stamp and all."""
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    parts = [(0, 4, _fake_state(4, seed=1)), (4, 9, _fake_state(5, seed=2)),
             (9, 11, _fake_state(2, seed=3))]
    for lo, hi, st in parts:
        assert orchestrate.save_chunk_atomic(port_dir, lo, hi, st) is False
        jorch.save_chunk_atomic(jax_dir, lo, hi, orchestrate._numpy_state(st))
    for lo, hi, _ in parts:
        with open(orchestrate._chunk_path(port_dir, lo, hi), "rb") as a, \
                open(jorch._chunk_path(jax_dir, lo, hi), "rb") as b:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for d in (port_dir, jax_dir):
        got = orchestrate.load_fit_state(d, 11)
        ref = jorch.load_fit_state(d, 11)
        assert isinstance(got.theta, torch.Tensor)
        _same_state(got, ref)


def test_prep_files_cross_packages_bitwise(tmp_path):
    """A prep payload either package wrote loads in the other to the same
    bits, under the same indicator split; a different split is refused
    by both."""
    args = _args(tmp_path, series=64, chunk=32, phase1=0)
    ds, y, mask, reg = _data(args)
    u8 = _indicator_reg_cols(reg)
    data, meta = prepare_fit_data(ds, y[:32], _model_config(tcfg),
                                  mask=mask[:32], regressors=reg[:32])
    packed, _ = pack_fit_data(data, meta, ds, reg_u8_cols=u8,
                              collapse_cap=True)
    orchestrate.save_prep_atomic(args.out, 0, 32, 32, packed, meta,
                                 u8_cols=u8)
    for loader in (orchestrate.load_prep, jorch.load_prep):
        b_real, p2, m2 = loader(args.out, 0, 32, chunk=32, u8_cols=u8)
        assert b_real == 32
        for k in packed._fields:
            np.testing.assert_array_equal(np.asarray(getattr(p2, k)),
                                          getattr(packed, k), err_msg=k)
        for k in meta._fields:
            np.testing.assert_array_equal(np.asarray(getattr(m2, k)),
                                          getattr(meta, k), err_msg=k)
        assert loader(args.out, 0, 32, chunk=32, u8_cols=(0,)) is None
        assert loader(args.out, 0, 32, chunk=64, u8_cols=u8) is None
    jorch.save_prep_atomic(args.out, 32, 64, 32, packed, meta, u8_cols=u8)
    _, p3, _ = orchestrate.load_prep(args.out, 32, 64, u8_cols=u8)
    np.testing.assert_array_equal(np.asarray(p3.y), packed.y)


def test_torn_chunk_quarantined_and_requeued(tmp_path):
    """A truncated chunk and a re-saved one with a stale stamp are both
    quarantined (``*.corrupt``) and their ranges re-queued; the typed
    error carries the ranges."""
    out = str(tmp_path)
    orchestrate.save_chunk_atomic(out, 0, 4, _fake_state())
    orchestrate.save_chunk_atomic(out, 4, 8, _fake_state(seed=5))
    path = orchestrate._chunk_path(out, 0, 4)
    with open(path, "r+b") as fh:  # torn write: truncate mid-file
        fh.truncate(os.path.getsize(path) // 2)
    z = dict(np.load(orchestrate._chunk_path(out, 4, 8)))
    z["loss"] = z["loss"] + 7.0
    np.savez(orchestrate._chunk_path(out, 4, 8), **z)
    with pytest.raises(orchestrate.ChunkIntegrityError) as ei:
        orchestrate.load_fit_state(out, 8)
    assert ei.value.ranges == [(0, 4), (4, 8)]
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert orchestrate.completed_ranges(out) == []
    assert orchestrate.missing_ranges([], 8) == [(0, 8)]


def test_corrupt_fault_tears_a_saved_chunk(tmp_path, monkeypatch):
    """The ``chunk_save`` point's "corrupt" mode flips bytes in the file
    just saved (scoped to the series it covers), and the sweep catches
    it."""
    from tsspark_tpu_torch.resilience import faults, integrity

    plan = faults.FaultPlan(state_dir=str(tmp_path / "f")).fail(
        "chunk_save", series=5, attempts=1, mode="corrupt")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    out = str(tmp_path / "o")
    os.makedirs(out)
    assert not orchestrate.save_chunk_atomic(out, 0, 4, _fake_state())
    assert orchestrate.save_chunk_atomic(out, 4, 8, _fake_state(seed=5))
    assert not orchestrate.save_chunk_atomic(out, 4, 8, _fake_state(seed=5))
    monkeypatch.delenv(faults.ENV_VAR)
    # The third save (window spent) replaced the torn file: all clean.
    assert integrity.sweep_chunks(out) == []


def test_load_prep_rejects_corrupt_cache(tmp_path):
    """A corrupt prep payload falls through to local prep (None) and is
    deleted, never fed to the fit."""
    from collections import namedtuple

    out = str(tmp_path)
    Packed = namedtuple("Packed", ["y"])
    Meta = namedtuple("Meta", ["y_scale"])
    orchestrate.save_prep_atomic(
        out, 0, 8, 8, Packed(y=np.ones((8, 4), np.float32)),
        Meta(y_scale=np.ones(8)),
    )
    path = orchestrate._prep_path(out, 0, 8)
    z = dict(np.load(path))
    z["packed_y"] = z["packed_y"] * 2
    np.savez(path, **z)
    assert orchestrate.load_prep(out, 0, 8) is None
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# the fit worker in process
# ---------------------------------------------------------------------------


def test_fit_worker_two_phase_and_resume(tmp_path):
    """Three chunks land, phase 2 patches them and writes its marker; a
    complete rerun refits nothing; a lost chunk and marker are refitted
    and re-patched, the other chunks kept (idempotent phase 2)."""
    args = _args(tmp_path)
    assert orchestrate.fit_worker(args) == 0

    files = sorted(glob.glob(os.path.join(args.out, "chunk_*.npz")))
    assert len(files) == 3
    for f in files:
        z = np.load(f)
        assert z["phase2"] == 1
        assert z["converged"].all()
        assert z["theta"].shape[0] == 32
    assert os.path.exists(os.path.join(args.out, "phase2_done"))
    times = _times(args.out)
    assert sum(1 for t in times if "fit_s" in t) == 3
    assert all(t["device"] == "cpu" for t in times if "fit_s" in t)
    phase2 = [t for t in times if "phase2_s" in t]
    assert len(phase2) == 1 and phase2[0]["phase2_mode"] == "resident"
    assert os.path.exists(os.path.join(args.out, "heartbeat"))

    n_times = len(times)
    assert orchestrate.fit_worker(args) == 0
    # The rerun logs its start and nothing else.
    assert [t for t in _times(args.out)[n_times:] if "worker" not in t] \
        == []

    victim = files[1]
    kept = np.load(files[0])["theta"]
    os.remove(victim)
    os.remove(os.path.join(args.out, "phase2_done"))
    assert orchestrate.fit_worker(args) == 0
    z = np.load(victim)
    assert z["phase2"] == 1 and z["converged"].all()
    np.testing.assert_array_equal(np.load(files[0])["theta"], kept)
    assert os.path.exists(os.path.join(args.out, "phase2_done"))


@pytest.mark.parametrize("resident", [True, False])
def test_worker_equals_fit_twophase_bitwise(tmp_path, monkeypatch, resident):
    """The unification gate: the port's chunk worker and the port's
    ``CudaBackend.fit_twophase`` at the same chunk width land on the same
    bits (status, theta, loss, n_iters; T = 128 plans no length buckets),
    with phase 2 gathered from the resident payloads or re-prepped on the
    host."""
    if resident:
        monkeypatch.delenv("TSSPARK_RESIDENT_MB", raising=False)
    else:
        monkeypatch.setenv("TSSPARK_RESIDENT_MB", "0")
    args = _args(tmp_path)
    args.no_phase1_tune = True
    assert orchestrate.fit_worker(args) == 0
    p2 = next(t for t in _times(args.out) if "phase2_s" in t)
    assert p2["phase2_mode"] == ("resident" if resident else "host")
    assert (p2["resident_bytes"] > 0) == resident
    worker = orchestrate.load_fit_state(args.out, args.series)
    ds, y, mask, reg = _data(args)
    bk = CudaBackend(_model_config(tcfg), tcfg.SolverConfig(max_iters=120),
                     chunk_size=32, device="cpu")
    mem = bk.fit_twophase(ds, y, mask=mask, regressors=reg, phase1_iters=6)
    assert bk.twophase["stragglers"] > 0
    _same_state(worker, mem)


def test_worker_against_the_jax_package_worker(tmp_path):
    """The port's worker and the JAX package's on the same data dir, each
    with its own run config.  Two float32 lockstep solvers stop at the
    noise floor at different points, so the loss is held to
    ``test_torch_twophase.py``'s tolerance (rtol 1e-3, atol 1e-2; read
    here: 0.080 nats at most, 3.4e-4 relative); which rows converged is
    exact, and the stop reason may swap among FTOL / FLOOR / STALLED
    (read: 13 of 96 rows) — a reason, not a result, of that noise."""
    args = _args(tmp_path, jax_out=True)
    args.no_phase1_tune = True
    assert orchestrate.fit_worker(args) == 0
    jargs = argparse.Namespace(**{**vars(args),
                                  "out": str(tmp_path / "jout")})
    del jargs.device
    assert jorch.fit_worker(jargs) == 0
    got = orchestrate.load_fit_state(args.out, args.series)
    ref = jorch.load_fit_state(jargs.out, args.series)
    np.testing.assert_allclose(np.asarray(got.loss), np.asarray(ref.loss),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    st, jst = np.asarray(got.status), np.asarray(ref.status)
    np.testing.assert_array_equal(st == 0, jst == 0)
    assert np.isin(st[st != jst], (2, 3, 4)).all()
    for k in ("y_scale", "ds_start", "ds_span", "changepoints"):
        np.testing.assert_array_equal(np.asarray(getattr(got.meta, k)),
                                      np.asarray(getattr(ref.meta, k)))


def test_prep_worker_cache_matches_inline_prep(tmp_path):
    """The CPU ``--_prep`` worker and the fit worker's inline prep run
    the same prepare/pack code; the cached payload is bit-identical, a
    second prep run is a no-op, and a fit from the cache is the inline
    fit's bits."""
    args = _args(tmp_path, series=64, chunk=32, phase1=0)
    args.max_ahead = 1
    assert orchestrate.prep_worker(args) == 0
    cached = orchestrate.load_prep(args.out, 0, 32)
    assert cached is not None
    b_real, packed, meta = cached
    assert b_real == 32
    assert orchestrate.load_prep(args.out, 32, 64) is None  # max_ahead 1

    ds, y, mask, reg = _data(args)
    u8 = _indicator_reg_cols(reg)
    data, meta_ref = prepare_fit_data(ds, y[:32], _model_config(tcfg),
                                      mask=mask[:32], regressors=reg[:32])
    packed_ref, _ = pack_fit_data(data, meta_ref, ds, reg_u8_cols=u8,
                                  collapse_cap=True)
    for k in packed._fields:
        np.testing.assert_array_equal(np.asarray(getattr(packed, k)),
                                      np.asarray(getattr(packed_ref, k)),
                                      err_msg=k)
    for k in meta._fields:
        np.testing.assert_array_equal(np.asarray(getattr(meta, k)),
                                      np.asarray(getattr(meta_ref, k)),
                                      err_msg=k)
    mtime = os.path.getmtime(orchestrate._prep_path(args.out, 0, 32))
    assert orchestrate.prep_worker(args) == 0
    assert os.path.getmtime(orchestrate._prep_path(args.out, 0, 32)) \
        == mtime

    # The fit worker consumes (and removes) the cache: its chunk equals
    # an inline-prepped worker's.
    assert orchestrate.fit_worker(args) == 0
    assert not os.path.exists(orchestrate._prep_path(args.out, 0, 32))
    cached_fit = dict(np.load(orchestrate._chunk_path(args.out, 0, 32)))
    os.remove(orchestrate._chunk_path(args.out, 0, 32))
    os.remove(os.path.join(args.out, "phase2_done"))
    assert orchestrate.fit_worker(args) == 0
    inline = np.load(orchestrate._chunk_path(args.out, 0, 32))
    for k in ("theta", "loss", "status", "n_iters"):
        np.testing.assert_array_equal(cached_fit[k], inline[k], err_msg=k)


def test_single_phase_worker_writes_phase2_marker(tmp_path):
    """phase1_iters >= the solver's max_iters degenerates to one phase;
    the worker still writes phase2_done at full coverage (or the parent
    would respawn workers forever)."""
    args = _args(tmp_path, series=64, chunk=32, phase1=12)
    orchestrate.save_run_config(
        args.out, _model_config(tcfg), tcfg.SolverConfig(max_iters=10)
    )
    assert orchestrate.fit_worker(args) == 0
    assert os.path.exists(os.path.join(args.out, "phase2_done"))
    assert not any("phase2_s" in t for t in _times(args.out))


def test_segmented_worker_takes_the_fitdata_path(tmp_path):
    """``--segment`` below the phase-1 depth: per-segment solves with a
    heartbeat each, phase 2 through the straggler backend; the result is
    complete and converged."""
    args = _args(tmp_path, series=64, chunk=32, phase1=6, segment=3)
    args.no_phase1_tune = True
    assert orchestrate.fit_worker(args) == 0
    mode = next(t["phase2_mode"] for t in _times(args.out)
                if "phase2_s" in t)
    assert mode == "segmented"
    state = orchestrate.load_fit_state(args.out, 64)
    assert np.asarray(state.converged).all()
    assert torch.isfinite(state.theta).all()


def test_resident_mode_runs_the_resident_worker(tmp_path):
    """``--_resident --device cpu`` on the forced host mesh (8 CPU
    entries) runs ``resident.resident_worker``: the resident waves land
    the chunk files, bitwise the in-process chunk worker's."""
    (tmp_path / "worker").mkdir()
    (tmp_path / "resident").mkdir()
    args = _args(tmp_path / "worker")
    args.no_phase1_tune = True
    assert orchestrate.fit_worker(args) == 0
    res = _args(tmp_path / "resident")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["TSSPARK_HOST_MESH"] = "8"
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.orchestrate", "--_resident",
         "--data", res.data, "--out", res.out, "--series", str(res.series),
         "--chunk", str(res.chunk), "--phase1-iters", str(res.phase1_iters),
         "--no-phase1-tune", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(os.path.join(res.out, "resident.json")) as fh:
        assert json.load(fh)["path"] == "resident"
    _same_state(orchestrate.load_fit_state(res.out, res.series),
                orchestrate.load_fit_state(args.out, args.series))


# ---------------------------------------------------------------------------
# telemetry: the autotuner, the times summary, the traced worker's exports
# ---------------------------------------------------------------------------


def test_chunk_autotuner_takes_the_reference_decisions(tmp_path):
    """``ChunkAutotuner`` walks the pow-2 ladder as the JAX package's does
    over one stream of measurements (load-tainted samples never decide),
    and persists a state either package loads."""
    from tsspark_tpu.perf.autotune import ChunkAutotuner as JTuner
    from tsspark_tpu_torch.perf import ChunkAutotuner, load_learned_chunk

    rng = np.random.default_rng(3)
    got = ChunkAutotuner(cap=4096, floor=128,
                         state_path=str(tmp_path / "p.json"))
    ref = JTuner(cap=4096, floor=128, state_path=str(tmp_path / "j.json"))
    speed = {128: 900.0, 256: 1500.0, 512: 2100.0, 1024: 2000.0,
             2048: 1700.0, 4096: 1200.0}
    for i in range(40):
        size = got.next_size()
        assert size == ref.next_size()
        wall = size / (speed[size] * rng.uniform(0.9, 1.1))
        miss = i % 7 == 0
        got.record(size, size, wall, compile_miss=miss)
        ref.record(size, size, wall, compile_miss=miss)
        assert got.best_size == ref.best_size
    assert got.best_size in (512, 1024)
    assert load_learned_chunk(str(tmp_path / "p.json")) == got.best_size
    again = JTuner.load(str(tmp_path / "p.json"), cap=4096)
    assert again.next_size() == got.next_size()


def test_summarize_times_equals_the_reference_on_a_worker_log(tmp_path):
    """The perf summary of a real worker's ``times.jsonl`` (the port's
    rows carry extra fields) is the JAX package's summary of the same
    rows."""
    from tsspark_tpu.perf.recorder import summarize_times as jsummarize
    from tsspark_tpu_torch.perf import summarize_times

    args = _args(tmp_path, series=64, chunk=32, phase1=6)
    args.autotune = True
    assert orchestrate.fit_worker(args) == 0
    rows = _times(args.out)
    with open(os.path.join(args.out, "autotune.json")) as fh:
        tuned = json.load(fh)
    got = summarize_times(rows, tuned)
    assert got == jsummarize(rows, tuned)
    assert got["n_chunks"] == 2 and got["compile_misses"] == 0
    assert tuned["chunk"] == 32  # the tuner's cap at this size


def test_traced_worker_records_spans_and_exports_its_metrics(tmp_path):
    """With a run bound, the worker opens its span first, records claim /
    fit / land spans per chunk and exports ``metrics_fit_<pid>.json``
    (chunk and series counters) at a clean exit."""
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT

    args = _args(tmp_path, series=64, chunk=32, phase1=6)
    spans = str(tmp_path / "spans.jsonl")
    prev = obs.start_run(spans)
    DEFAULT.reset()
    try:
        assert orchestrate.fit_worker(args) == 0
    finally:
        obs.end_run(prev)
    names = [r.get("name") for r in obs.read_records(spans)]
    for n in ("fit.worker", "chunk.claim", "chunk.fit", "chunk.land",
              "fit.phase2", "phase2.done"):
        assert n in names, n
    path = os.path.join(args.out, f"metrics_fit_{os.getpid()}.json")
    with open(path) as fh:
        snap = json.load(fh)
    counters = {c["name"]: c["value"] for c in snap["metrics"]["counters"]}
    assert counters["tsspark_fit_chunks_total"] == 2
    assert counters["tsspark_fit_series_total"] == 64


def test_publish_fit_state_serves_the_assembled_run(tmp_path):
    """A completed run's chunks publish as one registry version whose
    parameters are the assembled state's; an incomplete run refuses."""
    from tsspark_tpu_torch.serve.registry import ParamRegistry

    args = _args(tmp_path, series=64, chunk=32, phase1=6)
    assert orchestrate.fit_worker(args) == 0
    reg = ParamRegistry(str(tmp_path / "reg"), _model_config(tcfg))
    ids = [f"s{i}" for i in range(64)]
    v = orchestrate.publish_fit_state(reg, args.out, ids, data_stamp=3)
    snap = reg.load(v)
    assert tuple(snap.series_ids) == tuple(ids)
    np.testing.assert_array_equal(
        np.asarray(snap.state.theta),
        orchestrate.load_fit_state(args.out, 64).theta.numpy())
    os.remove(orchestrate._chunk_path(args.out, 32, 64))
    with pytest.raises(RuntimeError, match="incomplete chunk coverage"):
        orchestrate.publish_fit_state(reg, args.out, ids)
