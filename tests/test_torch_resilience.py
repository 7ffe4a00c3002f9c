"""The port's resilient route on the CPU: ``fit_resilient`` /
``run_resilient`` with fit workers in subprocess children (each asked for
the CPU explicitly), the fault harness's worker modes, quarantine and
degradation, the kernel-build watchdog case, ``CudaBackend(resilient=
True)``'s gate, and the no-silent-CPU rule (``tests/test_resilience.py``
and ``tests/test_orchestrate.py`` case for case where the port has the
path).
"""

import glob
import json
import os
import subprocess
import sys
import warnings as warnings_mod

import numpy as np
import pytest
import torch

from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.backends import cuda as cuda_mod
from tsspark_tpu_torch.backends.cuda import CudaBackend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.policy import (
    PROBE,
    WORKER_RETRY,
    RetryPolicy,
)
from tsspark_tpu_torch.resilience.report import (
    STATUS_QUARANTINED,
    ResilienceReport,
    ResilienceWarning,
    get_report,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Fast schedules for subprocess tests: real sleeps stay, but short.
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.2, backoff=1.0,
                         max_delay_s=0.5)
_FIELDS = ("theta", "loss", "grad_norm", "converged", "n_iters", "status")


@pytest.fixture(autouse=True)
def _lean_children(monkeypatch):
    """Worker children inherit the environment: two threads each."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(k, "2")
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    monkeypatch.delenv("TSSPARK_TEST_CRASH_AFTER", raising=False)


def _model_config():
    return ProphetConfig(
        seasonalities=(SeasonalityConfig("weekly", 7.0, 3),),
        n_changepoints=6,
    )


def _batch(series=48, days=128):
    b = datasets.m5_like(n_series=series, n_days=days)
    y = np.nan_to_num(b.y).astype(np.float32)
    return b.ds.astype(np.float64), y, b.mask.astype(np.float32)


def _fit(tmp_path, name, ds, y, mask, **kw):
    kw.setdefault("chunk", 16)
    kw.setdefault("phase1_iters", 4)
    kw.setdefault("no_phase1_tune", True)
    kw.setdefault("retry_policy", FAST_RETRY)
    kw.setdefault("device", "cpu")
    return orchestrate.fit_resilient(
        _model_config(), SolverConfig(max_iters=60), ds, y, mask=mask,
        scratch_dir=str(tmp_path / name), **kw,
    )


def _same(got, ref, rows=None):
    sel = slice(None) if rows is None else rows
    for f in _FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f))[sel],
            np.asarray(getattr(ref, f))[sel], err_msg=f)
    for f in ref.meta._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got.meta, f))[sel],
            np.asarray(getattr(ref.meta, f))[sel], err_msg=f)


def _tiles(out_dir, n):
    """Completed ranges tile [0, n) with no gap and no overlap."""
    cur = 0
    for lo, hi in orchestrate.completed_ranges(out_dir):
        assert lo == cur, f"gap or overlap at {lo} (covered to {cur})"
        cur = hi
    assert cur == n


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One uninterrupted run (48 x 128, 16-row chunks): the bits every
    faulted run of this file must land on."""
    ds, y, mask = _batch()
    tmp = tmp_path_factory.mktemp("ref")
    ref = _fit(tmp, "ref", ds, y, mask)
    return ds, y, mask, ref


# -- the policies and the fault harness's worker modes ---------------------


def test_worker_and_probe_schedules_are_the_reference_fields():
    from tsspark_tpu.resilience import policy as jpolicy

    for got, want in ((WORKER_RETRY, jpolicy.WORKER_RETRY),
                      (PROBE, jpolicy.PROBE)):
        for f in ("max_attempts", "base_delay_s", "backoff", "max_delay_s",
                  "jitter", "attempt_timeout_s", "attempt_timeout_step_s",
                  "attempt_timeout_max_s", "total_budget_s", "seed"):
            assert getattr(got, f) == getattr(want, f), f
        for k in range(6):
            assert got.delay_s(k) == want.delay_s(k)
            assert got.attempt_timeout(k) == want.attempt_timeout(k)


def test_flag_and_exit_modes_fire_in_their_windows(tmp_path, monkeypatch):
    """"flag" makes ``inject`` return True inside its window; "exit"
    kills the process with its code (a child here), counted across
    processes."""
    plan = (faults.FaultPlan(state_dir=str(tmp_path / "st"))
            .fail("device_probe", after=1, attempts=1, mode="flag")
            .fail("fit_worker_start", after=1, attempts=1, mode="exit",
                  rc=31))
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    assert [faults.inject("device_probe") for _ in range(3)] \
        == [False, True, False]
    code = ("from tsspark_tpu_torch.resilience import faults\n"
            "faults.inject('fit_worker_start')\nprint('alive')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    rcs = [subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True).returncode
           for _ in range(3)]
    assert rcs == [0, 31, 0]


# -- crash, SIGKILL and torn chunks through the parent loop ----------------


def test_run_resilient_survives_worker_crash_bitwise(tmp_path, monkeypatch,
                                                     reference):
    """``TSSPARK_TEST_CRASH_AFTER`` makes each child exit(17) after
    saving 2 chunks: the parent retries, landed chunks persist, and the
    assembled result is bitwise the uninterrupted run's."""
    ds, y, mask, ref = reference
    scratch = tmp_path / "scratch"
    data_dir, out_dir = str(scratch / "data"), str(scratch / "out")
    orchestrate.spill_data(data_dir, ds, y, mask=mask)
    orchestrate.save_run_config(out_dir, _model_config(),
                                SolverConfig(max_iters=60))
    monkeypatch.setenv("TSSPARK_TEST_CRASH_AFTER", "2")
    state = orchestrate.run_resilient(
        data_dir=data_dir, out_dir=out_dir, series=48, chunk=16,
        min_chunk=16, segment=0, phase1_iters=4, no_phase1_tune=True,
        deadline=None, progress_timeout=600.0, device="cpu",
        retry_policy=FAST_RETRY,
    )
    assert state["complete"] and state["retries"] >= 1
    assert state["probes"]["n"] == 0  # pinned to the CPU: no probe
    _tiles(out_dir, 48)
    _same(orchestrate.load_fit_state(out_dir, 48), ref)


def test_exit_and_torn_chunk_land_every_range_exactly_once(
        tmp_path, monkeypatch, reference):
    """The worker dies right after landing its first chunk and a later
    save is silently corrupted: the parent respawns, the torn file is
    quarantined and refitted, coverage tiles [0, 48) exactly once, every
    lease left behind is reclaimable, and the result is bitwise the
    uninterrupted run's."""
    ds, y, mask, ref = reference
    plan = (faults.FaultPlan(state_dir=str(tmp_path / "faults"))
            .fail("fit_worker_chunk", after=0, attempts=1, mode="exit",
                  rc=31)
            .fail("chunk_save", series=40, attempts=1, mode="corrupt"))
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    got = _fit(tmp_path, "s", ds, y, mask)
    monkeypatch.delenv(faults.ENV_VAR)
    out_dir = str(tmp_path / "s" / "out")
    assert get_report(got).retries >= 1
    assert glob.glob(os.path.join(out_dir, "chunk_000032_000048.npz.corrupt"))
    _tiles(out_dir, 48)
    _same(got, ref)
    for lo, hi in orchestrate.completed_ranges(out_dir):
        assert orchestrate.claim_lease(out_dir, lo, hi, "post-check")
    with open(os.path.join(out_dir, "spawns.jsonl")) as fh:
        spawns = [json.loads(line) for line in fh]
    assert [s["rc"] for s in spawns][0] == 31 and spawns[-1]["rc"] == 0


def test_sigkill_mid_chunk_lands_the_range_exactly_once(
        tmp_path, monkeypatch, reference):
    """A worker wedged inside its second chunk's solve (a long "sleep" at
    ``fit_chunk``) is SIGKILLed by the parent's stall watchdog while it
    holds that range's lease; the respawned worker steals the dead
    owner's lease, lands the range once, and the result is bitwise the
    uninterrupted run's."""
    ds, y, mask, ref = reference
    monkeypatch.setattr(orchestrate, "WATCH_POLL_S", 0.5)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "fit_chunk", after=1, attempts=1, mode="sleep", delay_s=120.0)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    got = _fit(tmp_path, "s", ds, y, mask, progress_timeout=3.0)
    monkeypatch.delenv(faults.ENV_VAR)
    out_dir = str(tmp_path / "s" / "out")
    with open(os.path.join(out_dir, "spawns.jsonl")) as fh:
        rcs = [json.loads(line)["rc"] for line in fh]
    assert rcs[0] == -9 and rcs[-1] == 0  # killed, then completed
    assert get_report(got).retries >= 1
    _tiles(out_dir, 48)
    _same(got, ref)


def test_fit_resilient_resumes_and_refuses_a_different_run(tmp_path,
                                                           reference):
    """A second call on the same scratch dir resumes (nothing refits, the
    same bits); the same scratch dir with DIFFERENT data, or another
    device, is refused instead of mixing chunk results."""
    ds, y, mask, ref = reference
    first = _fit(tmp_path, "s", ds, y, mask)
    out_dir = str(tmp_path / "s" / "out")
    mtimes = {p: os.path.getmtime(p)
              for p in glob.glob(os.path.join(out_dir, "chunk_*.npz"))}
    again = _fit(tmp_path, "s", ds, y, mask)
    _same(again, first)
    _same(first, ref)
    assert mtimes == {p: os.path.getmtime(p) for p in mtimes}
    with pytest.raises(ValueError, match="DIFFERENT resilient run"):
        _fit(tmp_path, "s", ds, y + 1.0, mask)


def test_finite_contract_raises_immediately_without_quarantine(tmp_path):
    ds, y, mask = _batch(series=8)
    y, mask = y.copy(), mask.copy()
    y[3, 10] = np.nan
    mask[3, 10] = 1.0  # observed-but-NaN: the pack contract violation
    with pytest.raises(ValueError, match="finite y wherever mask == 1"):
        _fit(tmp_path, "s", ds, y, mask, quarantine=False)
    # Raised BEFORE spilling data or spawning workers.
    assert not os.path.exists(str(tmp_path / "s" / "data" / "y.npy"))


def test_poisoned_series_quarantined_up_front(tmp_path, reference):
    """With ``quarantine=True`` the contract's violators are quarantined
    before fitting (NaN row, its status) and every other row keeps the
    clean run's bits."""
    ds, y, mask, ref = reference
    y, mask = y.copy(), mask.copy()
    y[21, 5] = np.nan
    mask[21, 5] = 1.0
    got = _fit(tmp_path, "s", ds, y, mask)
    report = get_report(got)
    assert report.quarantined_indices == (21,)
    assert "non-finite observed y" in report.quarantined[0].reason
    assert np.isnan(np.asarray(got.theta)[21]).all()
    assert np.asarray(got.status)[21] == STATUS_QUARANTINED
    healthy = np.asarray([i for i in range(48) if i != 21])
    _same(got, ref, rows=healthy)


def test_quarantine_placeholder_rows_assemble(tmp_path):
    """Placeholder chunks for quarantined series satisfy load_fit_state's
    coverage/shape contract and carry the quarantine markers."""
    from tsspark_tpu_torch.models.prophet.design import ScalingMeta
    from tsspark_tpu_torch.models.prophet.model import FitState

    def fake(n):
        z = lambda *s: np.zeros(s)  # noqa: E731
        return FitState(
            theta=torch.arange(n * 3, dtype=torch.float32).reshape(n, 3),
            loss=z(n), grad_norm=z(n), converged=np.ones(n, bool),
            n_iters=np.ones(n, np.int32), status=np.ones(n, np.int32),
            meta=ScalingMeta(
                y_scale=np.ones(n), floor=z(n), ds_start=z(n),
                ds_span=np.ones(n), reg_mean=z(n, 1),
                reg_std=np.ones((n, 1)), changepoints=z(n, 2)),
        )

    out = str(tmp_path)
    st = fake(4)
    orchestrate.save_chunk_atomic(out, 0, 4, st)
    orchestrate.save_chunk_atomic(out, 5, 8, fake(3))
    report = orchestrate._write_quarantine_placeholders(
        out, [4], "test poison", ResilienceReport())
    assert report.quarantined_indices == (4,)
    assembled = orchestrate.load_fit_state(out, 8)
    assert torch.isnan(assembled.theta[4]).all()
    assert np.asarray(assembled.status)[4] == STATUS_QUARANTINED
    assert not np.asarray(assembled.converged)[4]
    np.testing.assert_array_equal(assembled.theta[:4].numpy(),
                                  st.theta.numpy())
    z = np.load(orchestrate._chunk_path(out, 4, 5))
    assert z["phase2"] == 1 and z["quarantined"] == 1


# -- degradation: loud, and only when allowed -------------------------------


def test_spawn_always_failing_degrades_to_scipy(tmp_path, monkeypatch):
    """Every spawn fails (zero progress ever): the fit bisects, reads the
    failures as environmental and degrades to the scipy backend with ONE
    ResilienceWarning and a report that says so."""
    ds, y, mask = _batch(series=12)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "worker_spawn", attempts=10_000, mode="flag")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with warnings_mod.catch_warnings(record=True) as caught:
        warnings_mod.simplefilter("always")
        got = _fit(tmp_path, "s", ds, y, mask,
                   retry_policy=RetryPolicy(max_attempts=2,
                                            base_delay_s=0.05),
                   max_quarantine=2)
    monkeypatch.delenv(faults.ENV_VAR)
    degr = [w for w in caught if issubclass(w.category, ResilienceWarning)]
    assert len(degr) == 1 and "DEGRADING" in str(degr[0].message)
    report = get_report(got)
    assert report.degraded_to_cpu
    assert any("DEGRADING" in w for w in report.warnings)
    assert tuple(got.theta.shape)[0] == 12
    assert np.isfinite(np.asarray(got.loss)).all()
    assert torch.isfinite(got.theta).all()
    assert np.asarray(got.converged).sum() >= 8


def test_degrade_disabled_raises(tmp_path, monkeypatch):
    ds, y, mask = _batch(series=8)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "worker_spawn", attempts=10_000, mode="flag")
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    with pytest.raises(orchestrate.WorkerCrashLoopError):
        _fit(tmp_path, "s", ds, y, mask,
             retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.05),
             max_quarantine=1, degrade_to_cpu=False)


def test_run_resilient_gives_up_on_deterministic_failure(tmp_path,
                                                         monkeypatch):
    """A child that dies with ZERO progress every attempt (the data dir
    does not exist) raises after max_fruitless_retries."""
    out_dir = str(tmp_path / "out")
    orchestrate.save_run_config(out_dir, _model_config(),
                                SolverConfig(max_iters=10))
    monkeypatch.setenv("TSSPARK_TEST_CRASH_AFTER", "0")
    with pytest.raises(RuntimeError, match="consecutive"):
        orchestrate.run_resilient(
            data_dir=str(tmp_path / "no_such_data"), out_dir=out_dir,
            series=64, chunk=32, min_chunk=32, segment=0, phase1_iters=0,
            deadline=None, progress_timeout=120.0, device="cpu",
            max_fruitless_retries=1,
            retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.05),
        )


def test_slow_kernel_build_does_not_get_its_worker_killed(
        tmp_path, monkeypatch, reference):
    """A kernel-library load that outlasts the stall allowance (a stub
    build: the ``kernel_build`` point sleeping 11 s against a 5 s
    ``progress_timeout``, the watchdog looking every 0.5 s; the worker
    beats from its own start, so that steady allowance is the one in
    force during the load) heartbeats through it: the worker is never
    killed, no retry is spent, and the result is the clean run's bits.
    The allowance leaves room for the work from the load's end to the
    first chunk's result (2.7 s on a host running the whole test suite
    beside it)."""
    ds, y, mask, ref = reference
    monkeypatch.setattr(orchestrate, "WATCH_POLL_S", 0.5)
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults")).fail(
        "kernel_build", attempts=1, mode="sleep", delay_s=11.0)
    monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
    got = _fit(tmp_path, "s", ds, y, mask, progress_timeout=5.0)
    monkeypatch.delenv(faults.ENV_VAR)
    out_dir = str(tmp_path / "s" / "out")
    with open(os.path.join(out_dir, "spawns.jsonl")) as fh:
        spawns = [json.loads(line) for line in fh]
    assert [s["rc"] for s in spawns] == [0]
    assert spawns[0]["end_unix"] - spawns[0]["spawn_unix"] >= 11.0
    assert get_report(got).retries == 0
    with open(os.path.join(out_dir, "times.jsonl")) as fh:
        first = json.loads(fh.readline())
    assert first["kernels"]["seconds"] >= 11.0
    _same(got, ref)


# -- the backend's gate ------------------------------------------------------


def _gate_backend(tmp_path, name, **kw):
    opts = {"scratch_dir": str(tmp_path / name), "phase1_iters": 4,
            "no_phase1_tune": True, "retry_policy": FAST_RETRY}
    return CudaBackend(_model_config(), SolverConfig(max_iters=60),
                       chunk_size=16, device="cpu", resilient=True,
                       resilient_opts=opts, **kw)


def test_resilient_gate_routes_and_warns_once(tmp_path, monkeypatch,
                                              reference):
    """An eligible batch routes to ``fit_resilient`` on the backend's
    device: the first fit warns that rescue / length buckets are
    ignored, the second stays quiet; both carry the note on their report
    and equal the direct ``fit_resilient`` run's bits."""
    ds, y, mask, ref = reference
    monkeypatch.setattr(cuda_mod, "_RESILIENT_GATE_WARNED", False)
    with pytest.warns(ResilienceWarning, match="two-phase worker path"):
        state = _gate_backend(tmp_path, "a").fit(ds, y, mask=mask)
    assert any("rescue" in w for w in get_report(state).warnings)
    _same(state, ref)
    with warnings_mod.catch_warnings():
        warnings_mod.simplefilter("error", ResilienceWarning)
        state2 = _gate_backend(tmp_path, "b").fit(ds, y, mask=mask)
    assert any("rescue" in w for w in get_report(state2).warnings)


@pytest.mark.parametrize("case,check", [
    ("fractional_mask", "not packable"),
    ("ds_2d", "not packable"),
    ("init", "warm start (init=)"),
    ("conditions", "conditions="),
])
def test_resilient_gate_falls_back_with_the_failed_check(
        tmp_path, monkeypatch, case, check):
    """An ineligible batch falls back to the in-process fit (no worker is
    spawned) with one warning naming the failed eligibility check."""
    called = {"n": 0}
    monkeypatch.setattr(orchestrate, "fit_resilient",
                        lambda *a, **k: called.update(n=1))
    monkeypatch.setattr(cuda_mod, "_RESILIENT_FALLBACK_WARNED", False)
    ds, y, mask = _batch(series=6, days=64)
    kw, cfg = {"mask": mask}, _model_config()
    if case == "fractional_mask":
        kw["mask"] = np.full_like(mask, 0.5)
    elif case == "ds_2d":
        ds = np.broadcast_to(ds, y.shape).copy()
    elif case == "init":
        kw["init"] = np.zeros((6, cfg.num_params), np.float32)
    else:
        cfg = ProphetConfig(
            seasonalities=(SeasonalityConfig("weekly", 7.0, 3,
                                             condition_name="on"),),
            n_changepoints=6)
        kw["conditions"] = {"on": np.ones_like(y)}
    bk = CudaBackend(cfg, SolverConfig(max_iters=20), chunk_size=16,
                     device="cpu", resilient=True,
                     resilient_opts={"scratch_dir": str(tmp_path / "s")})
    with pytest.warns(ResilienceWarning, match="INELIGIBLE") as rec:
        state = bk.fit(ds, y, **kw)
    assert check in str(rec[0].message)
    assert called["n"] == 0
    assert np.isfinite(np.asarray(state.loss)).all()
    assert not os.path.exists(str(tmp_path / "s"))


# -- no silent CPU ----------------------------------------------------------


def test_no_card_and_no_request_raises(tmp_path, monkeypatch):
    """Without a card, ``fit_resilient`` with no device request raises at
    once (nothing spilled, nothing spawned), and so does a worker."""
    import argparse

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, y, mask = _batch(series=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orchestrate.fit_resilient(
            _model_config(), SolverConfig(max_iters=10), ds, y, mask=mask,
            scratch_dir=str(tmp_path / "s"))
    assert not os.path.exists(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orchestrate.run_resilient(data_dir=str(tmp_path), out_dir=str(
            tmp_path / "o"), series=8)
    args = argparse.Namespace(data=str(tmp_path), out=str(tmp_path),
                              lo=0, hi=8, chunk=16, segment=0, series=8,
                              phase1_iters=4, no_phase1_tune=True,
                              device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orchestrate.fit_worker(args)


_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["tsspark_tpu"] = None  # and so does the JAX package
from tsspark_tpu_torch import orchestrate
rc = orchestrate._worker_main(["--_fit"] + sys.argv[1:])
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "tsspark_tpu"))]
print(json.dumps({"rc": rc, "bad": bad}))
"""


def test_worker_child_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fit worker child started with jax and the JAX package blocked
    fits its whole range (both phases) and loads neither."""
    ds, y, mask = _batch(series=32, days=96)
    data_dir, out_dir = str(tmp_path / "data"), str(tmp_path / "out")
    orchestrate.spill_data(data_dir, ds, y, mask=mask)
    orchestrate.save_run_config(out_dir, _model_config(),
                                SolverConfig(max_iters=40))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "--data", data_dir, "--out", out_dir,
         "--lo", "0", "--hi", "32", "--chunk", "16", "--series", "32",
         "--phase1-iters", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "bad": []}
    assert os.path.exists(os.path.join(out_dir, "phase2_done"))
    orchestrate.load_fit_state(out_dir, 32)


def test_reports_ride_the_state_and_pickle_to_the_base_fitstate():
    """The resilience report and the perf report ride one annotated
    state (attaching one keeps the other; re-annotation reuses the
    class); pickling rebuilds the plain FitState, reports dropped."""
    import pickle

    from tsspark_tpu_torch.models.prophet.design import ScalingMeta
    from tsspark_tpu_torch.models.prophet.model import FitState
    from tsspark_tpu_torch.perf import PerfRecorder, attach_perf, get_perf
    from tsspark_tpu_torch.resilience.report import (
        add_warning,
        attach_report,
    )

    z = lambda *s: np.zeros(s)  # noqa: E731
    st = FitState(theta=torch.ones(3, 2), loss=z(3), grad_norm=z(3),
                  converged=np.ones(3, bool), n_iters=np.ones(3, np.int32),
                  status=np.ones(3, np.int32),
                  meta=ScalingMeta(np.ones(3), z(3), z(3), np.ones(3),
                                   z(3, 1), np.ones((3, 1)), z(3, 2)))
    rec = PerfRecorder()
    with rec.dispatch(width=32, live=3, kind="chunk"):
        pass
    rec.record(32, 0.5, live=2, compile_miss=True)
    ann = attach_perf(attach_report(st, ResilienceReport(warnings=("w",))),
                      rec.report())
    assert get_report(ann).warnings == ("w",)
    perf = get_perf(ann)
    assert perf.compile_misses == 1 and perf.widths == (32, 32)
    assert perf.to_dict(3)["n_dispatches"] == 2
    ann2 = add_warning(ann, "again")
    assert type(ann2) is type(ann)
    assert get_report(ann2).warnings == ("w", "again")
    assert get_perf(ann2) is perf
    back = pickle.loads(pickle.dumps(ann2))
    assert type(back) is FitState
    assert torch.equal(back.theta, st.theta)
