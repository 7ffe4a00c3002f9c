"""The port's always-on refit scheduler (``tsspark_tpu_torch.sched``) on the
CPU: the pipelined loop, speculative warm prep, freshness, crash resume
and the disk-pressure ladder, each a counterpart of a test in
``tests/test_sched.py``; then the loop against the JAX package's.

Sizes are the reference tests': the ``demo_weekly`` plane dataset, 24
series x 64 days in 8-row shards, 8-row waves, 20 solver iterations, on
the virtual host mesh of 8 CPU entries.

The counterpart of ``test_freshness_spans_reach_obs_watch`` is in
``tests/test_torch_ledger.py``, beside the port's ``obs/watch.py``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tsspark_tpu_torch import orchestrate, refit, resident, sched
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
#: Every loop run here is bounded: a stuck loop fails, never hangs.
RUN_S = 120.0


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
    assert st["complete"]
    reg = ParamRegistry(str(tmp_path / "registry"), CFG)
    v1 = orchestrate.publish_fit_state(
        reg, out, ids, data_stamp=plane.delta_seq(dset)
    )
    return spec, dset, reg, ids, v1


def _loop(dset, reg, scratch, **kw):
    kw.setdefault("solver_config", SOLVER)
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("debounce_s", 0.0)
    return sched.RefitScheduler(dset, reg, str(scratch), chunk=CHUNK,
                                device="cpu", **kw)


def _engine_loop(tmp_path, reg, ids, **kw):
    """A scheduler wired to an in-process engine: flips go through the
    prefetch / materialize / activate path, freshness probes are real
    served requests."""
    engine = PredictionEngine(reg, cache=ForecastCache(256), device="cpu")
    hot = [str(s) for s in ids[:8]]
    engine.materialize(hot, (7,))

    def flip_fn(v):
        engine.prefetch(v)
        engine.materialize(hot, (7,), version=v)
        reg.activate(v)

    def probe(v):
        return engine.forecast([hot[0]], 7).version

    dset = kw.pop("dset")
    loop = _loop(dset, reg, tmp_path / "sched", flip_fn=flip_fn,
                 freshness_probe=probe, poll_s=0.02, debounce_s=0.02,
                 spec_refresh_s=0.05, **kw)
    return loop, engine


def _vdir(reg, v):
    return reg.version_dir(int(v))


def _unchanged_bytes_differ(reg, v_base, v_new, changed) -> list:
    """Names of the new version's snapshot / forecast / quantile columns
    whose unchanged rows differ from the base's bytes."""
    keep = np.setdiff1d(np.arange(N), np.asarray(changed, np.int64))
    bad = []
    for name in sorted(os.listdir(_vdir(reg, v_new))):
        if not (name.endswith(".npy") and name.startswith(
                ("snapcol_", "fcol_", "qcol_"))):
            continue
        base = os.path.join(_vdir(reg, v_base), name)
        if not os.path.exists(base):
            continue
        a = np.load(base, mmap_mode="r")
        b = np.load(os.path.join(_vdir(reg, v_new), name), mmap_mode="r")
        if a.shape[0] != N:
            continue  # a per-version column (ids are checked by name)
        if not np.array_equal(np.asarray(a[keep]), np.asarray(b[keep])):
            bad.append(name)
    return bad


def _theta(reg, v):
    return np.array(np.load(os.path.join(_vdir(reg, v),
                                         "snapcol_theta.npy"),
                            mmap_mode="r"))


# ---------------------------------------------------------------------------
# idle discipline
# ---------------------------------------------------------------------------


def test_idle_ticks_never_publish(tmp_path, monkeypatch):
    """Zero-delta idle ticks publish no version, write no RUNHISTORY and
    grow no snapshot dir."""
    monkeypatch.chdir(tmp_path)
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    versions_before = reg.versions()
    snap_dirs = sorted(os.listdir(reg.root))
    loop = _loop(dset, reg, tmp_path / "sched", spec_refresh_s=0.02)
    summary = loop.run(duration_s=0.4)
    assert summary["cycles"] == 0
    assert reg.versions() == versions_before
    assert sorted(os.listdir(reg.root)) == snap_dirs
    assert not os.path.exists(str(tmp_path / "RUNHISTORY.jsonl"))
    state = sched.read_sched_state(str(tmp_path / "sched"))
    assert state is not None and state["cycles"] == 0


# ---------------------------------------------------------------------------
# the loop end to end
# ---------------------------------------------------------------------------


def test_pipelined_stream_serves_fresh_versions(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    loop, engine = _engine_loop(tmp_path, reg, ids, dset=dset,
                                pipeline=True)
    seq0 = plane.delta_seq(dset)

    def lander():
        for _ in range(3):
            plane.land_synthetic_delta(dset, 0.2)
            time.sleep(0.6)

    t = threading.Thread(target=lander, daemon=True)
    t.start()
    summary = loop.run(until_stamp=seq0 + 3, duration_s=RUN_S)
    t.join(timeout=RUN_S)
    assert summary["ok"], summary
    assert summary["cycles"] >= 1
    assert summary["fit_path"] == "resident"
    assert summary["freshness"]["n"] == 3
    assert summary["freshness"]["p95_s"] > 0
    assert summary["wrong_version"] == 0
    assert summary["pending_deltas"] == 0
    v_final = summary["head_version"]
    assert reg.active_version() == v_final
    assert reg.version_stamp(v_final) == seq0 + 3
    # Copy-forward parity on the final hop: unchanged rows are the
    # base's bytes, the changed rows moved.
    info = reg.delta_info(v_final)
    assert _unchanged_bytes_differ(reg, info["base_version"], v_final,
                                   info["changed_rows"]) == []
    rows = np.asarray(info["changed_rows"], np.int64)
    assert not np.array_equal(_theta(reg, info["base_version"])[rows],
                              _theta(reg, v_final)[rows])
    assert engine.forecast([str(ids[0])], 7).version == v_final


def _stream_bits(root, pipeline: bool):
    spec, dset, reg, ids, v1 = _setup(root)
    loop = _loop(dset, reg, root / "sched", pipeline=pipeline,
                 spec_refresh_s=0.02)
    seq = plane.delta_seq(dset)
    for _ in range(2):
        plane.land_synthetic_delta(dset, 0.2)
        seq += 1
        s = loop.run(until_stamp=seq, duration_s=RUN_S)
        assert s["ok"], s
    return _theta(reg, reg.active_version())


def test_pipelined_and_serialized_converge_bitwise(tmp_path):
    """The pipeline (and its carry / speculation theta cache) is a
    latency lever, never a numerics input: the same delta stream lands
    bitwise-identical parameters either way."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = _stream_bits(tmp_path / "a", True)
    b = _stream_bits(tmp_path / "b", False)
    assert np.array_equal(a, b)


def test_scheduler_cli_resumes_after_flip_kill(tmp_path, monkeypatch):
    """The CLI daemon (``--device cpu``) dies at an armed ``sched_flip``
    exit fault (version published, flip pending, plan incomplete); a
    successor resumes the pinned plan with ZERO new fit dispatches, one
    cycle, and lands the child's bits."""
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    scratch = str(tmp_path / "sched")
    plan = faults.FaultPlan(state_dir=str(tmp_path / "faults"))
    plan.fail("sched_flip", attempts=1, after=0, mode="exit", rc=29,
              tag="loop-storm")
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env[faults.ENV_VAR] = plan.to_env()
    env.pop(tmesh.HOST_MESH_ENV, None)  # the CLI forces it for --device cpu
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.sched",
         "--data", dset, "--registry", reg.root, "--scratch", scratch,
         "--chunk", str(CHUNK), "--max-iters", str(SOLVER.max_iters),
         "--until-stamp", "1", "--duration", "120",
         "--poll", "0.02", "--debounce", "0.02", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 29, proc.stderr[-2000:]
    assert reg.active_version() == v1  # the kill never half-flipped
    plan_rec = refit.read_refit_plan(scratch)
    assert plan_rec is not None and not plan_rec.get("complete")
    _c, _d, out_dir = refit.cycle_paths(scratch, plan_rec)
    landed = orchestrate.load_fit_state(out_dir, plan_rec["n_changed"])
    resumes = []
    real = refit.run_refit

    def recording(**kw):
        res = real(**kw)
        resumes.append(res)
        return res

    monkeypatch.setattr(refit, "run_refit", recording)
    loop = _loop(dset, reg, scratch, poll_s=0.02)
    summary = loop.run(until_stamp=1, duration_s=RUN_S)
    assert summary["ok"], summary
    assert summary["resumed_cycles"] == 1
    assert summary["cycles"] == 1
    assert summary["freshness"]["n"] == 1
    assert len(resumes) == 1 and resumes[0]["fit_dispatches"] == 0
    v2 = summary["head_version"]
    assert reg.active_version() == v2 and v2 != v1
    assert reg.version_stamp(v2) == 1
    rows = np.asarray(reg.delta_info(v2)["changed_rows"], np.int64)
    np.testing.assert_array_equal(_theta(reg, v2)[rows],
                                  landed.theta.numpy())


def test_resume_of_plan_based_on_unflipped_version(tmp_path):
    """A front elsewhere owns the flip (activate=False): a successor
    resumes a pinned plan against the plan's OWN base."""
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    scratch = tmp_path / "sched"
    plane.land_synthetic_delta(dset, 0.2)
    s1 = _loop(dset, reg, scratch, activate=False).run(
        until_stamp=1, duration_s=RUN_S)
    assert s1["ok"], s1
    v2 = s1["head_version"]
    assert reg.active_version() == v1 and v2 != v1  # never flipped
    plane.land_synthetic_delta(dset, 0.2)
    plan = refit.pin_drafted(str(scratch), refit.draft_plan(dset, 1), v2)
    d2_rows = set(plan["changed_rows"])
    s2 = _loop(dset, reg, scratch, activate=False).run(
        until_stamp=2, duration_s=RUN_S)
    assert s2["ok"], s2
    assert s2["resumed_cycles"] == 1
    info = reg.delta_info(s2["head_version"])
    assert info["base_version"] == v2
    assert set(info["changed_rows"]) == d2_rows


def test_publish_failure_is_retried_in_process(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    calls = {"n": 0}

    def flaky_flip(v):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient flip outage")
        reg.activate(v)

    plane.land_synthetic_delta(dset, 0.2)
    loop = _loop(dset, reg, tmp_path / "sched", flip_fn=flaky_flip,
                 backoff_base_s=0.05)
    summary = loop.run(until_stamp=1, duration_s=RUN_S)
    assert summary["ok"], summary
    assert summary["failures"] == 1 and calls["n"] == 2
    assert summary["cycles"] == 1
    v = summary["head_version"]
    assert reg.active_version() == v and reg.version_stamp(v) == 1
    assert summary["pending_deltas"] == 0


def test_freshness_bench_cli_writes_its_reports(tmp_path):
    """``python -m tsspark_tpu_torch.sched --freshness-bench smoke
    --device cpu``: both loop modes on the CPU's host mesh, exit 0
    (``refit.sweep_ok``), a ``BENCH_freshness_*`` report a mode in the
    working directory with zero wrong-version answers."""
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    env["TMPDIR"] = str(tmp_path / "tmp")
    env["TSSPARK_SENTINEL"] = "0"
    os.makedirs(env["TMPDIR"])
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.sched",
         "--freshness-bench", "smoke", "--device", "cpu"],
        cwd=str(cwd), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    reports = sorted(os.listdir(cwd))
    assert [r.split("_")[3] for r in reports] == ["pipelined",
                                                 "serialized"]
    for name in reports:
        with open(cwd / name) as fh:
            rep = json.load(fh)
        assert rep["complete"] and rep["wrong_version"] == 0
        assert rep["device"] == "cpu"


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------


def test_arrival_model_predicts_recurring_rows():
    model = sched.ArrivalModel(alpha=0.5)
    hot = [3, 7, 11]
    t0 = 1000.0
    for seq in range(1, 6):
        model.note_delta(seq, t0 + 5.0 * seq, np.asarray(hot + [17 + seq]))
    assert set(model.predicted_rows(cap=3).tolist()) == set(hot)
    tracked = model.tracked()
    model.note_delta(5, t0 + 25.0, np.asarray(hot))
    assert model.tracked() == tracked
    small = sched.ArrivalModel(max_tracked=4)
    small.note_delta(1, t0, np.arange(10))
    small.note_delta(2, t0 + 1, np.arange(10, 20))
    assert small.tracked() <= 4


def test_speculative_cache_hits_are_counted(tmp_path):
    spec, dset, reg, ids, v1 = _setup(tmp_path)
    hot_rows = np.asarray([1, 5, 9, 13], np.int64)
    loop, engine = _engine_loop(tmp_path, reg, ids, dset=dset)
    seq = plane.delta_seq(dset)
    for _ in range(3):
        plane.land_synthetic_delta(dset, 0.2, rows=hot_rows)
        seq += 1
        s = loop.run(until_stamp=seq, duration_s=RUN_S)
        assert s["ok"], s
        loop.run(duration_s=0.15)  # an idle tick refreshes speculation
    stats = loop.spec_summary()
    assert stats["predicted"] > 0 and stats["hits"] > 0
    assert stats["hit_rate"] > 0


def test_warm_theta_cache_is_bitwise_the_plane_gather(tmp_path):
    """fit_changed with a theta cache consumes exactly the bytes the
    per-wave plane gather would: speculation never changes an init."""
    from tsspark_tpu_torch.serve import snapplane

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    changed = plane.advanced_since(dset, 0)
    view = snapplane.attach(reg.version_dir(v1), verify=False)
    want = refit.warm_theta_gather(view.state.theta, changed)
    half = changed[: len(changed) // 2]
    cache = {"base_stamp": 0, "rows": half,
             "theta": np.asarray(
                 refit.warm_theta_gather(view.state.theta, half))}
    plan = refit.draft_plan(dset, 0, base_version=v1)
    kw = dict(chunk=CHUNK, solver_config=SOLVER, warm_start=True,
              device="cpu")
    r_cache = refit.fit_changed(dset, reg, plan, str(tmp_path / "scr"),
                                theta_cache=cache, **kw)
    assert r_cache["complete"] and r_cache["warm_cache_hits"] > 0
    r_plain = refit.fit_changed(dset, reg, plan, str(tmp_path / "scr2"),
                                **kw)
    assert np.array_equal(np.asarray(r_cache["state_sub"].theta),
                          np.asarray(r_plain["state_sub"].theta))
    assert np.asarray(want).dtype == np.float32


# ---------------------------------------------------------------------------
# freshness metric / history / SLO wiring
# ---------------------------------------------------------------------------


def test_freshness_rows_get_mode_scoped_workload_keys():
    from tsspark_tpu_torch.obs import history

    rep = {
        "kind": "freshness-bench", "unix": 1.0, "trace_id": "t9",
        "device": "cpu", "rung": "smoke", "mode": "pipelined",
        "churn": 0.05, "complete": True,
        "freshness_p50_s": 0.4, "freshness_p95_s": 0.9,
        "freshness_vs_cold_frac": 0.2, "cycle_overhead_frac": 0.5,
        "spec_hit_rate": 0.3, "cycles": 6, "wrong_version": 0,
        "cold_wall_s": 4.0, "wall_s": 12.0,
    }
    row = history.row_from_report(rep)
    assert row["kind"] == "freshness"
    assert row["workload"] == "freshness_smoke_c0050+pipelined"
    for k in ("freshness_p95_s", "cycle_overhead_frac",
              "spec_hit_rate", "wrong_version"):
        assert k in row["metrics"], k
    ser = history.row_from_report(dict(rep, mode="serialized"))
    assert ser["workload"] != row["workload"]


def test_freshness_slo_budgets_declared_everywhere():
    from tsspark_tpu_torch.obs import regress

    for table in (regress.DEFAULT_SLO["budgets"]["freshness"],
                  regress.load_slo()["budgets"]["freshness"]):
        assert table["freshness_p95_s"]["direction"] == "lower"
        assert table["cycle_overhead_frac"]["direction"] == "lower"
        assert table["spec_hit_rate"]["direction"] == "higher"


def test_freshness_spans_reach_the_runs_spans_file(tmp_path):
    """Each delta a published version covers leaves one
    ``refit.freshness`` span (its seq, the version, probe "serve") in the
    run's spans file, and their durations are the summary's samples."""
    from tsspark_tpu_torch.obs import context as obs

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    loop, engine = _engine_loop(tmp_path, reg, ids, dset=dset)
    spans = str(tmp_path / "spans" / "spans.jsonl")
    prev = obs.start_run(spans)
    try:
        for _ in range(2):
            plane.land_synthetic_delta(dset, 0.2)
        summary = loop.run(until_stamp=2, duration_s=RUN_S)
    finally:
        obs.end_run(prev)
    assert summary["ok"], summary
    recs = [r for r in obs.read_records(spans)
            if r.get("name") == "refit.freshness"]
    assert sorted(r["attrs"]["seq"] for r in recs) == [1, 2]
    assert {r["attrs"]["probe"] for r in recs} == {"serve"}
    assert {r["attrs"]["version"] for r in recs} == {
        summary["head_version"]}
    durs = sorted(r["dur_s"] for r in recs)
    want = sorted(fr for _seq, fr in loop.freshness)
    np.testing.assert_allclose(durs, want, rtol=0, atol=1e-5)
    assert sched.read_sched_state(str(tmp_path / "sched"))[
        "freshness"]["n"] == 2


def test_cache_carried_metric_exported():
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

    cache = ForecastCache(16)
    for i in range(4):
        cache.put((1, f"s{i}", 8, 0, 0), {"row": i})
    before = METRICS.counter("tsspark_serve_cache_carried").value
    assert cache.carry_forward(1, 2, {"s0"}) == 3
    assert METRICS.counter("tsspark_serve_cache_carried").value \
        == before + 3


# ---------------------------------------------------------------------------
# the disk-pressure degradation ladder
# ---------------------------------------------------------------------------


def test_idle_tick_sheds_speculation_and_reaps_under_pressure(
        tmp_path, monkeypatch):
    from tsspark_tpu_torch.io import atomic_write_text, current_state
    from tsspark_tpu_torch.io import budget as iobudget

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    scratch = str(tmp_path / "sched")
    loop = _loop(dset, reg, scratch, poll_s=0.0, spec_refresh_s=0.0)
    calls = []
    monkeypatch.setattr(loop, "_refresh_speculation",
                        lambda: calls.append(1))
    stale = os.path.join(scratch, "cycle_b000001_s000002")
    os.makedirs(stale, exist_ok=True)
    atomic_write_text(os.path.join(stale, "spill.bin"), "x" * 4096)
    loop._idle_tick()
    assert calls == [1] and os.path.isdir(stale)
    used = iobudget.DiskBudget(scratch).used_bytes()
    monkeypatch.setenv(iobudget.ENV_BUDGET_ROOT, scratch)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, str(max(1, used)))
    loop._idle_tick()
    assert calls == [1]  # speculation shed
    assert not os.path.exists(stale)  # history reaped
    loop._write_sched_state()
    assert sched.read_sched_state(scratch)["disk_ladder"] in (
        "shed_spec", "reap", "pause_ingest", "stale_serve")
    monkeypatch.delenv(iobudget.ENV_BUDGET_ROOT)
    monkeypatch.delenv(iobudget.ENV_BUDGET_BYTES)
    loop._idle_tick()
    assert calls == [1, 1]
    assert current_state(scratch) == "normal"


def test_tick_pauses_refit_intake_at_pause_ingest(tmp_path, monkeypatch):
    from tsspark_tpu_torch.io import atomic_write_text
    from tsspark_tpu_torch.io import budget as iobudget

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    plane.land_synthetic_delta(dset, 0.25)
    scratch = str(tmp_path / "sched")
    loop = _loop(dset, reg, scratch, poll_s=0.0, spec_refresh_s=1e9)
    loop._startup_resume()
    assert loop._pending
    real_draft = refit.draft_plan
    os.makedirs(scratch, exist_ok=True)
    atomic_write_text(os.path.join(scratch, "ballast"), "b" * 4096)
    used = iobudget.DiskBudget(scratch).used_bytes()
    monkeypatch.setenv(iobudget.ENV_BUDGET_ROOT, scratch)
    monkeypatch.setenv(iobudget.ENV_BUDGET_BYTES, str(max(1, used)))
    monkeypatch.setattr(
        refit, "draft_plan",
        lambda *a, **k: pytest.fail("drafted a cycle under pause_ingest"))
    loop._tick()
    assert loop._pending and loop.failures == 0
    monkeypatch.delenv(iobudget.ENV_BUDGET_ROOT)
    monkeypatch.delenv(iobudget.ENV_BUDGET_BYTES)
    drafted = []

    def record_draft(*a, **k):
        drafted.append(1)
        return real_draft(*a, **k)

    monkeypatch.setattr(refit, "draft_plan", record_draft)
    loop._tick()
    loop._join_publisher(block=True)
    assert drafted


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_arrival_model_against_the_jax_packages():
    """The same ``note_delta`` stream (repeats, evictions, a row seen
    once) through both packages' models: the same predicted and overdue
    rows, the same overdue seconds."""
    from tsspark_tpu import sched as jsched

    rng = np.random.default_rng(5)
    models = [sched.ArrivalModel(alpha=0.3, max_tracked=40),
              jsched.ArrivalModel(alpha=0.3, max_tracked=40)]
    t = 1000.0
    for seq in range(1, 30):
        t += float(rng.uniform(0.5, 3.0))
        rows = rng.choice(60, size=int(rng.integers(1, 12)), replace=False)
        for m in models:
            m.note_delta(seq, t, rows)
            m.note_delta(seq, t + 1.0, rows[:1])  # a replayed seq: no-op
    a, b = models
    assert a.seen_seq() == b.seen_seq() and a.tracked() == b.tracked()
    for cap in (0, 1, 7, 40, 100):
        np.testing.assert_array_equal(a.predicted_rows(cap),
                                      b.predicted_rows(cap))
    for now, k in ((t, 3.0), (t + 20.0, 3.0), (t + 5.0, 0.5)):
        assert a.overdue_rows(now, k=k) == b.overdue_rows(now, k=k)


def test_refit_loop_against_the_jax_packages_loop(tmp_path):
    """Both packages' ``RefitScheduler`` on copies of one plane and
    registry (v1 with an ADVI posterior), each on its 8-entry mesh, the
    same two deltas landed one at a time: the same plans (changed rows,
    base and plan stamps, versions), the refit rows' loss and theta at
    rtol 1e-3 / atol 1e-2 (``test_torch_refit.py``'s cross-package
    tolerance, at its converged depth of 120 iterations), and the
    unchanged rows the base's bytes in both."""
    from tsspark_tpu import config as jcfg
    from tsspark_tpu import sched as jsched
    from tsspark_tpu.data import plane as jplane
    from tsspark_tpu.serve.registry import ParamRegistry as JRegistry
    from tsspark_tpu_torch.uncertainty import advi as advi_mod

    spec, dset, reg, ids, v1 = _setup(tmp_path)
    theta = np.asarray(reg.load(v1, fallback=False).state.theta,
                       np.float32)
    advi_mod.save_posterior(
        _vdir(reg, v1),
        advi_mod.AdviPosterior(mu=theta, rho=np.full_like(theta, -3.0),
                               elbo=np.zeros(N, np.float32)),
        seed=7, num_steps=20)
    jdset = str(tmp_path / "jplane")
    jroot = str(tmp_path / "jregistry")
    shutil.copytree(dset, jdset)
    shutil.copytree(reg.root, jroot)
    deep = 120
    loop = _loop(dset, reg, tmp_path / "sched",
                 solver_config=SolverConfig(max_iters=deep))
    jcf = jcfg.ProphetConfig(
        seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3)
    jloop = jsched.RefitScheduler(
        jdset, JRegistry(jroot, jcf), str(tmp_path / "jsched"),
        chunk=CHUNK, solver_config=jcfg.SolverConfig(max_iters=deep),
        poll_s=0.01, debounce_s=0.0)
    for seq in (1, 2):
        plane.land_synthetic_delta(dset, 0.2)
        jplane.land_synthetic_delta(jdset, 0.2)
        s = loop.run(until_stamp=seq, duration_s=RUN_S)
        js = jloop.run(until_stamp=seq, duration_s=RUN_S)
        assert s["ok"] and js["ok"], (s, js)
        assert s["head_version"] == js["head_version"] == seq + 1
        assert s["head_stamp"] == js["head_stamp"] == seq
    jreg = ParamRegistry(jroot, CFG)  # the port reads either registry
    for v in (2, 3):
        info, jinfo = reg.delta_info(v), jreg.delta_info(v)
        for k in ("base_version", "changed_rows", "n_changed"):
            assert info[k] == jinfo[k], (v, k)
        assert reg.version_stamp(v) == jreg.version_stamp(v) == v - 1
        rows = np.asarray(info["changed_rows"], np.int64)
        got, _ = reg.load(v, fallback=False).take(rows)
        ref, _ = jreg.load(v, fallback=False).take(rows)
        for k in ("loss", "theta"):
            np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                       np.asarray(getattr(ref, k)),
                                       rtol=1e-3, atol=1e-2,
                                       err_msg=f"v{v} {k}")
        for r in (reg, jreg):
            assert _unchanged_bytes_differ(r, v - 1, v, rows) == []


def test_launch_counts_are_exact_under_two_threads():
    """The loop's publisher thread and its main thread launch kernels at
    once; every wrapper counts under ``kernels.COUNT_LOCK``: many threads
    counting with a short switch interval lose no count."""
    from tsspark_tpu_torch.kernels import advi, bands, draws, fan, forward
    from tsspark_tpu_torch.kernels import loss as lk

    mods = (advi, bands, draws, fan, forward)
    saved = ([m.launches for m in mods],
             (lk.launches, lk.grad_launches, lk.stack_launches))
    interval = sys.getswitchinterval()
    n_threads, per = 16, 2000

    def work():
        for i in range(per):
            for m in mods:
                m._count()
            lk._count(i % 2 == 0, True)

    try:
        for m in mods:
            m.launches = 0
        lk.launches = lk.grad_launches = lk.stack_launches = 0
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RUN_S)
        assert not any(t.is_alive() for t in threads)
        total = n_threads * per
        assert [m.launches for m in mods] == [total] * len(mods)
        assert (lk.launches, lk.grad_launches, lk.stack_launches) == (
            total, total // 2, total)
    finally:
        sys.setswitchinterval(interval)
        for m, v in zip(mods, saved[0]):
            m.launches = v
        lk.launches, lk.grad_launches, lk.stack_launches = saved[1]


def test_a_delta_landing_mid_spill_waits_for_it(tmp_path, monkeypatch):
    """A lander racing a cycle's spill (it scatters its rows into the
    plane before its record) waits on the landers' lock the detect and
    spill hold: the cycle's version is bitwise the one a world where the
    racing delta never landed publishes."""
    rows = np.arange(0, N, 2)
    worlds = {}
    for name in ("raced", "alone"):
        root = tmp_path / name
        root.mkdir()
        spec, dset, reg, ids, v1 = _setup(root)
        plane.land_synthetic_delta(dset, 0.0, rows=rows)
        worlds[name] = (dset, reg, root)
    dset, reg, root = worlds["raced"]
    real = refit.ensure_spill
    landers = []

    def racing(data_dir, plan, scratch):
        if not landers:
            t = threading.Thread(
                target=plane.land_synthetic_delta, args=(dset, 0.0),
                kwargs={"rows": rows, "seed": 5})
            t.start()
            landers.append(t)
            time.sleep(0.5)  # the lander's scatter would land by now
        return real(data_dir, plan, scratch)

    monkeypatch.setattr(refit, "ensure_spill", racing)
    s = _loop(dset, reg, root / "sched", pipeline=False).run(
        until_stamp=1, duration_s=RUN_S)
    landers[0].join(timeout=RUN_S)
    assert not landers[0].is_alive() and plane.delta_seq(dset) == 2
    monkeypatch.setattr(refit, "ensure_spill", real)
    dset_b, reg_b, root_b = worlds["alone"]
    s_b = _loop(dset_b, reg_b, root_b / "sched", pipeline=False).run(
        until_stamp=1, duration_s=RUN_S)
    assert s["ok"] and s_b["ok"], (s, s_b)
    assert reg.version_stamp(2) == reg_b.version_stamp(2) == 1
    np.testing.assert_array_equal(_theta(reg, 2), _theta(reg_b, 2))
