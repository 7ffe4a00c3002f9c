"""The port's benches on the CPU, held against the JAX package's: the scale
ladder's smoke rung (``tsspark_tpu_torch.bench_scale``), the delta,
freshness and alert benches (``refit.run_delta_bench``,
``sched.run_freshness_bench``, ``alerts.bench.run_alerts_bench``), the
serve-plane bench (``serve.planebench``) and the calibration bench
(``uncertainty.calibrate.run_uncertainty_bench``).

Each bench runs at the reference's smoke sizes (the ``smoke`` rung: 1,024
series x 64 days, 8 iterations) or a few series, with ``device="cpu"`` on
the virtual host mesh of 8 CPU entries, in a private working directory,
data root and scratch root; each test restores the run bindings it found
in both packages.  The JAX package's reports of the same kind are the
key lists the port's must give; its smoke rung and delta bench run here
too, on the same plane bytes.
"""

import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from tsspark_tpu import bench_scale as jbench_scale
from tsspark_tpu import refit as jrefit
from tsspark_tpu.obs import context as jcontext
from tsspark_tpu.obs import history as jhistory
from tsspark_tpu_torch import bench_scale, orchestrate, refit, sched
from tsspark_tpu_torch.alerts import bench as alerts_bench
from tsspark_tpu_torch.obs import context, history
from tsspark_tpu_torch.parallel import mesh as tmesh
from tsspark_tpu_torch.serve.registry import ParamRegistry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_world(tmp_path, monkeypatch):
    """The virtual host mesh, a private cwd (reports, RUNHISTORY.jsonl),
    no sentinel unless a test asks, and both packages' run bindings
    restored."""
    monkeypatch.setenv(tmesh.HOST_MESH_ENV, "8")
    monkeypatch.setenv("TSSPARK_SENTINEL", "0")
    monkeypatch.chdir(tmp_path)
    before = (context._RUN, jcontext._RUN)
    yield
    context._RUN, jcontext._RUN = before


def _keys(d, pre=""):
    """Every key path of a report (``per_replica`` lists aside)."""
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict):
            out |= _keys(v, pre + k + ".")
    return out


def _committed(pattern):
    paths = sorted(glob.glob(os.path.join(ROOT, pattern)))
    assert paths, f"no committed {pattern} to pin against"
    with open(paths[0]) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# the scale ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", ["smoke", "30k"])
def test_request_mix_is_the_jax_packages(rung):
    ids = np.asarray([f"s{i}" for i in range(
        bench_scale.RUNGS[rung].series)])
    sample, picks = bench_scale._request_mix(bench_scale.RUNGS[rung], ids)
    jsample, jpicks = jbench_scale._request_mix(
        jbench_scale.RUNGS[rung], ids)
    assert np.array_equal(sample, jsample)
    assert picks == jpicks
    assert bench_scale.RUNGS == {
        k: bench_scale.ScaleRung(*tuple(v.__dict__.values()))
        for k, v in jbench_scale.RUNGS.items()}
    assert tuple(bench_scale.LADDER) == tuple(jbench_scale.LADDER)


def test_proc_mem_sums_smaps_where_status_and_rollup_lack_them(
        monkeypatch):
    """A procfs with only ``VmRSS`` in ``status`` and no ``smaps_rollup``
    (a sandboxed kernel's): ``proc_mem`` sums ``Anonymous`` and ``Pss``
    over ``smaps`` instead, which here agree with ``RssAnon`` and the
    rollup's ``Pss`` within 4 MB (the reads are a few lines apart in one
    process)."""
    from tsspark_tpu_torch.utils import procmem

    full = procmem.proc_mem()
    if full["rss_anon_mb"] is None or full["pss_mb"] is None:
        pytest.skip("this kernel's procfs has no RssAnon or smaps_rollup")
    real = procmem._kb_fields

    def bare(path, wanted):
        if path.endswith("smaps_rollup"):
            return {}
        return {k: v for k, v in real(path, wanted).items() if k == "VmRSS"}

    monkeypatch.setattr(procmem, "_kb_fields", bare)
    summed = procmem.proc_mem()
    for key in ("rss_anon_mb", "rss_file_mb", "pss_mb"):
        assert summed[key] is not None
        assert abs(summed[key] - full[key]) <= 4.0, (key, summed, full)


def test_scale_smoke_rung_in_process(tmp_path):
    """The in-process smoke rung: ingest -> the resident fit on the host
    mesh -> mmap publish -> engine serve with a mid-run flip, wired
    through the regression sentinel under the scale-scoped workload
    key (``tests/test_snapshot_plane.py``'s smoke rung)."""
    rep = bench_scale.run_rung(
        "smoke", data_root=str(tmp_path / "plane"),
        scratch_root=str(tmp_path / "scratch"), sentinel=True,
        device="cpu",
    )
    assert rep["complete"], rep
    assert rep["device"] == "cpu"
    assert rep["ingest"]["warm"] is False
    assert rep["fit"]["fit_path"] == "resident"
    assert rep["fit"]["series_done"] == 1024
    assert rep["publish"]["snapshot_mb"] > 0
    serve = rep["serve"]
    assert serve["outcomes"]["failed"] == 0
    assert serve["flip"]["version"] == 2
    assert serve["time_to_first_request_s"] is not None
    assert os.path.exists(rep["path"])
    rows = history.read_history(str(tmp_path / "RUNHISTORY.jsonl"))
    srows = [r for r in rows if r["kind"] == "scale"]
    assert len(srows) == 1
    assert srows[0]["workload"] == "scale_smoke"
    assert srows[0]["device_class"] == "cpu"
    m = srows[0]["metrics"]
    assert m["agg_requests_per_s"] > 0
    assert m["rss_mb_per_replica"] > 0
    assert rep.get("sentinel_ok", True)
    # Re-ingesting the same report is a no-op (idempotent by trace id).
    with open(rep["path"]) as fh:
        row, appended = history.ingest(
            json.load(fh), str(tmp_path / "RUNHISTORY.jsonl"))
    assert row is not None and not appended
    # A second rung over the same data root finds the plane complete.
    again = bench_scale.run_rung(
        "smoke", data_root=str(tmp_path / "plane"),
        scratch_root=str(tmp_path / "scratch2"), device="cpu",
        rss_compare=False,
    )
    assert again["complete"] and again["ingest"]["warm"] is True


#: The smoke rung at the refit cycle test's converged depth (120
#: iterations; most rows still stop early, at FTOL / FLOOR / STALLED).
DEEP_SMOKE = dict(name="smoke", series=1024, timesteps=64, max_iters=120,
                  chunk=512, pool_replicas=0, requests=96, hot=24,
                  sample=256, rss_compare=False)


def test_smoke_rung_against_the_jax_package(tmp_path):
    """Both packages' smoke rungs on the same plane bytes, at the
    converged depth (``DEEP_SMOKE``): the same report keys; every series
    both solvers stop at the same iteration has its loss and theta within
    the refit cycle's cross-package tolerance (rtol 1e-3, atol 1e-2); the
    rows they stop at different iterations part both ways.

    Read on this host: 309 of 1,024 rows stop at the same iteration, all
    within the tolerance; of the rest, 64 part beyond it (up to 2.70 nats,
    8.4e-3 relative), 32 lower in each package; the port's mean loss
    2.6e-3 nats below the JAX package's.  The two float32 solvers stop at
    the noise floor at different points (ROADMAP Queue 3 item 1).  At the
    rung's own 8 iterations 17 rows part (up to 0.92 nats), 11 lower in
    the port."""
    from tsspark_tpu import orchestrate as jorch
    from tsspark_tpu.data import plane as jplane
    from tsspark_tpu_torch.data import plane

    rep = bench_scale.run_rung(
        bench_scale.ScaleRung(**DEEP_SMOKE),
        data_root=str(tmp_path / "plane"),
        scratch_root=str(tmp_path / "scratch"), device="cpu",
    )
    jrep = jbench_scale.run_rung(
        jbench_scale.ScaleRung(**DEEP_SMOKE),
        data_root=str(tmp_path / "jplane"),
        scratch_root=str(tmp_path / "jscratch"), sentinel=False,
    )
    assert rep["complete"] and jrep["complete"]
    assert _keys(rep) == _keys(jrep)
    spec = plane.DatasetSpec("demo_weekly", 1024, 64, seed=2)
    mine = plane.open_batch(plane.dataset_dir(spec, str(tmp_path / "plane")))
    theirs = plane.open_batch(jplane.dataset_dir(
        jplane.DatasetSpec("demo_weekly", 1024, 64, seed=2),
        str(tmp_path / "jplane")))
    assert np.array_equal(np.asarray(mine.y), np.asarray(theirs.y))

    def out_dir(root, fp):
        return os.path.join(root, f"tsscale_smoke_1024x64_{fp}", "out")

    got = orchestrate.load_fit_state(out_dir(
        str(tmp_path / "scratch"), plane.dataset_fingerprint()), 1024)
    want = jorch.load_fit_state(out_dir(
        str(tmp_path / "jscratch"), jplane.dataset_fingerprint()), 1024)
    same = np.asarray(got.n_iters) == np.asarray(want.n_iters)
    assert same.sum() >= 256
    for k in ("loss", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(got, k))[same],
                                   np.asarray(getattr(want, k))[same],
                                   rtol=1e-3, atol=1e-2, err_msg=k)
    d = (np.asarray(got.loss, np.float64)
         - np.asarray(want.loss, np.float64))
    apart = ~np.isclose(np.asarray(got.loss), np.asarray(want.loss),
                        rtol=1e-3, atol=1e-2)
    n = int(apart.sum())
    # Both ways: the port is the worse one on no more rows than a fair
    # coin's two-sigma excess, and no worse on average.
    assert int((d[apart] > 0).sum()) <= n / 2 + np.sqrt(n)
    assert d.mean() <= 0.01
    assert np.isin(np.asarray(got.status)[~same], (2, 3, 4)).all()


# ---------------------------------------------------------------------------
# the stream benches: one cold base, three streams
# ---------------------------------------------------------------------------


def test_parse_churns_and_sweep_ok_are_the_jax_packages():
    """The exit-code contract against a committed ``BENCH_delta_*``
    artifact of the JAX package (``tests/test_refit.py``'s): success
    reports carry ``complete`` under ``extra``, failure records at the
    top level, and an empty sweep fails."""
    assert refit.parse_churns(None) == jrefit.parse_churns(None) \
        == refit.DEFAULT_CHURNS == (0.01, 0.1, 0.3)
    assert refit.parse_churns("0.05,0.2") == (0.05, 0.2)
    rep = _committed("BENCH_delta_*.json")
    assert "complete" not in rep and rep["extra"]["complete"]
    for reports in ([rep], [dict(rep, sentinel_ok=False)],
                    [{"complete": False, "stage": "refit"}], []):
        assert refit.sweep_ok(reports) == jrefit.sweep_ok(reports)
    assert refit.sweep_ok([rep])
    assert not refit.sweep_ok([])


def _changed_ids(scratch_root):
    reg_root, = glob.glob(os.path.join(scratch_root, "tsdelta_*", "run_*",
                                       "registry"))
    reg = ParamRegistry.open(reg_root)
    return sorted((reg.delta_info(reg.active_version()) or {})
                  ["changed_ids"])


def test_delta_bench_changes_the_jax_packages_ids(tmp_path):
    reports = refit.run_delta_bench(
        "smoke", churns=(0.1,), scratch_root=str(tmp_path / "s"),
        device="cpu")
    jreports = jrefit.run_delta_bench(
        "smoke", churns=(0.1,), scratch_root=str(tmp_path / "js"),
        sentinel=False)
    assert refit.sweep_ok(reports) and jrefit.sweep_ok(jreports)
    rep, jrep = reports[0], jreports[0]
    assert _keys(rep) == _keys(jrep)
    assert rep["extra"]["n_changed"] == jrep["extra"]["n_changed"] > 0
    assert rep["extra"]["device"] == "cpu"
    assert rep["extra"]["fit_path"] == "resident"
    assert _changed_ids(str(tmp_path / "s")) == _changed_ids(
        str(tmp_path / "js"))
    assert os.path.exists(rep["path"])
    row = history.row_from_report(rep)
    assert row["kind"] == jhistory.row_from_report(jrep)["kind"] == "bench"
    assert row["workload"] == jhistory.row_from_report(jrep)["workload"]


def test_freshness_and_alert_benches_share_the_cold_base(tmp_path):
    """The freshness bench's two modes and the alert bench on one cold
    base (``reuse_cold``): every cycle complete, zero wrong-version
    answers, every delta's alerts delivered, and the JAX package's report
    keys and row families."""
    cold = str(tmp_path / "coldbase")
    fresh = sched.run_freshness_bench(
        "smoke", scratch_root=str(tmp_path / "s"), reuse_cold=cold,
        device="cpu")
    alerts = alerts_bench.run_alerts_bench(
        "smoke", scratch_root=str(tmp_path / "s"), reuse_cold=cold,
        device="cpu")
    assert refit.sweep_ok(fresh) and refit.sweep_ok(alerts)
    assert [r["mode"] for r in fresh] == ["serialized", "pipelined"]
    # One cold fit: the second mode and the alert bench reuse it.
    assert [r["cold_reused"] for r in fresh] == [False, True]
    assert alerts[0]["cold_reused"]
    jfresh = _committed("BENCH_freshness_smoke_*.json")
    jalerts = _committed("BENCH_alerts_smoke_*.json")
    for r in fresh:
        assert r["complete"] and r["wrong_version"] == 0
        assert r["freshness_n"] >= r["deltas"]
        assert r["device"] == "cpu"
        assert _keys(r) - {"path"} == _keys(jfresh)
        assert history.classify(r) == jhistory.classify(jfresh) \
            == "freshness"
    a = alerts[0]
    assert a["complete"] and a["delivered_frac"] == 1.0
    assert _keys(a) - {"path"} == _keys(jalerts)
    assert history.classify(a) == jhistory.classify(jalerts) == "alerts"
    assert sorted(os.path.basename(p) for p in glob.glob("BENCH_*")) == \
        sorted(os.path.basename(r["path"]) for r in fresh + alerts)


# ---------------------------------------------------------------------------
# the plane and calibration benches
# ---------------------------------------------------------------------------


def _bank_stand_in(monkeypatch):
    """The kernel bank's publish compiles the library where no build is
    present; here a stand-in compiler writes the file (no ``nvcc``)."""
    from tsspark_tpu_torch.kernels import build

    def compile_stand_in(nvcc, sources, lib_path):
        with open(lib_path, "wb") as fh:
            fh.write(b"compiled stand-in")

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_compile", compile_stand_in)


def _args(tmp_path, who, dir_=None, **kw):
    return types.SimpleNamespace(
        seed=0, dir=dir_ or str(tmp_path / who),
        report=str(tmp_path / f"{who}.json"),
        data_root=str(tmp_path / f"{who}_data"), **kw)


def test_serveplane_bench(tmp_path, monkeypatch):
    """The serve-plane bench gives the JAX package's report keys (and the
    port's ``cold_arm``) and row family.  The replicas' sockets live under
    ``args.dir``, so it is a short temporary directory (an AF_UNIX path
    past 107 bytes cannot bind).  The JAX package's bench points JAX's
    persistent compilation cache at its bank in that directory; the test
    puts the cache back as it found it."""
    import shutil
    import tempfile

    import jax
    from jax.experimental.compilation_cache import compilation_cache

    from tsspark_tpu.serve import planebench as jplanebench
    from tsspark_tpu_torch.serve import planebench

    _bank_stand_in(monkeypatch)
    short = tempfile.mkdtemp(prefix="pb")
    jax_cache = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        assert planebench.run_serveplane_bench(_args(
            tmp_path, "p", series=8, requests=64, device="cpu",
            dir_=os.path.join(short, "p"))) == 0
        assert jplanebench.run_serveplane_bench(_args(
            tmp_path, "j", series=8, requests=64,
            dir_=os.path.join(short, "j"))) == 0
    finally:
        for k, v in jax_cache.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
        shutil.rmtree(short, ignore_errors=True)
    with open(tmp_path / "p.json") as fh:
        rep = json.load(fh)
    with open(tmp_path / "j.json") as fh:
        jrep = json.load(fh)
    assert _keys(rep) == _keys(jrep) | {"plane.ttfr.cold_arm"}
    assert rep["plane"]["ttfr"]["cold_arm"] == planebench.COLD_ARM
    assert rep["plane"]["plane_hit_rate"] == 1.0
    assert rep["plane"]["ttfr"]["cold"]["ok"]
    assert rep["plane"]["ttfr"]["aot_warm"]["ok"]
    assert rep["device"] == "cpu"
    assert history.classify(rep) == jhistory.classify(jrep) == "serveplane"
    assert history.row_from_report(rep)["workload"] == \
        jhistory.row_from_report(jrep)["workload"]


def test_uncertainty_bench(tmp_path, monkeypatch):
    """The calibration bench gives the JAX package's report keys and row
    family, and the sentinel joins it to the cwd's run history."""
    from tsspark_tpu.uncertainty import calibrate as jcalibrate
    from tsspark_tpu_torch.uncertainty import calibrate

    monkeypatch.setenv("TSSPARK_SENTINEL", "1")
    assert calibrate.run_uncertainty_bench(_args(
        tmp_path, "p", series=12, device="cpu")) == 0
    monkeypatch.setenv("TSSPARK_SENTINEL", "0")
    assert jcalibrate.run_uncertainty_bench(_args(
        tmp_path, "j", series=12)) == 0
    with open(tmp_path / "p.json") as fh:
        rep = json.load(fh)
    with open(tmp_path / "j.json") as fh:
        jrep = json.load(fh)
    assert _keys(rep) == _keys(jrep)
    assert history.classify(rep) == jhistory.classify(jrep) == "calibration"
    row = history.row_from_report(rep)
    assert row["workload"] == jhistory.row_from_report(jrep)["workload"]
    assert row["device_class"] == "cpu"
    # The sentinel joined the report to the run history in the cwd.
    rows = history.read_history("RUNHISTORY.jsonl")
    assert [r["kind"] for r in rows] == ["calibration"]
