"""``python -m tsspark_tpu_torch.serve``: the daemon's request and control
lines (bitwise the in-process engine, within float32 of the JAX
package's daemon on the same weights), the daemon as a child process,
``--loadgen`` against the JAX package's (the same report keys and mix),
a small ``--pool 2`` loadgen, and the sentinel's history where the
caller puts it.  Every run restores both packages' obs bindings."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsspark_tpu.backends.registry import get_backend as jax_get_backend
from tsspark_tpu.config import ProphetConfig as JaxConfig
from tsspark_tpu.config import SeasonalityConfig as JaxSeason
from tsspark_tpu.config import SolverConfig as JaxSolver
from tsspark_tpu.obs import context as jobs
from tsspark_tpu.serve import ParamRegistry as JaxRegistry
from tsspark_tpu.serve import PredictionEngine as JaxEngine
from tsspark_tpu.serve.__main__ import _serve_lines as jax_serve_lines
from tsspark_tpu_torch.carry import fitstate_from_numpy
from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
from tsspark_tpu_torch.obs import context as tobs
from tsspark_tpu_torch.serve import ParamRegistry, PredictionEngine
from tsspark_tpu_torch.serve.__main__ import _serve_lines, main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JaxConfig(seasonalities=(JaxSeason("weekly", 7.0, 2),),
                 n_changepoints=3)
CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
IDS = [f"s{i}" for i in range(6)]

LINES = [
    '{"id": "a", "series_ids": ["s1", "s3"], "horizon": 7}',
    '{"id": "b", "series_ids": ["s0"], "horizon": 30, "num_samples": 0}',
    '{"id": "c", "series_ids": ["s5", "s2", "s4"], "horizon": 14,'
    ' "trace": {"trace_id": "caller", "parent_span_id": "p0"}}',
]
CONTROL = [
    '{"id": "st", "cmd": "stats"}',
    '{"id": "act", "cmd": "activate", "version": 2}',
    '{"id": "a2", "series_ids": ["s1"], "horizon": 7}',
    '{"id": "rb", "cmd": "rollback"}',
    '{"id": "a3", "series_ids": ["s1"], "horizon": 7}',
    '{"id": "m", "cmd": "metrics"}',
    '{"id": "gh", "series_ids": ["ghost"], "horizon": 7}',
    '{"id": "bad", "horizon": 7}',
    'not json',
]


def _bindings():
    return (jobs.active(), jobs.trace_id(), tobs.active(), tobs.trace_id())


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    t = np.arange(150.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (6, 150)))
    return jax_get_backend("tpu", JCFG, JaxSolver(max_iters=25)).fit(
        t, jnp.asarray(y))


def _port_state(jax_state, scale=1.0):
    leaves = {f: np.asarray(getattr(jax_state, f))
              for f in ("theta", "loss", "grad_norm", "converged",
                        "n_iters", "status")}
    leaves["theta"] = leaves["theta"] * np.float32(scale)
    leaves.update(jax_state.meta._asdict())
    return fitstate_from_numpy(leaves, "cpu")


@pytest.fixture
def registries(tmp_path, fitted):
    """v1 and v2 (theta x 1.01, not active) in a JAX and a port registry
    of the same weights."""
    jreg = JaxRegistry(str(tmp_path / "jax"), JCFG)
    jreg.publish(fitted, IDS, step=np.ones(6))
    jreg.publish(fitted._replace(theta=fitted.theta * 1.01), IDS,
                 step=np.ones(6), activate=False)
    treg = ParamRegistry(str(tmp_path / "port"), CFG)
    treg.publish(_port_state(fitted), IDS, step=np.ones(6))
    treg.publish(_port_state(fitted, 1.01), IDS, step=np.ones(6),
                 activate=False)
    return jreg, treg


def _lines(reg, engine, serve_lines, lines):
    out = []
    assert serve_lines(reg, engine, out.append, lines=lines) == 0
    return out


def test_daemon_lines_against_the_engine_and_the_jax_daemon(registries):
    jreg, treg = registries
    got = _lines(treg, PredictionEngine(treg, device="cpu"), _serve_lines,
                 LINES)
    want = _lines(jreg, JaxEngine(jreg), jax_serve_lines, LINES)
    ref = PredictionEngine(ParamRegistry.open(treg.root), device="cpu")
    snap = jreg.load()
    for line, g, w in zip(LINES, got, want):
        msg = json.loads(line)
        assert g["ok"] and w["ok"] and g["id"] == w["id"] == msg["id"]
        assert sorted(g) == sorted(w)
        assert g["version"] == w["version"] == 1
        res = ref.forecast(msg["series_ids"], msg["horizon"])
        np.testing.assert_array_equal(np.asarray(g["ds"]), res.ds)
        idx, _ = snap.rows(msg["series_ids"])
        scale = np.asarray(snap.state.meta.y_scale)[idx][:, None]
        for k, v in res.values.items():
            np.testing.assert_array_equal(np.asarray(g[k], np.float32), v,
                                          err_msg=k)
            atol = 1e-6 * (1.0 if k == "multiplicative" else scale)
            diff = np.abs(np.asarray(g[k]) - np.asarray(w[k]))
            assert (diff <= atol + 1e-5 * np.abs(np.asarray(w[k]))).all()


def test_daemon_control_lines(registries):
    _, treg = registries
    out = _lines(treg, PredictionEngine(treg, device="cpu"), _serve_lines,
                 LINES[:1] + CONTROL)
    by_id = {o.get("id"): o for o in out}
    assert by_id["st"]["stats"]["completed"] == 1
    assert by_id["st"]["active_version"] == 1
    assert by_id["act"] == {"ok": True, "id": "act", "active_version": 2}
    assert by_id["a2"]["version"] == 2
    assert by_id["rb"] == {"ok": True, "id": "rb", "active_version": 1}
    assert by_id["a3"]["version"] == 1
    assert by_id["a3"]["yhat"] == by_id["a"]["yhat"][:1]
    assert "tsspark_serve_requests_total" in by_id["m"]["prometheus"]
    assert by_id["gh"]["error"]["reason"] == "unknown-series"
    assert by_id["bad"]["error"]["type"] == "BadRequest"
    assert out[-1] == {"ok": False, "error": {
        "type": "BadRequest", "detail": out[-1]["error"]["detail"]}}


def test_daemon_child_process_is_the_engine_bitwise(registries, tmp_path):
    """``python -m tsspark_tpu_torch.serve --registry R --device cpu`` as
    a child: its request lines are the in-process engine's arrays bit for
    bit, and stats / activate / rollback answer."""
    _, treg = registries
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    stdin = "\n".join(LINES + CONTROL[:5]) + "\n"
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.serve",
         "--registry", treg.root, "--device", "cpu"],
        input=stdin, env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    out = [json.loads(s) for s in proc.stdout.splitlines()]
    assert len(out) == len(LINES) + 5
    ref = PredictionEngine(ParamRegistry.open(treg.root), device="cpu")
    for line, got in zip(LINES, out):
        msg = json.loads(line)
        res = ref.forecast(msg["series_ids"], msg["horizon"])
        for k, v in res.values.items():
            np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                          v, err_msg=k)
    assert [o["id"] for o in out[len(LINES):]] == \
        ["st", "act", "a2", "rb", "a3"]
    assert out[len(LINES) + 2]["version"] == 2
    assert out[-1]["version"] == 1
    # The daemon's spans went next to its registry, with the caller's
    # trace on the enveloped request.
    recs = tobs.read_records(os.path.join(treg.root, "spans.jsonl"))
    assert any(r.get("trace_id") == "caller" for r in recs)
    assert not os.path.exists(tmp_path / "RUNHISTORY.jsonl")


def _loadgen_args(tmp, tag, *extra):
    return ["--loadgen", "200", "--series", "48", "--seed", "1",
            "--dir", str(tmp / tag), "--report", str(tmp / f"{tag}.json"),
            "--data-root", str(tmp / "data"), *extra]


def test_loadgen_reports_the_jax_packages_keys_and_mix(tmp_path,
                                                       monkeypatch):
    """``--loadgen 200 --series 48`` on both packages (the JAX one in a
    child process, so its jax config and obs binding stay its own): the
    same report keys and the same request mix."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               TSSPARK_SENTINEL="0", TSSPARK_JAX_CACHE=str(tmp_path / "jc"),
               OMP_NUM_THREADS="1")
    jproc = subprocess.Popen(
        [sys.executable, "-m", "tsspark_tpu.serve",
         *_loadgen_args(tmp_path, "jax")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TSSPARK_SENTINEL", "0")
    before = _bindings()
    assert main(_loadgen_args(tmp_path, "port", "--device", "cpu")) == 0
    assert _bindings() == before
    _, err = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, err
    with open(tmp_path / "port.json") as fh:
        got = json.load(fh)
    with open(tmp_path / "jax.json") as fh:
        want = json.load(fh)
    assert sorted(got) == sorted(want)
    assert got["mix"] == want["mix"]
    assert sorted(got["engine"]) == sorted(want["engine"])
    assert sorted(got["engine"]["latency_ms"]) == \
        sorted(want["engine"]["latency_ms"])
    assert sorted(got["cache"]) == sorted(want["cache"])
    assert sorted(got["dispatch"]) == sorted(want["dispatch"])
    assert got["device"] == "cpu" and got["kind"] == want["kind"]
    eng = got["engine"]
    assert eng["completed"] + eng["shed"] + eng["failed"] \
        + eng["rejected"] == 200
    assert got["dispatch"]["n_dispatches"] == eng["dispatches"]
    lat = eng["latency_ms"]
    assert lat["p50"] <= lat["p95"] <= lat["p99"]


def test_pool_loadgen_small(tmp_path, monkeypatch):
    """``--loadgen 200 --pool 2 --device cpu``: two replica processes,
    one mid-run flip, no non-shed failure, no wrong-version answer."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TSSPARK_SENTINEL", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = _bindings()
    assert main(_loadgen_args(tmp_path, "pool", "--pool", "2",
                              "--device", "cpu")) == 0
    assert _bindings() == before
    with open(tmp_path / "pool.json") as fh:
        rep = json.load(fh)
    assert rep["engine"]["failed"] == 0 and rep["engine"]["rejected"] == 0
    assert rep["engine"]["completed"] + rep["engine"]["shed"] == 200
    pool = rep["pool"]
    assert pool["replicas"] == 2 and pool["wrong_version"] == 0
    assert pool["flip"]["version"] == rep["active_version"] == 2
    assert set(pool["per_replica"]) == {"0", "1"}
    assert sum(r["completed"] for r in pool["per_replica"].values()) >= \
        rep["engine"]["completed"]


def test_sentinel_history_goes_where_the_caller_puts_it(tmp_path,
                                                        monkeypatch):
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.delenv("TSSPARK_SENTINEL", raising=False)
    hist = tmp_path / "hist" / "RUNHISTORY.jsonl"
    for tag in ("one", "two"):
        rc = main(_loadgen_args(tmp_path, tag, "--device", "cpu",
                                "--history", str(hist)))
        latest = max(hist.parent.glob("REGRESSION_*.json"),
                     key=os.path.getmtime)
        with open(latest) as fh:
            ok = json.load(fh)["ok"]
        # The first run has no baseline and cannot breach. The second is
        # judged against the first's latencies, which a shared CPU may
        # well beat: its exit code is the verdict the sentinel wrote.
        assert rc == (0 if ok else 1)
        assert rc == 0 or tag == "two"
    from tsspark_tpu_torch.obs import history

    rows = history.read_history(str(hist))
    assert [r["kind"] for r in rows] == ["serve", "serve"]
    assert {r["device_class"] for r in rows} == {"cpu"}
    verdicts = sorted(p for p in os.listdir(hist.parent)
                      if p.startswith("REGRESSION_"))
    assert len(verdicts) >= 1
    assert os.listdir(work) == []  # nothing landed in the working dir
