"""The port's exactly-once alert stream (``tsspark_tpu_torch.alerts``) on
the CPU: deterministic scoring, the record / CRC-sentinel publish protocol
under a kill-point sweep, replay idempotence across randomized kill points
and sink brownouts, the data-liveness kind's durable queue and the key
dedup, each a counterpart of a test in ``tests/test_alerts.py``; then the
scorer and the log against the JAX package's.

``test_alert_record_protocol_registered`` needs the JAX package's
``analysis.protomodel``; its counterpart here checks the write order
(spec, record, sentinel) at the three ``alert_publish`` points directly.
"""

import collections
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tsspark_tpu_torch import orchestrate
from tsspark_tpu_torch.alerts import stream as stream_mod
from tsspark_tpu_torch.alerts.score import (
    alert_key,
    canonical_bytes,
    record_crc,
    score_delta,
    score_rows,
)
from tsspark_tpu_torch.alerts.sink import FlakySink, JsonlSink, build_sink
from tsspark_tpu_torch.alerts.stream import AlertStream
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data import plane
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.faults import FaultPlan
from tsspark_tpu_torch.serve.cache import ForecastCache
from tsspark_tpu_torch.serve.engine import PredictionEngine
from tsspark_tpu_torch.serve.registry import ParamRegistry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ProphetConfig(
    seasonalities=(SeasonalityConfig("weekly", 7.0, 2),), n_changepoints=3
)
SOLVER = SolverConfig(max_iters=25)
N = 6
#: Fires on any visible residual / silences data-liveness: the tests
#: control WHICH alerts exist, not the model's accuracy.
Z_FIRE, K_QUIET = 0.05, 1e9


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(7)
    t = np.arange(120.0)
    y = (10 + 0.02 * t[None, :] + np.sin(2 * np.pi * t[None, :] / 7)
         + rng.normal(0, 0.1, (N, 120)))
    return get_backend("cuda", CFG, SOLVER, device="cpu").fit(t, y)


@pytest.fixture()
def world(tmp_path, fitted):
    """(dset_dir, registry, engine): a plane dataset whose series ids
    are what the registry serves."""
    spec = plane.DatasetSpec(generator="demo_weekly", n_series=N,
                             n_timesteps=64, seed=2)
    dset = plane.ensure(spec, root=str(tmp_path / "plane"))
    pids = plane.series_ids(spec)
    reg = ParamRegistry(str(tmp_path / "registry"), CFG)
    reg.publish(fitted, pids, step=np.ones(N))
    engine = PredictionEngine(reg, cache=ForecastCache(0), device="cpu")
    return dset, reg, engine


def _stream(world, log_dir, sink=None, **kw):
    dset, _reg, engine = world
    kw.setdefault("z", Z_FIRE)
    kw.setdefault("overdue_k", K_QUIET)
    return AlertStream(str(log_dir), dset, engine,
                       sink if sink is not None
                       else JsonlSink(str(log_dir) + "_sink.jsonl"),
                       horizon=1, **kw)


def _land(dset, rows=(0, 2, 4)):
    plane.land_synthetic_delta(dset, 0.5, rows=np.asarray(rows, np.int64))


def _rec_path(log_dir, seq):
    return os.path.join(str(log_dir), f"alertrec_{seq:06d}.json")


def _ok_path(log_dir, seq):
    return os.path.join(str(log_dir), f"alertok_{seq:06d}.json")


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _heal(world, log_dir, sink_path, bound_s=30.0):
    """A fresh stream over the same log and a healthy sink, polled until
    delivery reaches the scored head (bounded)."""
    heal = _stream(world, log_dir, sink=JsonlSink(sink_path))
    deadline = time.monotonic() + bound_s
    while time.monotonic() < deadline:
        res = heal.poll_once()
        if not res["stalled"] and heal.delivered_seq() == heal.scored_seq():
            break
        time.sleep(0.2)  # the breaker's reset window
    return heal


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def test_score_rows_interval_vs_zscore_breach_parity():
    """Where both modes describe the same band (interval [lo, hi] ==
    yhat +/- z*sigma) they make the same breach decisions."""
    y = np.array([0.0, 10.0, 5.0, 6.5, 3.5])
    yhat = np.full(5, 5.0)
    sigma = np.full(5, 0.5)
    z = 3.0  # band [3.5, 6.5]
    fired_i, sev_i, mode_i = score_rows(y, lo=yhat - z * sigma,
                                        hi=yhat + z * sigma)
    fired_z, sev_z, mode_z = score_rows(y, yhat=yhat, sigma=sigma, z=z)
    assert mode_i == "interval" and mode_z == "zscore"
    np.testing.assert_array_equal(fired_i, fired_z)
    np.testing.assert_array_equal(fired_i, [True, True, False, False, False])
    assert ((sev_i > 0) == fired_i).all()
    assert ((sev_z > 0) == fired_z).all()
    with pytest.raises(ValueError):
        score_rows(y)


def test_score_delta_is_deterministic_bitwise(world):
    dset, _reg, engine = world
    _land(dset)
    a = score_delta(engine, dset, 1, z=Z_FIRE)
    b = score_delta(engine, dset, 1, z=Z_FIRE)
    assert canonical_bytes(a) == canonical_bytes(b)
    assert record_crc(a) == record_crc(b)
    assert a["n_fired"] >= 1
    assert a["mode"] == "zscore" and a["degraded"]  # no quantile plane
    for al in a["alerts"]:
        assert al["key"] == alert_key(al["kind"], al["series"], a["seq"])


# ---------------------------------------------------------------------------
# the record protocol
# ---------------------------------------------------------------------------


def test_publish_kill_point_sweep_rescore_bitwise(world, tmp_path,
                                                  monkeypatch):
    """A scorer killed at ANY of the three ``alert_publish`` sites leaves
    a log a successor heals to the same certified bytes a fault-free
    scorer writes."""
    dset, _reg, engine = world
    _land(dset)
    ref = _stream(world, tmp_path / "ref")
    ref.poll_once()
    want = _read(_rec_path(tmp_path / "ref", 1))
    for k in range(3):
        log_dir = tmp_path / f"kill{k}"
        s = _stream(world, log_dir)
        plan = FaultPlan(state_dir=str(tmp_path / "faults" / str(k)))
        plan.fail("alert_publish", after=k, mode="raise", tag=f"kill-{k}")
        monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
        with pytest.raises(faults.FaultInjected):
            s.poll_once()
        monkeypatch.delenv(faults.ENV_VAR)
        heal = _stream(world, log_dir)
        res = heal.poll_once()
        assert heal.record_ok(1) is not None, f"kill point {k}"
        assert _read(_rec_path(log_dir, 1)) == want, f"kill point {k}"
        assert not res["stalled"]
        assert heal.delivered_seq() == heal.scored_seq() == 1


def test_record_protocol_writes_spec_then_record_then_sentinel(
        world, tmp_path, monkeypatch):
    """At each ``alert_publish`` point the log holds exactly what the
    protocol has written so far: the spec before the record, the record
    before its sentinel, the sentinel (certifying the record's CRC) at
    the last."""
    dset, _reg, engine = world
    _land(dset)
    log_dir = tmp_path / "log"
    seen = []
    real = faults.inject

    def spy(point, **kw):
        if point == stream_mod.ALERT_PUBLISH:
            seen.append((os.path.basename(kw["path"]),
                         os.path.exists(log_dir / "alerts_spec.json"),
                         os.path.exists(_rec_path(log_dir, 1)),
                         os.path.exists(_ok_path(log_dir, 1))))
        return real(point, **kw)

    monkeypatch.setattr(stream_mod.faults, "inject", spy)
    s = _stream(world, log_dir)
    s.poll_once()
    assert seen == [
        ("alertrec_000001.json", True, False, False),
        ("alertok_000001.json", True, True, False),
        ("alertok_000001.json", True, True, True),
    ]
    assert s.record_ok(1) is not None


def test_torn_record_and_torn_sentinel_rejected_then_healed(
        world, tmp_path):
    dset, _reg, engine = world
    _land(dset)
    log_dir = tmp_path / "log"
    _stream(world, log_dir).poll_once()
    orig = _read(_rec_path(log_dir, 1))
    with open(_rec_path(log_dir, 1), "r+b") as fh:
        fh.seek(7)
        fh.write(bytes([orig[7] ^ 0xFF]))
    s2 = _stream(world, log_dir)
    assert s2.record_ok(1) is None
    res = s2.poll_once()
    assert _read(_rec_path(log_dir, 1)) == orig
    assert res["deduped"] == 0 and res["delivered"] == 0
    os.truncate(_ok_path(log_dir, 1), 5)
    s3 = _stream(world, log_dir)
    assert s3.record_ok(1) is None
    s3.poll_once()
    assert s3.record_ok(1) is not None
    assert _read(_rec_path(log_dir, 1)) == orig
    keys = [a["key"] for a in JsonlSink(str(log_dir) + "_sink.jsonl")
            .alerts()]
    assert len(keys) == len(set(keys))


def test_replay_idempotent_across_randomized_kill_points(world, tmp_path,
                                                         monkeypatch):
    """Whatever the interleaving of publish kills, delivery kills, sink
    brownouts, torn sentinels and torn records, once the faults clear the
    sink holds every certified alert key exactly once and the watermark
    sits at the scored head."""
    dset, _reg, engine = world
    log_dir = tmp_path / "log"
    sink_path = str(log_dir) + "_sink.jsonl"
    for seed in range(4):
        rng = random.Random(f"alert-replay:{seed}")
        _land(dset, rows=rng.sample(range(N), 3))
        disruption = rng.choice(
            ["pub_kill", "del_kill", "brownout", "tear_ok", "tear_rec"])
        flaky = FlakySink(JsonlSink(sink_path), fail_n=0)
        s = _stream(world, log_dir, sink=flaky)
        if disruption == "pub_kill":
            plan = FaultPlan(state_dir=str(tmp_path / "f" / f"p{seed}"))
            plan.fail("alert_publish", after=rng.randrange(3),
                      mode="raise", tag="p")
            monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
            with pytest.raises(faults.FaultInjected):
                s.poll_once()
            monkeypatch.delenv(faults.ENV_VAR)
        elif disruption == "del_kill":
            plan = FaultPlan(state_dir=str(tmp_path / "f" / f"d{seed}"))
            plan.fail("alert_deliver", after=rng.randrange(2),
                      mode="raise", tag="d")
            monkeypatch.setenv(faults.ENV_VAR, plan.to_env())
            assert s.poll_once()["stalled"]
            monkeypatch.delenv(faults.ENV_VAR)
        elif disruption == "brownout":
            flaky.fail_n = flaky.attempts + rng.randrange(3, 9)
            assert s.poll_once()["stalled"]
            flaky.fail_n = 0
        elif disruption == "tear_ok":
            s.poll_once()
            os.truncate(_ok_path(log_dir, s.scored_seq()),
                        rng.randrange(5))
        elif disruption == "tear_rec":
            s.poll_once()
            with open(_rec_path(log_dir, s.scored_seq()), "r+b") as fh:
                fh.seek(3)
                fh.write(b"\x00")
        heal = _heal(world, log_dir, sink_path)
        assert heal.scored_seq() == plane.delta_seq(dset)
        assert heal.delivered_seq() == heal.scored_seq()
        expected = []
        for q in range(1, heal.scored_seq() + 1):
            rec = heal.record_ok(q)
            assert rec is not None, (seed, disruption, q)
            expected += [a["key"] for a in rec["alerts"]]
        counts = collections.Counter(
            a["key"] for a in JsonlSink(sink_path).alerts())
        dupes = {k: n for k, n in counts.items() if n > 1}
        assert not dupes, (seed, disruption, dupes)
        assert set(expected) <= set(counts), (seed, disruption)


# ---------------------------------------------------------------------------
# data liveness, sinks, the arrival model
# ---------------------------------------------------------------------------


def test_liveness_alerts_queue_survives_brownout(world, tmp_path):
    dset, _reg, engine = world
    _land(dset, rows=(0, 1, 2, 3, 4, 5))
    _land(dset, rows=(0, 1, 2, 3, 4, 5))
    _land(dset, rows=(0, 3))
    log_dir = tmp_path / "log"
    sink_path = str(log_dir) + "_sink.jsonl"
    flaky = FlakySink(JsonlSink(sink_path), fail_n=0)
    s = _stream(world, log_dir, sink=flaky)
    s.poll_once()
    s.overdue_k = 0.1
    flaky.fail_n = 500
    live = s.liveness_alerts(time.time() + 3600.0)
    assert {a["kind"] for a in live} == {"data-liveness"}
    assert len(live) >= 2
    res = s.deliver_loose(live)
    assert res["stalled"] and res["queued"] >= len(live)
    assert os.path.exists(os.path.join(str(log_dir), "alerts_queue.jsonl"))
    flaky.fail_n = 0
    time.sleep(1.1)  # the default breaker's reset window
    drained = s.deliver_loose([])
    assert not drained["stalled"] and drained["queued"] == 0
    counts = collections.Counter(
        a["key"] for a in JsonlSink(sink_path).alerts()
        if a["kind"] == "data-liveness")
    assert counts and all(n == 1 for n in counts.values())


def test_sink_specs_and_recover(tmp_path):
    with pytest.raises(ValueError):
        build_sink("kafka://nope")
    assert build_sink("jsonl:/tmp/x.jsonl").name == "jsonl"
    path = tmp_path / "s.jsonl"
    path.write_bytes(b'{"key": "a"}\n{"key": "b"')  # a torn last line
    sink = build_sink(str(path))
    sink.recover()
    sink.emit({"key": "c"})
    assert sink.keys() == {"a", "c"}


def test_arrival_model_overdue_rows():
    from tsspark_tpu_torch.sched import ArrivalModel

    m = ArrivalModel()
    for seq, t in ((1, 100.0), (2, 110.0), (3, 120.0)):
        m.note_delta(seq, t, [0, 1])
    m.note_delta(4, 130.0, [1])
    over = m.overdue_rows(200.0, k=3.0)
    assert 0 in over and over[0] == pytest.approx(80.0 - 30.0)
    assert m.overdue_rows(121.0, k=3.0) == {}


def test_cli_polls_once_on_the_cpu_and_refuses_the_bench(world, tmp_path):
    """``python -m tsspark_tpu_torch.alerts --device cpu --poll-once``
    scores and delivers the landed deltas into the log an in-process
    stream then reads as its own; ``--bench smoke --device cpu`` runs the
    land→alert bench on the CPU and exits 0 with its report in the
    working directory (the test keeps the name it had when the bench was
    not yet ported and exited 2)."""
    dset, reg, engine = world
    _land(dset)
    _land(dset, rows=(1, 3))
    log_dir = tmp_path / "cli_log"
    sink_path = str(tmp_path / "cli_sink.jsonl")
    env = orchestrate._child_env()
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.alerts", "--data", dset,
         "--registry", reg.root, "--alerts-dir", str(log_dir),
         "--sink", f"jsonl:{sink_path}", "--z", str(Z_FIRE),
         "--overdue-k", str(K_QUIET), "--poll-once", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    s = _stream(world, tmp_path / "inproc")
    s.poll_once()
    for q in (1, 2):
        assert _read(_rec_path(log_dir, q)) == _read(
            _rec_path(tmp_path / "inproc", q))
    keys = [a["key"] for a in JsonlSink(sink_path).alerts()]
    assert len(keys) == len(set(keys)) > 0
    bench_env = dict(env, TMPDIR=str(tmp_path / "bench_tmp"),
                     TSSPARK_SENTINEL="0")
    os.makedirs(bench_env["TMPDIR"])
    bench_cwd = tmp_path / "bench_cwd"
    bench_cwd.mkdir()
    bench = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch.alerts", "--bench",
         "smoke", "--device", "cpu"], cwd=str(bench_cwd),
        env=bench_env, capture_output=True, text=True, timeout=300)
    assert bench.returncode == 0, bench.stderr[-2000:]
    report, = os.listdir(bench_cwd)
    assert report.startswith("BENCH_alerts_smoke_")
    with open(bench_cwd / report) as fh:
        rep = json.load(fh)
    assert rep["complete"] and rep["delivered_frac"] == 1.0
    assert rep["device"] == "cpu"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_world(world, tmp_path):
    """The JAX package's engine over a copy of the world's registry."""
    from tsspark_tpu import config as jcfg
    from tsspark_tpu.serve import ForecastCache as JCache
    from tsspark_tpu.serve import ParamRegistry as JRegistry
    from tsspark_tpu.serve import PredictionEngine as JEngine

    _dset, reg, _engine = world
    jroot = str(tmp_path / "jregistry")
    shutil.copytree(reg.root, jroot)
    jcf = jcfg.ProphetConfig(
        seasonalities=(jcfg.SeasonalityConfig("weekly", 7.0, 2),),
        n_changepoints=3)
    return JEngine(JRegistry(jroot, jcf), cache=JCache(0))


def _with_quantile_plane(reg):
    """An ADVI posterior at the MAP theta and the ADVI-mode quantile
    plane for the active version."""
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import qplane

    v = reg.active_version()
    theta = np.asarray(reg.load(v, fallback=False).state.theta, np.float32)
    advi_mod.save_posterior(
        reg.version_dir(v),
        advi_mod.AdviPosterior(mu=theta, rho=np.full_like(theta, -3.0),
                               elbo=np.zeros(N, np.float32)),
        seed=7, num_steps=20)
    bk = get_backend("cuda", CFG, SolverConfig(), device="cpu")
    assert qplane.maybe_publish(reg, v, bk)["status"] == "published"


def test_interval_records_are_the_jax_packages_bytes(world, tmp_path):
    """On copies of one registry with a quantile plane, both packages'
    ``score_delta`` give equal canonical bytes in interval mode (the
    thresholds are plane cells both read)."""
    from tsspark_tpu.alerts import score as jscore

    dset, reg, engine = world
    _with_quantile_plane(reg)
    jengine = _jax_world(world, tmp_path)
    _land(dset, rows=(0, 1, 2, 3, 4, 5))
    _land(dset, rows=(1, 4))
    for seq in (1, 2):
        got = score_delta(engine, dset, seq)
        want = jscore.score_delta(jengine, dset, seq)
        assert got["mode"] == "interval" and not got["degraded"]
        assert canonical_bytes(got) == jscore.canonical_bytes(want)
        assert record_crc(got) == jscore.record_crc(want)


#: z-score mode against the JAX package: the two engines' float32
#: forecasts may part by float32 rounding, so a row's |z| may differ by a
#: few float32 ulps of |y| / sigma; rows within Z_MARGIN of the threshold
#: are not compared, severities agree within SEV_ATOL.  Read at this size:
#: the two forecasts bitwise equal, the severities equal at the record's
#: 6-decimal rounding.
Z_TEST, Z_MARGIN, SEV_ATOL = 1.0, 1e-3, 1e-4


def test_zscore_records_against_the_jax_packages(world, tmp_path):
    from tsspark_tpu.alerts import score as jscore

    dset, reg, engine = world
    jengine = _jax_world(world, tmp_path)
    for k in range(4):
        plane.land_synthetic_delta(dset, 1.0, seed=k)
    compared = fired = 0
    for seq in range(1, 5):
        got = score_delta(engine, dset, seq, z=Z_TEST)
        want = jscore.score_delta(jengine, dset, seq, z=Z_TEST)
        assert got["mode"] == want["mode"] == "zscore"
        patch = plane.delta_patch(dset, seq)
        order = np.argsort(np.asarray(patch["rows"]), kind="stable")
        y_new = jscore.newest_observations(patch)[0][order]
        sigma = jscore.residual_scale(patch["y"], patch["mask"])[order]
        ids = [al["series"] for al in got["alerts"]]
        fc = engine.forecast(
            [str(s) for s in plane.series_ids(plane.DatasetSpec.from_dict(
                plane.read_spec(dset)))[np.sort(patch["rows"])]], 1)
        z = np.abs(y_new - fc.values["yhat"][:, 0]) / sigma
        away = np.abs(z - Z_TEST) > Z_MARGIN
        rows = np.sort(np.asarray(patch["rows"]))
        got_f = {al["row"]: al for al in got["alerts"]}
        want_f = {al["row"]: al for al in want["alerts"]}
        for i, r in enumerate(rows.tolist()):
            if not away[i]:
                continue
            compared += 1
            assert (r in got_f) == (r in want_f), (seq, r, z[i])
            if r in got_f:
                fired += 1
                assert abs(got_f[r]["severity"] - want_f[r]["severity"]) \
                    <= SEV_ATOL, (seq, r)
                assert got_f[r]["key"] == want_f[r]["key"]
        assert len(ids) == got["n_fired"]
    assert compared >= 20 and 0 < fired < compared


def test_alert_logs_read_across_packages(world, tmp_path):
    """A log one package's ``AlertStream`` wrote is certified by the
    other's ``record_ok`` (the same records), in both directions."""
    from tsspark_tpu.alerts.sink import JsonlSink as JSink
    from tsspark_tpu.alerts.stream import AlertStream as JStream

    dset, reg, engine = world
    jengine = _jax_world(world, tmp_path)
    _land(dset)
    _land(dset, rows=(1, 5))
    port_log, jax_log = tmp_path / "port_log", tmp_path / "jax_log"
    mine = _stream(world, port_log)
    mine.poll_once()
    theirs = JStream(str(jax_log), dset, jengine,
                     JSink(str(jax_log) + "_sink.jsonl"), horizon=1,
                     z=Z_FIRE, overdue_k=K_QUIET)
    theirs.poll_once()
    read_jax = JStream(str(port_log), dset, jengine,
                       JSink(str(tmp_path / "x.jsonl")), horizon=1)
    read_port = _stream(world, jax_log, sink=JsonlSink(
        str(tmp_path / "y.jsonl")))
    for q in (1, 2):
        assert read_jax.record_ok(q) == mine.record_ok(q)
        assert read_port.record_ok(q) == theirs.record_ok(q)
        assert read_port.record_ok(q)["seq"] == q
    assert read_jax.scored_seq() == read_port.scored_seq() == 2
    assert read_jax.delivered_seq() == read_port.delivered_seq() == 2
