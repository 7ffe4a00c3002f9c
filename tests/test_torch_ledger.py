"""The port's run ledger and its CLIs (``tsspark_tpu_torch.obs.ledger``,
``obs.watch``, ``python -m tsspark_tpu_torch.obs`` and ``... perf``) on the
CPU, held against the JAX package's: one scratch tree of spans, worker
``times.jsonl`` rows and metric snapshots goes through both packages'
``build_ledger``; then the counterparts of ``tests/test_obs.py``'s CLI
tests, ``tests/test_perf.py``'s perf CLI test, ``tests/test_history.py``'s
watch tests and ``tests/test_sched.py::test_freshness_spans_reach_obs_watch``.

Every test binds its own run and restores the binding it found, in both
packages' contexts.
"""

import json
import os
import time

import pytest
import torch

from tsspark_tpu.obs import context as jcontext
from tsspark_tpu.obs import ledger as jledger
from tsspark_tpu_torch.obs import context, history, ledger, metrics, regress
from tsspark_tpu_torch.obs import watch
from tsspark_tpu_torch.obs.__main__ import main as obs_main
from tsspark_tpu_torch.perf.__main__ import main as perf_main
from tsspark_tpu_torch.perf.recorder import summarize_times
from tsspark_tpu_torch.utils.atomic import append_line

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The card's name as the port's workers and reports write it.
CARD = "cuda:0 (NVIDIA H100 80GB HBM3)"


@pytest.fixture(autouse=True)
def restore_bindings():
    """No test leaves a run bound in either package."""
    before = (context._RUN, jcontext._RUN)
    yield
    context._RUN, jcontext._RUN = before


def _scratch_tree(root):
    """A storm-shaped run: a stage, chunk claims / fits / lands (one
    range landed twice), a fault and its recovery, a direct-mode fault,
    a worker's open span that never closed, serve requests, a publish; a
    metric snapshot; two workers' ``times.jsonl`` rows (one torn tail)."""
    os.makedirs(os.path.join(root, "w1"))
    prev = context.start_run(os.path.join(root, "spans.jsonl"))
    try:
        t = time.time()
        with context.span("stage.orchestrate", rung="smoke"):
            for lo in (0, 8, 16):
                with context.span("chunk.claim", lo=lo, hi=lo + 8):
                    pass
                context.record("chunk.fit", t + lo * 0.01, 0.25, lo=lo,
                               hi=lo + 8, width=8)
                context.record("chunk.land", t + lo * 0.01 + 0.3, 0.001,
                               lo=lo, hi=lo + 8)
            context.event("fault", tag="worker-exit", mode="env")
            context.record("chunk.land", time.time(), 0.001, lo=8, hi=16)
            context.event("fault", tag="torn-chunk", mode="direct")
            context.event("recovered", tag="torn-chunk")
            sid = context.open_span("chunk.fit", lo=24, hi=32)
            assert sid is not None
        context.record("registry.publish", time.time(), 0.01, version=1)
        context.record("registry.activate", time.time(), 0.001, version=1)
        for i in range(5):
            context.record("serve.request", time.time(), 0.002 * (i + 1),
                           cached=int(i > 2), n_series=1, horizon=7,
                           version=1)
        context.record("serve.request", time.time(), 0.05, status="err")
        reg = metrics.MetricsRegistry()
        reg.counter("tsspark_fit_chunks_total").inc(3)
        reg.gauge("tsspark_serve_queue_depth").set(2.0)
        reg.histogram("tsspark_fit_chunk_seconds").observe(0.25)
        reg.export(os.path.join(root, "metrics_t.json"),
                   trace_id=context.trace_id())
    finally:
        context.end_run(prev)
    rows = [{"lo": 0, "hi": 8, "fit_s": 0.25, "t": 0.3, "width": 8,
             "series_per_s": 32.0, "compile_miss": True, "device": CARD},
            {"lo": 8, "hi": 16, "fit_s": 0.2, "t": 0.6, "width": 8,
             "series_per_s": 40.0, "device": CARD}]
    with open(os.path.join(root, "times.jsonl"), "w") as fh:
        fh.write(json.dumps(rows[0]) + "\n")
    with open(os.path.join(root, "w1", "times.jsonl"), "w") as fh:
        fh.write(json.dumps(rows[1]) + "\n" + '{"lo": 16, "hi"')


def _stampless(led):
    return {k: v for k, v in led.items() if k != "unix"}


def test_build_ledger_is_the_jax_packages(tmp_path):
    root = str(tmp_path / "run")
    _scratch_tree(root)
    got = ledger.build_ledger(root, reports=[{"kind": "scale-ladder",
                                              "unix": 1.0, "ok": True}])
    want = jledger.build_ledger(root, reports=[{"kind": "scale-ladder",
                                                "unix": 1.0, "ok": True}])
    assert json.loads(json.dumps(_stampless(got))) == json.loads(
        json.dumps(_stampless(want)))
    assert got["orphan_spans"] == []
    assert got["red"]["serve.request"]["err"] == 1
    assert got["red"]["chunk.fit"]["open"] == 1
    assert got["perf"]["n_chunks"] == 2
    assert set(got["mttr_s"]) == {"worker-exit", "torn-chunk"}
    spans, events = ledger.merge_spans(ledger.collect_records(root))
    jspans, jevents = jledger.merge_spans(jledger.collect_records(root))
    assert ledger.derive_mttr(spans, events) == jledger.derive_mttr(
        jspans, jevents)
    assert ledger.red_summary(spans) == jledger.red_summary(jspans)
    assert ledger.milestones(spans) == jledger.milestones(jspans)
    # A span whose parent never reached the log is an orphan in both.
    lost = dict(spans[1], span_id="x1", parent_id="gone")
    assert ledger.orphan_spans(spans + [lost]) == ["x1"] == \
        jledger.orphan_spans(jspans + [lost])
    out = ledger.write_ledger(got, str(tmp_path / "RUNLEDGER_t.json"))
    with open(out) as fh:
        assert json.load(fh)["kind"] == "run-ledger"


def test_structured_logger_stamps_the_trace(tmp_path, capsys):
    from tsspark_tpu_torch.utils.logging import get_logger, timed

    log = get_logger("tsspark.test")
    prev = context.start_run(str(tmp_path / "spans.jsonl"))
    try:
        with context.span("stage.x") as sid:
            with timed(log, "block", n=3):
                pass
    finally:
        context.end_run(prev)
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["event"] == "block" and line["n"] == 3
    assert line["span_id"] == sid and line["seconds"] >= 0.0
    assert line["trace_id"] is not None


# ---------------------------------------------------------------------------
# CLI: obs report / ledger / prom, and perf's ledger input
# ---------------------------------------------------------------------------


def _tiny_run(tmp_path):
    prev = context.start_run(str(tmp_path / "spans.jsonl"))
    try:
        with context.span("stage.orchestrate"):
            with context.span("chunk.claim", lo=0, hi=8):
                pass
            context.record("chunk.fit", time.time(), 0.25, lo=0, hi=8,
                           width=8)
            context.record("chunk.land", time.time(), 0.001, lo=0, hi=8)
        context.record("registry.publish", time.time(), 0.01, version=1)
        context.record("registry.activate", time.time(), 0.001, version=1)
        context.record("serve.request", time.time(), 0.002, cached=1,
                       n_series=1, horizon=7, version=1)
        reg = metrics.MetricsRegistry()
        reg.counter("tsspark_fit_chunks_total").inc()
        reg.export(str(tmp_path / "metrics_t.json"),
                   trace_id=context.trace_id())
    finally:
        context.end_run(prev)
    with open(tmp_path / "times.jsonl", "w") as fh:
        fh.write(json.dumps({"lo": 0, "hi": 8, "fit_s": 0.25, "t": 0.3,
                             "width": 8, "series_per_s": 32.0}) + "\n")


def test_obs_cli_ledger_report_and_prom(tmp_path, capsys):
    _tiny_run(tmp_path)
    out = str(tmp_path / "RUNLEDGER_t.json")
    assert obs_main(["ledger", str(tmp_path), "-o", out]) == 0
    assert obs_main(["report", out]) == 0
    text = capsys.readouterr().out
    assert "orphan spans: 0" in text
    assert "chunk.claim" in text and "serve.request" in text
    assert "serve.first_cache_hit" in text
    assert "registry.publish" in text
    # The timeline reads in pipeline order from one joined trace.
    assert text.index("chunk.claim") < text.index("registry.publish")

    assert obs_main(["prom", out]) == 0
    assert "tsspark_fit_chunks_total 1" in capsys.readouterr().out
    trace = str(tmp_path / "trace.json")
    assert obs_main(["report", out, "--chrome-trace", trace]) == 0
    with open(trace) as fh:
        evs = json.load(fh)["traceEvents"]
    assert {e["name"] for e in evs} >= {"chunk.claim", "serve.request"}


def test_perf_cli_accepts_run_ledger(tmp_path, capsys):
    _tiny_run(tmp_path)
    out = str(tmp_path / "RUNLEDGER_t.json")
    obs_main(["ledger", str(tmp_path), "-o", out])
    capsys.readouterr()
    assert perf_main([out]) == 0
    text = capsys.readouterr().out
    assert "chunks fitted:     1" in text
    assert "series/s by chunk size:" in text


_TIMES = [
    {"lo": 0, "hi": 128, "fit_s": 2.0, "width": 128, "live": 128,
     "series_per_s": 64.0, "compile_miss": True, "t": 2.1},
    {"lo": 128, "hi": 256, "fit_s": 0.5, "width": 128, "live": 128,
     "series_per_s": 256.0, "compile_miss": False, "t": 2.7},
    {"phase2_s": 1.0, "stragglers": 10},
]


def test_perf_main_over_bench_json_and_dir(tmp_path, capsys):
    bench = {"metric": "m", "value": 1.0,
             "extra": {"perf": summarize_times(_TIMES)}}
    p = tmp_path / "BENCH_x.json"
    p.write_text(json.dumps(bench))
    assert perf_main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "chunks fitted:     2" in out
    assert "first chunk flush: 2.1 s" in out

    d = tmp_path / "out"
    d.mkdir()
    with open(d / "times.jsonl", "w") as fh:
        for row in _TIMES:
            fh.write(json.dumps(row) + "\n")
    (d / "autotune.json").write_text(json.dumps({"chunk": 128}))
    assert perf_main([str(d)]) == 0
    assert "autotuned chunk:   128" in capsys.readouterr().out
    assert perf_main([str(d), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["autotune"] == {
        "chunk": 128}


def test_obs_cli_history_and_sentinel(tmp_path, capsys):
    hpath = str(tmp_path / "RUNHISTORY.jsonl")
    rep = tmp_path / "BENCH_x.json"
    rep.write_text(json.dumps(_bench_report("t0", 60.0)))
    assert obs_main(["history", str(tmp_path), "--history", hpath,
                     "--ingest", str(rep)]) == 0
    assert "ingest" in capsys.readouterr().out
    assert len(history.read_history(hpath)) == 1
    assert obs_main(["sentinel", str(rep), "--history", hpath,
                     "--out", str(tmp_path / "REGRESSION_t.json")]) == 0
    assert os.path.exists(tmp_path / "REGRESSION_t.json")


# ---------------------------------------------------------------------------
# live watch
# ---------------------------------------------------------------------------


def _write_span(path, name, t0, dur_s, trace="tw", **attrs):
    append_line(path, json.dumps({
        "kind": "span", "trace_id": trace,
        "span_id": os.urandom(4).hex(), "parent_id": None,
        "name": name, "t0": t0, "dur_s": dur_s, "status": "ok",
        "pid": 1, "attrs": attrs,
    }))


def _bench_report(trace, series_per_s, device=CARD,
                  workload="m5_512x256_fit_wall_clock"):
    return {
        "metric": workload, "value": 8.0, "unit": "s",
        "vs_baseline": 0.1,
        "extra": {
            "trace_id": trace, "numerics_rev": 7,
            "device": device, "series_per_s": series_per_s,
            "series_done": 512, "complete": True, "datagen_s": 3.0,
            "perf": {"first_flush_s": 5.0, "compile_misses": 2},
        },
    }


def test_watch_once_records_breach_into_the_trace(tmp_path):
    scratch = tmp_path / "run"
    scratch.mkdir()
    spans = str(scratch / "spans.jsonl")
    # A slow in-flight run: 20 series landed over a 10 s window.
    _write_span(spans, "stage.orchestrate", 1000.0, 20.0)
    _write_span(spans, "chunk.land", 1000.0, 1.0, lo=0, hi=10)
    _write_span(spans, "chunk.land", 1009.0, 1.0, lo=10, hi=20)
    # The run's workers stamp the card into times.jsonl; the live
    # baseline must scope to that device class — the CPU rows below
    # would otherwise distort the median.
    append_line(str(scratch / "times.jsonl"),
                json.dumps({"lo": 0, "hi": 10, "fit_s": 1.0,
                            "device": CARD}))
    hpath = str(tmp_path / "RUNHISTORY.jsonl")
    for i in range(3):
        history.ingest(_bench_report(f"t{i}", 60.0), hpath)
    for i in range(3):
        history.ingest(_bench_report(f"cpu{i}", 600.0, device="cpu"),
                       hpath)

    st = watch.observe_run(str(scratch), history.read_history(hpath),
                           slo=regress.load_slo(REPO))
    assert watch._scratch_device(str(scratch)) == CARD
    assert history.device_class(CARD) == "gpu"
    assert st["series_done"] == 20
    assert st["series_per_s"] == 2.0
    assert [c["metric"] for c in st["breaches"]] == ["series_per_s"]
    assert st["breaches"][0]["median"] == 60.0  # the card's baseline only

    out_lines = []
    rc = watch.watch(str(scratch), history_path=hpath, once=True,
                     emit=out_lines.append)
    assert rc == 1
    assert any("SLO:BREACH" in ln for ln in out_lines)
    # The breach landed in the run's OWN trace (joinable by the ledger).
    recs = context.read_records(spans)
    breaches = [r for r in recs if r.get("kind") == "event"
                and r.get("name") == "slo.breach"]
    assert len(breaches) == 1
    assert breaches[0]["trace_id"] == "tw"
    assert breaches[0]["attrs"]["metric"] == "series_per_s"
    # A healthy run (no baseline misses): clean pass, no event spam.
    rc2 = watch.watch(str(scratch),
                      history_path=str(tmp_path / "none.jsonl"),
                      once=True, emit=lambda s: None)
    assert rc2 == 0
    assert len([r for r in context.read_records(spans)
                if r.get("name") == "slo.breach"]) == 1
    # The CLI's one pass gives the same verdict.
    assert obs_main(["watch", str(scratch), "--history", hpath,
                     "--once"]) == 1


def test_watch_reads_serve_metrics_snapshot(tmp_path):
    scratch = tmp_path / "serve"
    scratch.mkdir()
    _write_span(str(scratch / "spans.jsonl"), "serve.request",
                1000.0, 0.002)
    snap = {
        "kind": "metrics-snapshot", "unix": 1001.0, "trace_id": "tw",
        "pid": 1,
        "metrics": {
            "counters": [
                {"name": "tsspark_serve_requests_total",
                 "labels": {"result": "completed"}, "value": 98},
                {"name": "tsspark_serve_requests_total",
                 "labels": {"result": "shed"}, "value": 2},
            ],
            "gauges": [
                {"name": "tsspark_serve_queue_depth", "value": 4.0},
                {"name": "tsspark_serve_breaker_open", "value": 0.0},
            ],
            "histograms": [],
        },
    }
    with open(scratch / "metrics_daemon.json", "w") as fh:
        json.dump(snap, fh)
    st = watch.observe_run(str(scratch))
    assert st["queue_depth"] == 4.0
    assert st["shed_rate"] == 0.02
    assert st["breaker"] == "closed"
    assert st["p99_ms"] == 2.0
    line = watch.format_line(dict(st, t_offset_s=0.0))
    assert "queue=4" in line and "breaker=closed" in line


def test_freshness_spans_reach_obs_watch(tmp_path):
    """The scheduler's refit.freshness spans are what `obs watch`
    reads: live trailing-window p95 appears in the observation."""
    scratch = tmp_path / "scr"
    scratch.mkdir()
    prev = context.start_run(str(scratch / "spans.jsonl"))
    try:
        now = time.time()
        for i, fr in enumerate((0.2, 0.5, 0.9)):
            context.record("refit.freshness", now - fr, fr, seq=i + 1,
                           version=2, probe="serve")
    finally:
        context.end_run(prev)
    st = watch.observe_run(str(scratch), [])
    assert st["freshness_p95_s"] == pytest.approx(0.86, abs=0.02)
