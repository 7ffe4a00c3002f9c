"""The port's run history and regression sentinel (``obs/history.py``,
``obs/regress.py``) against the JAX package's: the same synthetic reports
give exactly the same rows, verdicts and history files (pure Python, so
equality), and a card run's device string is a class of its own."""

import json
import os

import pytest

from tsspark_tpu.obs import context as jcontext
from tsspark_tpu.obs import history as jhistory
from tsspark_tpu.obs import regress as jregress
from tsspark_tpu_torch.obs import context as tcontext
from tsspark_tpu_torch.obs import history as thistory
from tsspark_tpu_torch.obs import regress as tregress

CARD = "cuda:0 (NVIDIA H100 80GB HBM3)"
#: Fields that carry the wall clock of the call, not the report.
VOLATILE_ROW = ("ingested_unix",)
VOLATILE_VERDICT = ("unix", "path", "history")


def _bench(trace, series_per_s, device="TFRT_CPU_0", complete=True):
    return {
        "metric": "m5_512x256_fit_wall_clock", "value": 8.0, "unit": "s",
        "vs_baseline": 0.1,
        "extra": {
            "trace_id": trace, "numerics_rev": 7, "device": device,
            "series_per_s": series_per_s, "series_done": 512,
            "complete": complete, "datagen_s": 3.0,
            "perf": {"first_flush_s": 5.0, "compile_misses": 2},
        },
    }


def _serve(trace, p99, device=CARD, n=200, pool=False, plane=None):
    rep = {
        "kind": "serve-loadgen", "unix": 1000.0, "trace_id": trace,
        "numerics_rev": 7, "device": device, "n_requests": n,
        "n_series": 48, "wall_s": 1.0, "requests_per_s": n / 1.0,
        "config_fingerprint": "abc", "git_rev": "0123456789",
        "engine": {
            "submitted": n, "completed": n - 4, "shed": 4, "failed": 0,
            "rejected": 0,
            "latency_ms": {"p50": 2.0, "p95": 5.0, "p99": p99,
                           "mean": 2.5, "max": p99},
            "batch_occupancy": {"mean_fill": 0.8},
        },
        "cache": {"hit_rate": 0.4, "hot_rate": 0.5},
        "dispatch": {"n_dispatches": 12, "compile_misses": 1,
                     "total_s": 0.5},
        "mix": {"horizons": [7, 14, 28], "seed": 0},
    }
    if pool:
        rep["pool"] = {"replicas": 2, "failovers": 3, "respawns": 1,
                       "wrong_version": 0, "fenced_seen": 0,
                       "flip": {"p99_ms": 40.0, "n_in_window": 50}}
    if plane is not None:
        rep["plane"] = plane
    return rep


REPORTS = {
    "bench_cpu": _bench("b1", 1000.0),
    "bench_incomplete": _bench("b2", 0.0, complete=False),
    "bench_untraced": {"n": 1, "cmd": "bench", "rc": 1, "tail": "",
                       "parsed": None},
    "serve_card": _serve("s1", 20.0),
    "serve_cpu": _serve("s2", 20.0, device="cpu"),
    "serve_pool": _serve("s3", 30.0, pool=True),
    "serveplane": _serve("s4", 10.0, plane={"hit_rate": 1.0}),
    "verdict": {"kind": "regression-verdict", "ok": True},
    "chaos": {"kind": "chaos-storm", "trace_id": "c1", "seed": 0,
              "profile": "pool", "ok": True,
              "mttr_s": {"replica-kill": 2.5}},
    "eval": {"kind": "eval-parity", "trace_id": "e1",
             "configs": {"config3": {"smape_tpu": 13.2,
                                     "smape_cpu": 13.1}}},
    "junk": {"hello": 1},
}


def _strip(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_classify_and_rows_equal_the_jax_packages(name):
    rep = REPORTS[name]
    assert thistory.classify(rep) == jhistory.classify(rep)
    got = thistory.row_from_report(rep, source=f"/x/{name}.json")
    want = jhistory.row_from_report(rep, source=f"/x/{name}.json")
    if want is None:
        assert got is None
        return
    assert _strip(got, VOLATILE_ROW) == _strip(want, VOLATILE_ROW)


@pytest.mark.parametrize("device,cls", [
    (CARD, "gpu"), ("cuda", "gpu"), ("cpu", "cpu"), ("TFRT_CPU_0", "cpu"),
    ("TPU_0(process=0)", "tpu"), (None, None), ("", None),
])
def test_device_class_names_the_card(device, cls):
    assert thistory.device_class(device) == cls
    assert thistory.device_class(device) == jhistory.device_class(device)


def _history(d, mod, reports):
    os.makedirs(d, exist_ok=True)
    path = str(d / "RUNHISTORY.jsonl")
    for rep in reports:
        mod.ingest(rep, path)
    return path


@pytest.mark.parametrize("p99,ok", [(20.0, True), (21.0, True),
                                    (200.0, False)])
def test_evaluate_gives_the_jax_packages_verdict(tmp_path, p99, ok):
    base = [_serve(f"b{i}", 20.0 + 0.1 * i) for i in range(5)]
    hp_t = _history(tmp_path / "t", thistory, base)
    hp_j = _history(tmp_path / "j", jhistory, base)
    rep = _serve("new", p99)
    got = tregress.evaluate(thistory.row_from_report(rep),
                            thistory.read_history(hp_t))
    want = jregress.evaluate(jhistory.row_from_report(rep),
                             jhistory.read_history(hp_j))
    assert _strip(got, VOLATILE_VERDICT) == _strip(want, VOLATILE_VERDICT)
    assert got["ok"] is ok
    assert got["checks"], "the serve budgets judged something"


def test_a_card_run_never_baselines_against_a_cpu_row(tmp_path):
    """Five fast CPU rows and a slow card row: the card row has no
    comparable baseline, so nothing is judged (and nothing breaches)."""
    cpu = [_serve(f"c{i}", 1.0, device="cpu") for i in range(5)]
    hp = _history(tmp_path, thistory, cpu)
    card = thistory.row_from_report(_serve("card", 500.0))
    verdict = tregress.evaluate(card, thistory.read_history(hp))
    assert verdict["baseline"]["n"] == 0 and verdict["ok"]
    cpu_row = thistory.row_from_report(_serve("c9", 500.0, device="cpu"))
    assert not tregress.evaluate(cpu_row,
                                 thistory.read_history(hp))["ok"]


def test_sentinel_report_writes_the_jax_packages_files(tmp_path):
    """The sentinel on both packages over the same sequence of reports:
    the same verdicts, the same history rows (the breached flag
    included), each verdict file beside its history."""
    seq = [_serve(f"r{i}", 20.0 + 0.2 * i) for i in range(5)]
    seq += [_serve("regress", 300.0), _serve("again", 20.5)]
    out = {}
    for tag, hist, reg in (("t", thistory, tregress),
                           ("j", jhistory, jregress)):
        d = tmp_path / tag
        d.mkdir()
        hp = str(d / "RUNHISTORY.jsonl")
        verdicts = []
        for i, rep in enumerate(seq):
            v = reg.sentinel_report(rep, history_path=hp,
                                    source=f"SERVE_{i}.json",
                                    out=str(d / f"REGRESSION_{i}.json"))
            verdicts.append(_strip(v, VOLATILE_VERDICT))
            assert os.path.exists(d / f"REGRESSION_{i}.json")
        rows = [_strip(r, VOLATILE_ROW) for r in hist.read_history(hp)]
        out[tag] = (verdicts, rows)
    assert out["t"] == out["j"]
    verdicts = out["t"][0]
    assert [v["ok"] for v in verdicts] == [True] * 5 + [False, True]
    assert out["t"][1][5]["breached"] == verdicts[5]["breaches"]


def test_summaries_and_slo_equal_the_jax_packages(tmp_path):
    assert tregress.load_slo() == jregress.load_slo()
    hp = _history(tmp_path, thistory, [_serve(f"b{i}", 20.0)
                                       for i in range(5)])
    for p99 in (20.0, 400.0):
        row = thistory.row_from_report(_serve(f"n{p99}", p99))
        v = tregress.evaluate(row, thistory.read_history(hp))
        v["path"] = "REGRESSION_x.json"
        assert tregress.summarize(v) == jregress.summarize(v)


def test_history_reader_tolerates_a_torn_tail(tmp_path):
    hp = _history(tmp_path, thistory, [_serve("a", 20.0),
                                       _serve("b", 21.0)])
    with open(hp, "a") as fh:
        fh.write('{"row_id": "serve:c", "kind": "se')
    rows = thistory.read_history(hp)
    assert [r["row_id"] for r in rows] == ["serve:a", "serve:b"]
    assert rows == [dict(json.loads(line)) for line in
                    open(hp).read().splitlines()[:2]]
    # Idempotent by trace id.
    assert thistory.ingest(_serve("a", 20.0), hp)[1] is False


def test_the_history_modules_bind_no_obs_run(tmp_path):
    """Ingesting and judging touch neither package's obs binding."""
    before = (jcontext.active(), jcontext.trace_id(),
              tcontext.active(), tcontext.trace_id())
    hp = str(tmp_path / "RUNHISTORY.jsonl")
    tregress.sentinel_report(_serve("z", 20.0), history_path=hp,
                             out=str(tmp_path / "REGRESSION_z.json"))
    assert (jcontext.active(), jcontext.trace_id(),
            tcontext.active(), tcontext.trace_id()) == before
