"""Eval config 5 (streaming refit) through the port against the JAX
package's runner, on the CPU: the frame, the runner's counts and sMAPE at
scale 0.2 (10 series x 150 days), the CLI; ``-m slow`` adds the readings
behind ``chip_smoke.STREAM_SMAPE_TOL`` at the published scale.

Tolerances, with their reasons:
  * the frame: bitwise (the same generator and draws);
  * warm, cold and forced-cold counts and micro-batches: equal;
  * mean forecast sMAPE (in percent, against the noise-free generator),
    warm and cold: within 0.01 of the JAX package's (measured: 0.188 and
    0.189 against 0.186 and 0.188) — float32 solver noise;
  * the replay: idempotent by the reference's rule, |delta| < 1e-3.
"""

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from tsspark_tpu.eval import configs as jconfigs  # noqa: E402
from tsspark_tpu_torch.eval import configs  # noqa: E402

SMAPE_BAND = 0.01


def test_frame_matches_the_reference_loop():
    """The vectorised frame holds the values the JAX package's per-series
    loop draws (one stream, series after series)."""
    n_series, n_days = 7, 150
    rng = np.random.default_rng(11)
    frames = []
    for i in range(n_series):
        t = np.arange(n_days, dtype=float)
        y = (20 * (i + 1) + 0.05 * t + 3 * np.sin(2 * np.pi * t / 7)
             + rng.normal(0, 0.5, n_days))
        frames.append(pd.DataFrame({"series_id": f"s{i}", "ds": t, "y": y}))
    ref = pd.concat(frames)
    got = configs.config5_frame(n_series, n_days)
    for col in ("series_id", "ds", "y"):
        assert np.array_equal(got[col].to_numpy(), ref[col].to_numpy())
    cut = configs.config5_batches(got, n_days)
    assert [len(b) for b in cut] == [n_series * 105] + [n_series * 15] * 3


def test_config5_matches_the_jax_runner():
    got = configs.config5_streaming(scale=0.2, device="cpu")
    want = jconfigs.config5_streaming(backend="tpu", scale=0.2)
    assert set(got) == set(want)
    for k in ("micro_batches", "warm_starts", "cold_starts", "n_series"):
        assert got[k] == want[k], k
    assert (got["warm_starts"], got["cold_starts"]) == (30, 10)
    gw, ww = got["warm_vs_cold"], want["warm_vs_cold"]
    assert gw["cold_starts_forced"] == ww["cold_starts_forced"] == 40
    for k in ("smape_warm", "smape_cold"):
        assert abs(gw[k] - ww[k]) <= SMAPE_BAND, (k, gw[k], ww[k])
    assert got["crash_replay"]["idempotent"]
    assert got["crash_replay"]["smape_delta_after_replay"] < 1e-3
    assert len(got["refit_latency"]["per_batch_s"]) == 4


def test_cli_runs_config5(monkeypatch, capsys):
    import json
    import sys

    monkeypatch.setattr(sys, "argv", ["configs", "5", "--device", "cpu",
                                      "--scale", "0.05"])
    configs.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config5"]["n_series"] == 2
    assert out["config5"]["micro_batches"] == 4


@pytest.mark.slow
def test_stream_smape_limit_readings():
    """The readings behind ``chip_smoke.STREAM_SMAPE_TOL`` at config 5's
    published scale (50 x 730; a few minutes): the per-series |delta|
    forecast sMAPE between sound runs (the JAX package's runner against
    the port's plain run, warm, cold and replayed) and of the planted
    faults against the sound port run.  The limit lies between them."""
    from tsspark_tpu.streaming import driver as jdriver
    from tsspark_tpu.streaming.source import InMemorySource as JSource
    from tsspark_tpu.config import (ProphetConfig as JC,
                                    SeasonalityConfig as JS,
                                    SolverConfig as JSol)

    n, d = configs.config5_size(1.0)
    df = configs.config5_frame(n, d)
    batches = configs.config5_batches(df, d)
    sids = [f"s{i}" for i in range(n)]
    jcfg = JC(seasonalities=(JS("weekly", 7.0, 3),), n_changepoints=10)

    def jrun(warm=True):
        sf = jdriver.StreamingForecaster(jcfg, JSol(max_iters=60),
                                         backend="tpu", warm_start=warm)
        sf.run(JSource(batches))
        return sf

    jw = jrun()
    j = {"warm": configs.forecast_smape(jw, sids),
         "cold": configs.forecast_smape(jrun(False), sids)}
    jw.process(batches[-1])
    j["replay"] = configs.forecast_smape(jw, sids)
    _, det = configs.config5_run("cuda", 1.0, "cpu", frame=df, warmup=False)
    readings = {f"port-jax {k}": float(np.abs(det[f"smape_{k}"]
                                              - j[k]).max())
                for k in ("warm", "cold", "replay")}
    readings["port warm-cold"] = float(np.abs(det["smape_warm"]
                                              - det["smape_cold"]).max())
    readings["jax warm-cold"] = float(np.abs(j["warm"] - j["cold"]).max())
    for name in chip_smoke.STREAM_FAULTS:
        fault = chip_smoke.stream5_fault_run(name, df)
        readings[f"fault {name}"] = float(np.abs(
            fault["smape_warm"] - det["smape_warm"]).max())
    print(readings)
    tol = chip_smoke.STREAM_SMAPE_TOL
    assert max(v for k, v in readings.items() if "fault" not in k) < tol
    assert readings["fault rolled"] > tol
