"""The port's user surface around the Forecaster, on the CPU: the
``python -m tsspark_tpu_torch`` CLI's four commands (``--device cpu``)
against the in-process Forecaster (the output files BITWISE: the same
bytes), the Spark adapter on a stub frame, the package's lazy exports
and the ``fit.prophet`` alias against the JAX package's names, the plots
under matplotlib's Agg backend, and the card-or-raise rule of every
entry point (no CPU fallback)."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import tsspark_tpu as jt
from tsspark_tpu.utils import checkpoint as jck
import tsspark_tpu_torch as tt
from tsspark_tpu_torch import __main__ as cli
from tsspark_tpu_torch.eval import diagnostics
from tsspark_tpu_torch.spark import SparkForecaster, forecast_spark
from tsspark_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--seasonality", "weekly", "--n-changepoints", "5",
         "--max-iters", "60"]


def _long_df(b=3, n=150, seed=0):
    rng = np.random.default_rng(seed)
    ds = pd.date_range("2024-01-01", periods=n, freq="D")
    t = np.arange(n)
    return pd.concat([pd.DataFrame({
        "series_id": f"s{i}", "ds": ds,
        "y": 8 + i + 0.05 * t + 2 * np.sin(2 * np.pi * t / 7)
             + rng.normal(0, 0.3, n)}) for i in range(b)], ignore_index=True)


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.csv"
    _long_df().to_csv(path, index=False)
    return str(path)


def _forecaster(holidays=(), **kw):
    cfg = tt.ProphetConfig(seasonalities=(tt.WEEKLY,), n_changepoints=5)
    return tt.Forecaster(cfg, tt.SolverConfig(max_iters=60), backend="cuda",
                         holidays=holidays, device="cpu", **kw)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _in_process(frame, path):
    cli._write_frame(frame, path)
    return _bytes(path)


def test_cli_forecast_is_the_in_process_forecaster(csv, tmp_path):
    out = str(tmp_path / "fc.csv")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tsspark_tpu_torch", "forecast", "--input",
         csv, "--horizon", "7", "--output", out, "--device", "cpu",
         *SMALL], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    df = cli._read_frame(csv)
    want = _forecaster().fit(df).predict(horizon=7)
    assert _bytes(out) == _in_process(want, str(tmp_path / "want.csv"))
    got = pd.read_csv(out, parse_dates=["ds"])
    assert len(got) == 3 * 7 and np.isfinite(got.yhat).all()


def test_cli_fit_predict_and_checkpoint(csv, tmp_path, capsys):
    model = str(tmp_path / "m.npz")
    assert cli.main(["fit", "--input", csv, "--model", model,
                     "--country-holidays", "US", "--device", "cpu",
                     *SMALL]) == 0
    said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert said == {"saved": model, "n_series": 3}
    out = str(tmp_path / "pred.csv")
    assert cli.main(["predict", "--model", model, "--horizon", "10",
                     "--include-history", "--output", out,
                     "--device", "cpu"]) == 0
    df = cli._read_frame(csv)
    years = range(df.ds.dt.year.min(), df.ds.dt.year.max() + 2)
    fc = _forecaster(holidays=tt.country_holidays("US", years)).fit(df)
    want = fc.predict(horizon=10, include_history=True)
    assert _bytes(out) == _in_process(want, str(tmp_path / "want.csv"))
    # The checkpoint names the backend as the JAX package does, and the
    # JAX package's loader reads it.
    with open(model[:-4] + ".json") as f:
        assert json.load(f)["forecaster"]["backend"] == "tpu"
    jfc = jck.load_forecaster(model)
    np.testing.assert_array_equal(np.asarray(jfc.state.theta),
                                  fc.state.theta.numpy())


def test_cli_backtest_is_the_in_process_cv(csv, tmp_path):
    pm_out, cv_out = str(tmp_path / "pm.csv"), str(tmp_path / "cv.csv")
    assert cli.main(["backtest", "--input", csv, "--horizon", "14",
                     "--period", "28", "--initial", "60", "--output",
                     pm_out, "--cv-output", cv_out, "--device", "cpu",
                     *SMALL]) == 0
    df = cli._read_frame(csv)
    cv = diagnostics.cross_validation(_forecaster(), df, horizon=14.0,
                                      period=28.0, initial=60.0)
    assert _bytes(cv_out) == _in_process(cv, str(tmp_path / "w_cv.csv"))
    assert _bytes(pm_out) == _in_process(
        diagnostics.performance_metrics(cv), str(tmp_path / "w_pm.csv"))


def test_cli_options_are_the_jax_clis_and_device(capsys):
    import re

    from tsspark_tpu import __main__ as jcli

    def options(mod, cmd):
        with pytest.raises(SystemExit):
            mod.main([cmd, "--help"])
        return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))

    for cmd in ("fit", "predict", "forecast", "backtest"):
        got, want = options(cli, cmd), options(jcli, cmd)
        assert got - {"--device"} == want, cmd
        assert "--device" in got, cmd


def test_entry_points_raise_without_a_card(csv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.ProphetConfig(seasonalities=(tt.WEEKLY,), n_changepoints=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Forecaster(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["forecast", "--input", csv, "--horizon", "3",
                  "--output", str(tmp_path / "x.csv"), *SMALL])
    # A checkpoint made on the CPU loads onto the card by default.
    model = str(tmp_path / "m")
    checkpoint.save_forecaster(model, _forecaster().fit(_long_df()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_forecaster(model)
    assert checkpoint.load_forecaster(
        model, device="cpu").backend.device.type == "cpu"


# -- the Spark adapter on a stub frame ---------------------------------------


class FakeSession:
    def createDataFrame(self, pdf):
        return FakeSparkFrame(pdf, self)


class FakeSparkFrame:
    def __init__(self, pdf, session=None):
        self._pdf = pdf
        self.sparkSession = session or FakeSession()

    def toPandas(self):
        return self._pdf.copy()


def test_spark_adapter_is_the_forecaster():
    df = _long_df()
    out = forecast_spark(FakeSparkFrame(df), _forecaster(), horizon=14)
    assert isinstance(out, FakeSparkFrame)
    want = _forecaster().fit(df).predict(horizon=14)
    pd.testing.assert_frame_equal(out.toPandas(), want, check_exact=True)
    with pytest.raises(TypeError, match="toPandas"):
        SparkForecaster(_forecaster()).fit(df)
    with pytest.raises(RuntimeError, match="before fit"):
        SparkForecaster(_forecaster()).predict(horizon=3)


# -- the package surface -----------------------------------------------------


def test_lazy_exports_are_the_jax_names_and_the_ports_objects():
    assert sorted(tt.__all__) == sorted(jt.__all__)
    assert set(tt._EXPORTS) == set(jt._EXPORTS)
    for name in tt.__all__:
        obj = getattr(tt, name)
        mod = getattr(obj, "__module__", None) or type(obj).__module__
        assert mod.startswith("tsspark_tpu_torch."), (name, mod)
    assert set(tt.__all__) <= set(dir(tt))
    assert tt.frame.Forecaster is tt.Forecaster
    with pytest.raises(AttributeError):
        tt.no_such_name  # noqa: B018


def test_package_import_is_lean():
    code = ("import sys; import tsspark_tpu_torch as t; "
            "lean = [m for m in ('torch', 'pandas') if m in sys.modules]; "
            "t.Forecaster; t.cross_validation; import torch, json; "
            "print(json.dumps([lean, torch.cuda.is_initialized()]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], False]


def test_fit_prophet_alias_names():
    from tsspark_tpu.fit import prophet as jp
    from tsspark_tpu_torch.fit import prophet as tp
    from tsspark_tpu_torch.models.prophet import model

    public = lambda m: {n for n in vars(m) if not n.startswith("_")  # noqa
                        and n not in ("annotations",)}
    assert public(tp) == public(jp)
    for n in public(tp):
        obj = getattr(tp, n)
        mod = getattr(obj, "__module__", None) or type(obj).__module__
        assert mod.startswith("tsspark_tpu_torch."), (n, mod)
    assert tp.ProphetModel is model.ProphetModel is tt.ProphetModel


# -- plots under Agg ---------------------------------------------------------


def test_plots_under_agg(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tsspark_tpu_torch import plot

    df = _long_df()
    fc = _forecaster().fit(df)
    out = fc.predict(horizon=14)
    ax = plot.plot_forecast(out, df, series_id="s1")
    assert ax.get_title() == "s1"
    plot.add_changepoints_to_plot(ax, fc, "s1", threshold=0.0)
    assert len(ax.get_lines()) >= 2 + 5
    ds, comps = fc.components(horizon=14)
    fig = plot.plot_components(comps, ds, series_index=2)
    assert len(fig.axes) == len(comps)
    cv = diagnostics.cross_validation(fc, df, horizon=14.0, period=28.0,
                                      initial=60.0)
    ax2 = plot.plot_cross_validation_metric(cv, metric="mae")
    assert ax2.get_ylabel() == "mae"
    fig.savefig(tmp_path / "c.png")
    with pytest.raises(ValueError, match="not present"):
        plot.plot_forecast(out, series_id="zz")
    with pytest.raises(ValueError, match="unknown metric"):
        plot.plot_cross_validation_metric(cv, metric="bogus")
    plt.close("all")
