"""The port's cross-validation (``eval/backtest`` arrays and
``eval/diagnostics`` long frames) against the JAX package's, on the CPU.

Tolerances, with their reasons:
  * the cutoffs, the (series, cutoff) rows' masks, y and regressors each
    package hands its backend, the evaluation masks and the output
    frame's keys (series, ds, cutoff, y) are BITWISE: a recording
    backend stands in for both packages' fits;
  * ``performance_metrics`` of either module on the same CV result is
    BITWISE (host numpy / pandas on the same inputs); the per-window
    metrics of ``eval/backtest`` are float32 tolerance (rtol 1e-6): the
    JAX package sums them in float32, the port in float64;
  * the real CV fits: mean sMAPE over the (series, cutoff) windows within
    0.05 of the JAX package's (tests/test_backends.py's parity budget);
    the two batched solvers stop at float32 noise apart;
  * within the port, the frame CV is BITWISE the array CV on the same
    arrays, and the length-bucketed fit of the CV rows is within the
    fit budget of the unbucketed one.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import tsspark_tpu as jt
from tsspark_tpu.eval import backtest as jbt
from tsspark_tpu.eval import diagnostics as jdiag
import tsspark_tpu_torch as tt
from tsspark_tpu_torch.eval import backtest as tbt
from tsspark_tpu_torch.eval import diagnostics as tdiag
from tsspark_tpu_torch.frame import pivot_long

torch.set_num_threads(2)

B, N_DAYS = 8, 300


def _frame(seed=3):
    """B daily series, ragged onsets (series i starts 9 i days in), a
    price regressor."""
    rng = np.random.default_rng(seed)
    ds = pd.date_range("2023-01-01", periods=N_DAYS, freq="D")
    t = np.arange(N_DAYS, dtype=np.float64)
    frames = []
    for i in range(B):
        price = 1.0 + np.cumsum(rng.normal(0, 0.01, N_DAYS))
        y = (10.0 + 2 * i + 0.03 * t + 2.0 * np.sin(2 * np.pi * t / 7.0)
             - 3.0 * (price - 1.0) + rng.normal(0, 0.3, N_DAYS))
        keep = t >= 9 * i
        frames.append(pd.DataFrame({"series_id": f"s{i}", "ds": ds[keep],
                                    "y": y[keep], "price": price[keep]}))
    return pd.concat(frames, ignore_index=True)


@pytest.fixture(scope="module")
def frame():
    return _frame()


def _cfg(m, regressors=True):
    return m.ProphetConfig(
        seasonalities=(m.SeasonalityConfig("weekly", 7.0, 3),),
        n_changepoints=5,
        regressors=(m.RegressorConfig("price"),) if regressors else ())


@pytest.mark.parametrize("args", [(14.0, 7.0, 42.0), (28.0, 14.0, 84.0),
                                  (3.5, 30.0, 10.0), (10.0, 3.0, 250.0)])
def test_make_cutoffs_is_bitwise_jax(args):
    ds = 19000.0 + np.arange(300.0)
    npt.assert_array_equal(tbt.make_cutoffs(ds, *args),
                           jbt.make_cutoffs(ds, *args))
    for mod in (jbt, tbt):
        with pytest.raises(ValueError, match="no valid cutoffs"):
            mod.make_cutoffs(np.arange(100.0), 30, 15, 180)


class _Recorder:
    """A stand-in backend: records what the backtest hands ``fit`` and
    forecasts yhat = row + ds / 1e3 (float32), bands at -+1."""

    name = "recorder"

    def __init__(self, seen):
        self.seen = seen

    def fit(self, ds, y, mask=None, regressors=None, cap=None, **kw):
        self.seen["fit"] = dict(ds=np.asarray(ds), y=np.asarray(y),
                                mask=np.asarray(mask),
                                regressors=None if regressors is None
                                else np.asarray(regressors))
        return np.asarray(y).shape[0]

    def predict(self, rows, ds, **kw):
        ds = np.asarray(ds, np.float64)
        yhat = (np.arange(rows)[:, None] + ds[None, :] / 1e3).astype(
            np.float32)
        return {"yhat": yhat, "yhat_lower": yhat - 1.0,
                "yhat_upper": yhat + 1.0}


def _recorded_cv(mod, monkeypatch, batch, reg):
    seen = {}
    monkeypatch.setattr(mod, "get_backend",
                        lambda *a, **k: _Recorder(seen))
    cv = mod.cross_validation(batch.ds, batch.y, None, horizon=14.0,
                              period=21.0, initial=60.0, regressors=reg,
                              mask=np.isfinite(batch.y) * 1.0)
    return seen["fit"], {k: np.asarray(v) for k, v in cv.items()}


def test_cv_rows_masks_and_windows_are_bitwise_jax(frame, monkeypatch):
    batch = pivot_long(frame, regressor_cols=("price",))
    fj, cvj = _recorded_cv(jbt, monkeypatch, batch, batch.regressors)
    ft, cvt = _recorded_cv(tbt, monkeypatch, batch, batch.regressors)
    assert sorted(cvt) == sorted(cvj)
    for k in ("y", "mask", "regressors"):
        assert ft[k].dtype == fj[k].dtype == np.float32, k
        npt.assert_array_equal(ft[k], fj[k], err_msg=k)
    # The grid stays float64 in the port (equal on a daily grid).
    assert ft["ds"].dtype == np.float64
    npt.assert_array_equal(ft["ds"], fj["ds"].astype(np.float64))
    # The rows' masks cut every series' history at each cutoff.
    c = len(cvt["cutoffs"])
    assert ft["mask"].shape == (B * c, N_DAYS) and c >= 3
    assert (ft["mask"].reshape(B, c, N_DAYS)[:, 0].sum(1)
            < ft["mask"].reshape(B, c, N_DAYS)[:, -1].sum(1)).all()
    for k in ("cutoffs", "grid", "eval_mask", "y_true", "yhat",
              "yhat_lower", "yhat_upper"):
        npt.assert_array_equal(cvt[k], cvj[k], err_msg=k)
    for k in ("smape", "mae", "rmse", "coverage"):
        npt.assert_allclose(cvt[k], cvj[k], rtol=1e-6, err_msg=k)
    # performance_metrics on the same CV arrays: bitwise.
    assert tbt.performance_metrics(cvj) == jbt.performance_metrics(cvj)


@pytest.fixture(scope="module")
def cv_frames(frame):
    kw = dict(horizon="14D", period="21D", initial="60D")
    jfc = jt.Forecaster(_cfg(jt), jt.SolverConfig(max_iters=150),
                        backend="tpu")
    tfc = tt.Forecaster(_cfg(tt), tt.SolverConfig(max_iters=150),
                        backend="cuda", device="cpu")
    return jdiag.cross_validation(jfc, frame, **kw), \
        tdiag.cross_validation(tfc, frame, **kw), tfc


def test_cv_frame_against_jax(cv_frames):
    jcv, tcv, _ = cv_frames
    assert list(tcv.columns) == list(jcv.columns)
    for k in ("series_id", "ds", "cutoff", "y"):
        pd.testing.assert_series_equal(tcv[k], jcv[k], check_exact=True)
    assert tcv.cutoff.nunique() >= 3
    assert (tcv.yhat_lower <= tcv.yhat_upper).all()

    def smape(cv):
        e = 2 * np.abs(cv.y - cv.yhat) / (np.abs(cv.y) + np.abs(cv.yhat))
        return e.groupby([cv.series_id, cv.cutoff]).mean().to_numpy()

    s_port, s_jax = smape(tcv), smape(jcv)
    assert abs(s_port.mean() - s_jax.mean()) < 0.05
    gap = (tcv.ds - tcv.cutoff) / pd.Timedelta(days=1)
    assert (gap > 0).all() and (gap <= 14).all()


@pytest.mark.parametrize("rolling_window", [0.1, 0.0])
def test_performance_metrics_is_bitwise_jax(cv_frames, rolling_window):
    jcv, tcv, _ = cv_frames
    for cv in (jcv, tcv):
        got = tdiag.performance_metrics(cv, rolling_window=rolling_window)
        want = jdiag.performance_metrics(cv, rolling_window=rolling_window)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    pts = tdiag.point_metrics(tcv)
    pd.testing.assert_frame_equal(pts, jdiag.point_metrics(tcv),
                                  check_exact=True)
    for mod in (jdiag, tdiag):
        with pytest.raises(ValueError, match="unknown metrics"):
            mod.performance_metrics(tcv, metrics=("bogus",))


def test_frame_cv_is_bitwise_the_array_cv(frame, cv_frames):
    """The frame CV adds no arithmetic: on the same arrays, the array CV
    gives the same bits (and horizons as days or "14D" agree)."""
    _, tcv, tfc = cv_frames
    batch = pivot_long(frame, regressor_cols=("price",))
    cv = tbt.cross_validation(
        batch.ds, batch.y, tfc.config, horizon=14.0, period=21.0,
        initial=60.0, solver_config=tfc.backend.solver_config,
        regressors=batch.regressors, device="cpu")
    sel = cv["eval_mask"] > 0
    i, j, k = np.nonzero(sel)
    order = np.lexsort((k, j, i))  # series, cutoff, ds: the frame's order
    for col in ("yhat", "yhat_lower", "yhat_upper"):
        npt.assert_array_equal(tcv[col].to_numpy(),
                               cv[col][sel][order], err_msg=col)
    days = tdiag.cross_validation(
        tt.Forecaster(tfc.config, tfc.backend.solver_config, device="cpu"),
        frame, horizon=14, period=21, initial=60)
    pd.testing.assert_frame_equal(days, tcv, check_exact=True)


def test_length_buckets_on_the_cv_rows(frame):
    """The (series, cutoff) rows have different observed windows, so the
    cuda backend fits them in length buckets: mean sMAPE within 0.05 of
    the unbucketed fit (the buckets change only float32 sums)."""
    from tsspark_tpu_torch.backends.cuda import CudaBackend

    four = frame[frame.series_id.isin(["s0", "s1", "s2", "s3"])]
    batch = pivot_long(four, regressor_cols=("price",))
    kw = dict(horizon=14.0, period=14.0, initial=20.0)
    cut = tbt.make_cutoffs(batch.ds, **kw)
    mask = (np.isfinite(batch.y)[:, None, :]
            & (batch.ds[None, None, :] <= cut[None, :, None])).reshape(
                -1, N_DAYS).astype(np.float32)
    bk = CudaBackend(_cfg(tt), device="cpu")
    plan = bk._plan_length_buckets(np.repeat(batch.y, len(cut), 0), mask)
    assert plan is not None and len(plan) == 3
    kw.update(solver_config=tt.SolverConfig(max_iters=150),
              regressors=batch.regressors, device="cpu")
    bucketed = tbt.cross_validation(batch.ds, batch.y, _cfg(tt), **kw)
    whole = tbt.cross_validation(batch.ds, batch.y, _cfg(tt),
                                 length_buckets=1, **kw)
    assert np.isfinite(bucketed["yhat"]).all()
    assert abs(bucketed["smape"].mean() - whole["smape"].mean()) < 0.05


def test_cv_runs_on_the_card_or_raises(frame, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = pivot_long(frame)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbt.cross_validation(batch.ds, batch.y, _cfg(tt, False),
                             horizon=14.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdiag.cross_validation(tt.Forecaster(_cfg(tt, False)), frame,
                               horizon="14D")
