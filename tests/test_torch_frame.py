"""The port's long-frame front end (``tsspark_tpu_torch.frame``) against
the JAX package's, on the CPU: the same seeded long frame goes through
``tsspark_tpu.Forecaster(backend="tpu")`` (JAX on the CPU) and
``tsspark_tpu_torch.Forecaster(backend="cuda", device="cpu")`` (the
kernels' plain versions).

Tolerances, with their reasons:
  * host transforms (the pivot, the future frame, the ``ds`` column, the
    arrays handed to the backend and their packed bytes) are BITWISE;
  * forecasts from one fitted state, carried across by the checkpoint
    (either package's ``save_forecaster`` loaded by the other's
    ``load_forecaster``), agree to float32 tolerance: |d| <= 1e-6 *
    y_scale (1e-6 for multiplicative blocks) + 1e-5 * |v|, the
    tolerance of tests/test_torch_serve.py for forecasts from one state
    (the two packages run float32 arithmetic in other orders); what is
    host numpy on identical inputs (changepoints, coefficients) is
    bitwise;
  * fits: per series the port's loss is no worse than the JAX package's
    by more than KEEP_BEST_MARGIN (0.05 nats), and the mean in-sample
    sMAPE is within 0.05 (tests/test_backends.py's parity budget);
  * the ``mcmc_samples`` route is held in distribution only (shapes,
    finiteness, ordered bands, the diagnostics' columns): its random
    streams are torch's, not JAX's.
"""

import dataclasses
import functools
import warnings

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import tsspark_tpu as jt
from tsspark_tpu import frame as jframe
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.utils import checkpoint as jck
import tsspark_tpu_torch as tt
from tsspark_tpu_torch import frame as tframe
from tsspark_tpu_torch.models import holidays as thol
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import params as tparams
from tsspark_tpu_torch.models.prophet import predict as tpredict
from tsspark_tpu_torch.models.prophet import trend as ttrend
from tsspark_tpu_torch.models.prophet.model import KEEP_BEST_MARGIN
from tsspark_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

B, N_DAYS, N_TRAIN, HORIZON = 8, 280, 252, 14
START = "2023-01-01"
SOLVER = dict(max_iters=200)


def _frame(seed=0):
    """B daily series with a trend, a weekly cycle that doubles in the
    "on" season, a price and a promo effect and a US-holiday bump;
    series i starts 5 i days late (ragged onsets), and a fifth of the
    rows before day 120 are dropped (holes)."""
    rng = np.random.default_rng(seed)
    ds = pd.date_range(START, periods=N_DAYS, freq="D")
    t = np.arange(N_DAYS, dtype=np.float64)
    days = (ds - pd.Timestamp("1970-01-01")).days.to_numpy(np.float64)
    hol = tt.country_holidays("US", range(2022, 2025))
    bump = thol.holiday_features(days, hol).max(axis=1)
    on = ((t // 35) % 2).astype(np.float64)
    frames = []
    for i in range(B):
        level = 5.0 + 3.0 * i
        price = 1.0 + np.cumsum(rng.normal(0, 0.01, N_DAYS))
        promo = (rng.uniform(size=N_DAYS) < 0.1).astype(np.float64)
        y = (level * (1.0 + 0.002 * t)
             + 1.5 * np.sin(2 * np.pi * t / 7.0) * (1.0 + on)
             - 4.0 * (price - 1.0) + 1.0 * promo + 3.0 * bump
             + rng.normal(0, 0.3, N_DAYS))
        keep = (t >= 5 * i) & ~((t < 120) & (rng.uniform(size=N_DAYS) < 0.2))
        keep[N_TRAIN:] = True
        frames.append(pd.DataFrame({
            "series_id": f"s{i:02d}", "ds": ds[keep], "y": y[keep],
            "price": price[keep], "promo": promo[keep],
            "on_season": on[keep], "off_season": 1.0 - on[keep],
            "cap": np.full(keep.sum(), 3.0 * level),
        }))
    return pd.concat(frames, ignore_index=True)


@pytest.fixture(scope="module")
def frame():
    return _frame()


def _split(df):
    cut = pd.Timestamp(START) + pd.Timedelta(days=N_TRAIN)
    return df[df.ds < cut].reset_index(drop=True), df.drop(columns="y")


CASES = ("plain", "holidays_regressors", "auto_seasonality", "conditional",
         "quantile", "changepoints", "logistic")


def _case(name, m):
    """(config, Forecaster keywords) of a case, in package ``m``'s types."""
    weekly = m.SeasonalityConfig("weekly", 7.0, 3)
    base = dict(seasonalities=(weekly,), n_changepoints=8)
    kw = {}
    if name == "plain":
        cfg = m.ProphetConfig(**base)
    elif name == "holidays_regressors":
        cfg = m.ProphetConfig(**base, regressors=(
            m.RegressorConfig("price"),
            m.RegressorConfig("promo", standardize=False)))
        kw = dict(holidays=m.country_holidays("US", range(2022, 2025),
                                              lower_window=-1))
    elif name == "auto_seasonality":
        cfg = m.ProphetConfig(n_changepoints=8)
        kw = dict(auto_seasonality=True)
    elif name == "conditional":
        cfg = m.ProphetConfig(n_changepoints=8, seasonalities=(
            m.SeasonalityConfig("weekly_on", 7.0, 3,
                                condition_name="on_season"),
            m.SeasonalityConfig("weekly_off", 7.0, 3,
                                condition_name="off_season")))
    elif name == "quantile":
        cfg = m.ProphetConfig(**base, changepoint_placement="quantile")
    elif name == "changepoints":
        cfg = m.ProphetConfig(**base)
        kw = dict(changepoints=["2023-03-01", "2023-05-15", "2023-08-01"])
    else:
        cfg = m.ProphetConfig(**base, growth="logistic")
        kw = dict(cap_col="cap")
    return cfg, kw


def _forecasters(name):
    cfg_j, kw_j = _case(name, jt)
    cfg_t, kw_t = _case(name, tt)
    jfc = jt.Forecaster(cfg_j, jt.SolverConfig(**SOLVER), backend="tpu",
                        **kw_j)
    tfc = tt.Forecaster(cfg_t, tt.SolverConfig(**SOLVER), backend="cuda",
                        device="cpu", **kw_t)
    return jfc, tfc


@functools.lru_cache(maxsize=None)
def _fitted(name):
    train, fut = _split(_frame())
    jfc, tfc = _forecasters(name)
    jfc.fit(train)
    with warnings.catch_warnings():
        # No copy warning from a read-only (holiday) regressor view.
        warnings.simplefilter("error", UserWarning)
        tfc.fit(train)
    jout = jfc.predict(future_df=fut, num_samples=0)
    tout = tfc.predict(future_df=fut, num_samples=0)
    return jfc, tfc, jout, tout


def _smape_train(out, df):
    m = out.merge(df[["series_id", "ds", "y"]], on=["series_id", "ds"])
    m = m[m.ds < pd.Timestamp(START) + pd.Timedelta(days=N_TRAIN)]
    err = (np.abs(m.y - m.yhat) / (np.abs(m.y) + np.abs(m.yhat) + 1e-8))
    return err.groupby(m.series_id).mean().to_numpy()


def _assert_forecasts_close(got, want, y_scale, mult_keys=(),
                            trend64=None):
    """``got`` / ``want`` long forecast frames over the same rows.

    ``trend64`` (B, T), the logistic trend of the same state in float64:
    the logistic offsets' recursion divides by the rates k_j, so where a
    fitted k_j nears 0 each package's float32 trend parts from the
    float64 one by far more than the tolerance, each by its own sums.
    There a series' trend is held to be no further from float64 than
    the reference's, and ``yhat - trend`` to the tolerance."""
    assert list(got.columns) == list(want.columns)
    npt.assert_array_equal(got.series_id.to_numpy(),
                           want.series_id.to_numpy())
    npt.assert_array_equal(got.ds.to_numpy(), want.ds.to_numpy())
    b = len(y_scale)
    t_len = len(got) // b
    scale = np.repeat(np.asarray(y_scale, np.float64), t_len)

    def close(g, w, atol):
        return np.abs(g - w) <= atol + 1e-5 * np.abs(w)

    col = lambda df, k: df[k].to_numpy(np.float64)  # noqa: E731
    for k in got.columns[2:]:
        g, w = col(got, k), col(want, k)
        ok = close(g, w, 1e-6 * (1.0 if k in mult_keys else scale))
        if trend64 is not None and k in ("trend", "yhat"):
            ok = np.repeat(_trend_rows_ok(
                ok.reshape(b, t_len), col(got, "trend").reshape(b, t_len),
                col(want, "trend").reshape(b, t_len), trend64, y_scale),
                t_len)
            assert close(g - col(got, "trend"), w - col(want, "trend"),
                         1e-6 * scale).all(), k
        assert ok.all(), k


def _trend_rows_ok(ok, got, want, trend64, y_scale):
    """Per series: within the tolerance (``ok``), or no further from the
    float64 trend than the reference (see _assert_forecasts_close)."""
    d_got = np.abs(got - trend64).max(axis=1)
    d_want = np.abs(want - trend64).max(axis=1)
    return ok.all(axis=1) | (d_got <= d_want + 1e-6 * np.asarray(y_scale))


def _logistic_trend64(fc, fut):
    """The logistic trend of ``fc``'s state on ``fut``'s grid in float64
    (the port's plain trend on float64 tensors), in data units."""
    b = tframe.pivot_long(fut, fc.id_col, fc.ds_col, y_col=fc.ds_col,
                          cap_col=fc.cap_col)
    meta = fc.state.meta
    data = tpredict.prepare_predict_data(
        b.ds, meta, fc.config, "cpu",
        cap=np.nan_to_num(b.cap).astype(np.float32))
    p = tparams.unpack(torch.as_tensor(fc.state.theta).double(), fc.config)
    tr = ttrend.logistic(data.t.double(), data.cap.double(), p.k, p.m,
                         p.delta, data.s.double()).numpy()
    return tr * meta.y_scale[:, None] + meta.floor[:, None]


def _mult_keys(cfg):
    return tuple(s.name for s in cfg.seasonalities if s.mode ==
                 "multiplicative") + ("multiplicative",)


# -- host transforms, bitwise -------------------------------------------------


def test_pivot_long_is_bitwise_the_jax_pivot(frame):
    df = frame.copy()
    df["floor"] = np.where(df.series_id == "s01", 0.5, 1.5)
    # A duplicated (series, ds) row: the last one wins in both.
    df = pd.concat([df, df.iloc[[3]].assign(y=-7.0)], ignore_index=True)
    args = ("series_id", "ds", "y", "cap", "floor", ("price", "promo"))
    want = jframe.pivot_long(df, *args)
    got = tframe.pivot_long(df, *args)
    assert got._fields == want._fields
    for f in want._fields:
        npt.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert np.asarray(getattr(got, f)).dtype == \
            np.asarray(getattr(want, f)).dtype, f
    assert got.y[0, 3] == -7.0
    # Numeric ds passes through; a null id raises in both.
    num = df.assign(ds=tframe._ds_to_days(df.ds))
    npt.assert_array_equal(tframe.pivot_long(num).ds,
                           jframe.pivot_long(num).ds)
    bad = df.copy()
    bad.loc[0, "series_id"] = None
    for mod in (jframe, tframe):
        with pytest.raises(ValueError, match="null values"):
            mod.pivot_long(bad)


def test_day_conversions_are_bitwise_the_jax_ones():
    days = np.array([0.0, 19358.0, 19358.5, 19358.041666666668, -3.25,
                     19358.0 + 1.0 / 86400.0])
    pd.testing.assert_series_equal(
        pd.Series(tframe._days_to_ts(days)), pd.Series(jframe._days_to_ts(days)))
    for res in ("s", "ms", "us", "ns"):
        ts = pd.Series(pd.date_range("2023-01-01", periods=5, freq="6h")
                       .as_unit(res))
        npt.assert_array_equal(tframe._ds_to_days(ts),
                               jframe._ds_to_days(ts))


@pytest.mark.parametrize("with_user_regressors", [False, True])
def test_backend_gets_the_jax_arrays_and_packs_the_same_bytes(
        frame, with_user_regressors):
    """The arrays each Forecaster hands its backend are the same bits
    (the port keeps the grid in float64, equal on a daily grid), and the
    port packs them into the JAX package's bytes: the holiday columns,
    a read-only broadcast view in the port, travel as u8 indicators."""
    train, _ = _split(frame)
    seen = {}
    fcs = []
    for tag, m, kw in (("jax", jt, dict(backend="tpu")),
                       ("port", tt, dict(backend="cuda", device="cpu"))):
        regs = (m.RegressorConfig("price"),
                m.RegressorConfig("promo", standardize=False))
        cfg = m.ProphetConfig(
            seasonalities=(m.SeasonalityConfig("weekly", 7.0, 3),),
            n_changepoints=5, regressors=regs if with_user_regressors else ())
        fc = m.Forecaster(cfg, m.SolverConfig(max_iters=2),
                          holidays=m.country_holidays("US", [2023, 2024]), **kw)

        def record(ds, y, tag=tag, **fkw):
            seen[tag] = (ds, y, fkw)
            raise StopIteration

        fc.backend.fit = record
        with pytest.raises(StopIteration):
            fc.fit(train)
        fcs.append(fc)
    jds, jy, jkw = seen["jax"]
    tds, ty, tkw = seen["port"]
    assert tds.dtype == np.float64 and ty.dtype == np.float32
    npt.assert_array_equal(tds, np.asarray(jds, np.float64))
    npt.assert_array_equal(ty, np.asarray(jy))
    treg, jreg = tkw["regressors"], np.asarray(jkw["regressors"])
    assert treg.dtype == np.float32
    npt.assert_array_equal(treg, jreg)
    if not with_user_regressors:
        assert not treg.flags.writeable and treg.strides[0] == 0
    u8 = tdesign._indicator_reg_cols(treg)
    assert u8 == jdesign._indicator_reg_cols(jreg)
    n_user = 2 if with_user_regressors else 0
    assert set(range(n_user, treg.shape[-1])) <= set(u8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        dt, mt = tdesign.prepare_fit_data(tds, ty, fcs[1].config,
                                          regressors=treg)
        pt, ut = tdesign.pack_fit_data(dt, mt, tds, reg_u8_cols=u8)
    dj, mj = jdesign.prepare_fit_data(tds, np.asarray(jy), fcs[0].config,
                                      as_numpy=True, regressors=jreg)
    pj, uj = jdesign.pack_fit_data(dj, mj, tds, reg_u8_cols=u8)
    assert ut == uj
    for f in pj._fields:
        a, b = getattr(pj, f), getattr(pt, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


# -- fits against the JAX package --------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_fit_within_the_budget_of_the_jax_fit(frame, case):
    jfc, tfc, jout, tout = _fitted(case)
    assert tfc.backend.device.type == "cpu"
    assert tfc.state.theta.shape == (B, tfc.config.num_params)
    assert np.isfinite(tfc.state.loss).all()
    assert np.all(tfc.state.loss
                  <= np.asarray(jfc.state.loss) + KEEP_BEST_MARGIN)
    s_port, s_jax = _smape_train(tout, frame), _smape_train(jout, frame)
    assert abs(s_port.mean() - s_jax.mean()) < 0.05
    assert dataclasses.asdict(tfc.config) == dataclasses.asdict(jfc.config)
    npt.assert_array_equal(tfc.series_ids, jfc.series_ids)
    npt.assert_array_equal(tfc._train_ds, jfc._train_ds)
    assert tfc._freq_days == jfc._freq_days
    for f in ("changepoints", "ds_start", "ds_span", "y_scale", "floor",
              "reg_mean", "reg_std"):
        npt.assert_array_equal(getattr(tfc.state.meta, f),
                               np.asarray(getattr(jfc.state.meta, f)),
                               err_msg=f)


def test_auto_seasonality_rebuilds_the_backend_on_its_device():
    _, tfc, _, _ = _fitted("auto_seasonality")
    names = [s.name for s in tfc.config.seasonalities]
    assert names == ["weekly"]  # 252 daily days: no yearly, no daily
    assert tfc.backend.config is tfc.config
    assert tfc.backend.device.type == "cpu"
    assert tfc._model().device.type == "cpu"


def test_future_frame_and_horizon_grid_are_bitwise_jax(frame):
    jfc, tfc, _, _ = _fitted("plain")
    for hist in (False, True):
        pd.testing.assert_frame_equal(
            tfc.make_future_frame(HORIZON, include_history=hist),
            jfc.make_future_frame(HORIZON, include_history=hist),
            check_exact=True)
    tout = tfc.predict(horizon=HORIZON, num_samples=0)
    jout = jfc.predict(horizon=HORIZON, num_samples=0)
    pd.testing.assert_series_equal(tout.ds, jout.ds, check_exact=True)
    assert tout.ds.min() == pd.Timestamp(START) + pd.Timedelta(days=N_TRAIN)


# -- one state carried across by the checkpoint ------------------------------


@pytest.mark.parametrize("case", CASES)
def test_jax_checkpoint_predicts_the_same_in_the_port(tmp_path, case):
    jfc, _, jout, _ = _fitted(case)
    _, fut = _split(_frame())
    path = str(tmp_path / "jax_model.npz")
    jck.save_forecaster(path, jfc)
    pfc = tck.load_forecaster(path, device="cpu")
    assert pfc.backend.name == "cuda" and pfc.backend.device.type == "cpu"
    assert tck.config_fingerprint(pfc.config) == \
        jck.config_fingerprint(jfc.config)
    npt.assert_array_equal(pfc.state.theta.numpy(),
                           np.asarray(jfc.state.theta))
    y_scale = np.asarray(jfc.state.meta.y_scale)
    mult = _mult_keys(jfc.config)
    trend64 = (_logistic_trend64(pfc, fut) if case == "logistic" else None)
    _assert_forecasts_close(pfc.predict(future_df=fut, num_samples=0), jout,
                            y_scale, mult, trend64)
    # Components from the same state.
    tds, tcomp = pfc.components(future_df=fut)
    jds, jcomp = jfc.components(future_df=fut)
    npt.assert_array_equal(np.asarray(tds), np.asarray(jds))
    assert sorted(tcomp) == sorted(jcomp)
    for k, v in jcomp.items():
        v = np.asarray(v, np.float64)
        atol = 1e-6 * (1.0 if k in mult else y_scale[:, None])
        ok = np.abs(tcomp[k] - v) <= atol + 1e-5 * np.abs(v)
        if trend64 is not None and k == "trend":
            ok = _trend_rows_ok(ok, tcomp[k], v, trend64, y_scale)
        assert ok.all(), k
    # Host numpy on identical inputs: bitwise.
    pd.testing.assert_frame_equal(pfc.changepoints_df("s03"),
                                  jfc.changepoints_df("s03"),
                                  check_exact=True)
    if jfc.config.regressors:
        pd.testing.assert_frame_equal(pfc.regressor_coefficients(),
                                      jfc.regressor_coefficients(),
                                      check_exact=True)


@pytest.mark.parametrize("case", ("holidays_regressors", "conditional",
                                  "logistic"))
def test_port_checkpoint_predicts_the_same_in_jax(tmp_path, case):
    _, tfc, _, tout = _fitted(case)
    _, fut = _split(_frame())
    path = str(tmp_path / "port_model")
    tck.save_forecaster(path, tfc)
    jfc = jck.load_forecaster(path)
    assert jfc.backend.name == "tpu"
    assert [dataclasses.asdict(h) for h in jfc.holidays] == \
        [dataclasses.asdict(h) for h in tfc.holidays]
    # Here the JAX package's forecast is the one held (``want`` is the
    # port's): on a row with a rate near 0 it is the further from float64.
    trend64 = (_logistic_trend64(tfc, fut) if case == "logistic" else None)
    jpred = jfc.predict(future_df=fut, num_samples=0)
    if trend64 is None:
        _assert_forecasts_close(jpred, tout, tfc.state.meta.y_scale,
                                _mult_keys(tfc.config))
    else:
        _assert_forecasts_close(tout, jpred, tfc.state.meta.y_scale,
                                _mult_keys(tfc.config), trend64)
    # And back into the port: the same bits as before the round trip.
    back = tck.load_forecaster(path, device="cpu")
    pd.testing.assert_frame_equal(back.predict(future_df=fut,
                                               num_samples=0), tout,
                                  check_exact=True)
    assert tck.load_extras(path) == {}


def test_forecast_bands_from_the_carried_state(tmp_path):
    """With sampling on, the bands come from torch's draws, not JAX's:
    ordered, and the deterministic columns are those of num_samples=0."""
    _, tfc, _, tout = _fitted("holidays_regressors")
    _, fut = _split(_frame())
    out = tfc.predict(future_df=fut, num_samples=64, seed=3)
    assert (out.yhat_lower <= out.yhat_upper).all()
    npt.assert_array_equal(out.yhat.to_numpy(), tout.yhat.to_numpy())
    s = tfc.predictive_samples(future_df=fut, num_samples=16)
    assert s["yhat_samples"].shape == (16, B, len(s["ds"]))
    assert np.isfinite(s["yhat_samples"]).all()
    npt.assert_array_equal(s["series_ids"], tfc.series_ids)


# -- the mcmc_samples route (distribution only) ------------------------------


MCMC = dict(num_samples=60, num_warmup=60, num_leapfrog=8)


@pytest.fixture(scope="module")
def mcmc_fits(frame):
    train, _ = _split(frame)
    cfg_j, _ = _case("plain", jt)
    cfg_t, _ = _case("plain", tt)
    jfc = jt.Forecaster(cfg_j, jt.SolverConfig(**SOLVER), backend="tpu",
                        mcmc_config=jt.McmcConfig(**MCMC)).fit(train)
    tfc = tt.Forecaster(cfg_t, tt.SolverConfig(**SOLVER), backend="cuda",
                        device="cpu", mcmc_samples=MCMC["num_samples"],
                        mcmc_config=tt.McmcConfig(**MCMC)).fit(train)
    return jfc, tfc


def test_mcmc_samples_route_in_distribution(mcmc_fits, tmp_path):
    jfc, tfc = mcmc_fits
    assert tfc.mcmc_state.samples.device.type == "cpu"
    out = tfc.predict(horizon=HORIZON)
    assert len(out) == B * HORIZON
    for k in ("yhat", "yhat_lower", "yhat_upper"):
        assert np.isfinite(out[k]).all(), k
    assert (out.yhat_lower <= out.yhat).all()
    assert (out.yhat <= out.yhat_upper).all()
    s = tfc.predictive_samples(horizon=HORIZON, num_samples=20)
    assert s["yhat_samples"].shape == (20, B, HORIZON)
    assert np.isfinite(s["yhat_samples"]).all()
    diag = tfc.mcmc_diagnostics()
    assert list(diag.columns) == list(jfc.mcmc_diagnostics().columns)
    assert len(diag) == B and np.isfinite(diag.rhat_max).all()
    assert ((diag.accept_rate >= 0) & (diag.accept_rate <= 1)).all()
    # The posterior draws survive the checkpoint, both ways.
    path = str(tmp_path / "mcmc")
    tck.save_forecaster(path, tfc)
    back = tck.load_forecaster(path, device="cpu")
    pd.testing.assert_frame_equal(back.predict(horizon=HORIZON), out,
                                  check_exact=True)
    j_back = jck.load_forecaster(path)
    npt.assert_array_equal(np.asarray(j_back.mcmc_state.samples),
                           tfc.mcmc_state.samples.numpy())
    assert j_back.mcmc_config == jfc.mcmc_config
    jck.save_forecaster(str(tmp_path / "jmcmc"), jfc)
    from_jax = tck.load_forecaster(str(tmp_path / "jmcmc"), device="cpu")
    npt.assert_array_equal(from_jax.mcmc_state.samples.numpy(),
                           np.asarray(jfc.mcmc_state.samples))
    assert np.isfinite(from_jax.predict(horizon=HORIZON).yhat).all()


def test_mcmc_settings_must_agree():
    cfg, _ = _case("plain", tt)
    with pytest.raises(ValueError, match="conflicts"):
        tt.Forecaster(cfg, device="cpu", mcmc_samples=10,
                      mcmc_config=tt.McmcConfig(num_samples=20))
    fc = tt.Forecaster(cfg, device="cpu", mcmc_samples=10)
    assert fc.mcmc_config == tt.McmcConfig(num_samples=10)


def test_guards_match_the_jax_front_end():
    """The same refusals, with the same messages, in both packages."""
    _, tfc, _, _ = _fitted("holidays_regressors")
    jfc = _fitted("holidays_regressors")[0]
    for fc in (jfc, tfc):
        with pytest.raises(ValueError, match="external regressors"):
            fc.predict(horizon=3)
        with pytest.raises(TypeError, match="horizon must be an int"):
            fc.predict(pd.DataFrame())
        with pytest.raises(ValueError, match="was not fitted"):
            fc.changepoints_df("nope")
        with pytest.raises(ValueError, match="missing 1 training series"):
            fc.predict(future_df=_split(_frame())[1].query(
                "series_id != 's00'"))
    cfg, _ = _case("plain", tt)
    with pytest.raises(RuntimeError, match="fit before predict"):
        tt.Forecaster(cfg, device="cpu").predict(horizon=3)
    with pytest.raises(RuntimeError, match="no MCMC fit"):
        _fitted("plain")[1].mcmc_diagnostics()
