"""The port's holiday calendars (``tsspark_tpu_torch.models.holidays``)
against the JAX package's: every country's computed calendar for
2000-2030, the indicator features on daily and sub-daily grids with
windows, ``holidays_from_df``, the regressor columns and the config
``add_holidays`` builds are BITWISE the JAX package's (the module is a
numpy copy).  Then one fit: a holiday bump planted in the data is
recovered by the port's Forecaster on the CPU."""

import dataclasses

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models import holidays as jhol
from tsspark_tpu.utils import checkpoint as jck
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.models import holidays as thol
from tsspark_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

YEARS = range(2000, 2031)
COUNTRIES = sorted(jhol._COUNTRIES)


def _asdicts(hs):
    return [dataclasses.asdict(h) for h in hs]


def test_the_same_countries():
    assert sorted(thol._COUNTRIES) == COUNTRIES


@pytest.mark.parametrize("country", COUNTRIES)
def test_country_calendar_is_bitwise_jax(country):
    kw = dict(lower_window=-2, upper_window=1, prior_scale=3.0,
              mode="multiplicative")
    got = thol.country_holidays(country, YEARS, **kw)
    want = jhol.country_holidays(country, YEARS, **kw)
    assert _asdicts(got) == _asdicts(want)
    # And the features on a daily grid over the whole span, then on an
    # hourly grid of one year (every hour of a holiday matches).
    daily = thol.to_days(["2000-01-01"])[0] + np.arange(366 * 31.0)
    npt.assert_array_equal(thol.holiday_features(daily, got),
                           jhol.holiday_features(daily, want))
    hourly = thol.to_days(["2024-01-01"])[0] + np.arange(366 * 24) / 24.0
    f = thol.holiday_features(hourly, got)
    npt.assert_array_equal(f, jhol.holiday_features(hourly, want))
    assert f.dtype == np.float32 and f.shape[1] == 4 * len(got)


def test_unknown_country_raises_in_both():
    for mod in (jhol, thol):
        with pytest.raises(ValueError, match="unknown country"):
            mod.country_holidays("XX", [2024])


def test_to_days_and_holiday_validation_match():
    import datetime as dt

    dates = [dt.date(2024, 2, 29), dt.datetime(2024, 3, 1, 15, 30),
             "2024-12-25", np.datetime64("2025-01-01"),
             pd.Timestamp("2023-07-04 08:00"), 19000, 19000.5,
             np.int64(18000)]
    npt.assert_array_equal(thol.to_days(dates), jhol.to_days(dates))
    for kw, msg in ((dict(lower_window=1), "lower_window"),
                    (dict(upper_window=-1), "upper_window"),
                    (dict(mode="bogus"), "mode")):
        for mod in (jhol, thol):
            with pytest.raises(ValueError, match=msg):
                mod.Holiday("h", (1.0,), **kw)
    h = thol.Holiday("eve", (1.0,), lower_window=-2, upper_window=1)
    assert h.offsets == (-2, -1, 0, 1)


def test_holidays_from_df_and_columns_are_bitwise_jax():
    df = pd.DataFrame({
        "holiday": ["superbowl", "superbowl", "playoff", "playoff", "sale"],
        "ds": pd.to_datetime(["2023-02-12", "2024-02-11", "2023-01-15",
                              "2024-01-14", "2024-11-29"]),
        "lower_window": [0, 0, -1, -1, 0],
        "upper_window": [1, 1, 0, 0, 2],
    })
    got, want = thol.holidays_from_df(df), jhol.holidays_from_df(df)
    assert _asdicts(got) == _asdicts(want)
    ps = df.assign(prior_scale=[1.0, 1.0, 2.0, 2.0, 4.0])
    assert _asdicts(thol.holidays_from_df(ps, prior_scale=7.0)) == \
        _asdicts(jhol.holidays_from_df(ps, prior_scale=7.0))
    assert [dataclasses.asdict(c) for c in thol.holiday_column_configs(got)] \
        == [dataclasses.asdict(c) for c in jhol.holiday_column_configs(want)]
    grid = thol.to_days(["2023-01-01"])[0] + np.arange(730.0)
    npt.assert_array_equal(thol.holiday_features(grid, got),
                           jhol.holiday_features(grid, want))
    assert thol.holiday_features(grid, ()).shape == (730, 0)


def test_add_holidays_config_is_the_jax_config():
    got = thol.add_holidays(
        tcfg.ProphetConfig(regressors=(tcfg.RegressorConfig("price"),)),
        thol.country_holidays("GB", [2023, 2024], upper_window=1))
    want = jhol.add_holidays(
        jcfg.ProphetConfig(regressors=(jcfg.RegressorConfig("price"),)),
        jhol.country_holidays("GB", [2023, 2024], upper_window=1))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tck.config_fingerprint(got) == jck.config_fingerprint(want)
    names = [r.name for r in got.regressors]
    assert names[0] == "price" and "Boxing Day_+1" in names
    assert all(not r.standardize for r in got.regressors[1:])


def test_forecaster_recovers_a_planted_holiday_effect():
    from tsspark_tpu_torch import Forecaster

    rng = np.random.default_rng(1)
    n = 3 * 365
    ds = pd.date_range("2021-01-01", periods=n, freq="D")
    hols = thol.country_holidays("US", range(2021, 2025))
    days = thol.to_days(ds)
    bump = thol.holiday_features(days, hols).max(axis=1)
    frames = [pd.DataFrame({
        "series_id": f"s{i}", "ds": ds,
        "y": 10.0 + i + 0.003 * np.arange(n)
             + np.sin(2 * np.pi * np.arange(n) / 7.0)
             + 4.0 * bump + rng.normal(0, 0.2, n)}) for i in range(3)]
    cfg = tcfg.ProphetConfig(
        seasonalities=(tcfg.SeasonalityConfig("weekly", 7.0, 3),),
        n_changepoints=5)
    fc = Forecaster(cfg, tcfg.SolverConfig(max_iters=300), device="cpu",
                    holidays=hols).fit(pd.concat(frames, ignore_index=True))
    coef = fc.regressor_coefficients()
    # Each holiday's additive effect, in data units, near the planted 4.
    assert len(coef) == 3 * len(hols)
    assert np.abs(coef.coef.to_numpy() - 4.0).max() < 0.5
    # Holiday indicators need no future frame: predict extends them.
    out = fc.predict(horizon=40, num_samples=0)
    assert np.isfinite(out.yhat).all() and len(out) == 3 * 40
