"""Host prep of the PyTorch port is BITWISE equal to the JAX package's:
``prepare_fit_data`` leaves and meta, seasonal features, conditions, the
predict-time time map and feature matrix, and the config fingerprint that
guards every registry both packages read."""

import dataclasses

import numpy as np
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.data.datasets import m5_like as jax_m5_like
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu.models.prophet import predict as jpredict
from tsspark_tpu.models.prophet import seasonality as jseason
from tsspark_tpu.utils import checkpoint as jckpt
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.models.prophet import design as tdesign
from tsspark_tpu_torch.models.prophet import predict as tpredict
from tsspark_tpu_torch.models.prophet import seasonality as tseason
from tsspark_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)


def _pair(**kw):
    """The same ProphetConfig in both packages."""
    def build(mod):
        kw2 = dict(kw)
        kw2["seasonalities"] = tuple(
            mod.SeasonalityConfig(**s) for s in kw.get("seasonalities", ())
        ) if "seasonalities" in kw else (mod.YEARLY, mod.WEEKLY)
        kw2["regressors"] = tuple(
            mod.RegressorConfig(**r) for r in kw.get("regressors", ())
        )
        return mod.ProphetConfig(**kw2)
    return build(jcfg), build(tcfg)


def _assert_same_prep(got, want):
    data_t, meta_t = got
    data_j, meta_j = want
    for f in data_j._fields:
        a, b = np.asarray(getattr(data_t, f)), np.asarray(getattr(data_j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in meta_j._fields:
        a, b = getattr(meta_t, f), getattr(meta_j, f)
        assert a.dtype == b.dtype == np.float64, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _irregular(b=12, t_len=90, seed=3):
    """Per-series grids with gaps and bursts, NaNs, a 1-obs series."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.25, 1.0, 1.0, 3.0], size=(b, t_len))
    ds = 18000.0 + np.cumsum(steps, axis=1) + rng.uniform(0, 30, (b, 1))
    y = 5 + np.sin(ds / 7.0) + rng.normal(0, 0.2, (b, t_len))
    y[rng.uniform(size=(b, t_len)) < 0.1] = np.nan
    y[0, 1:] = np.nan
    return ds, y


CASES = {
    "m5-default": lambda: (dict(), "m5", {}),
    "m5-quantile": lambda: (dict(changepoint_placement="quantile"), "m5", {}),
    "m5-regressors": lambda: (
        dict(regressors=({"name": "holiday"}, {"name": "price"},
                         {"name": "promo", "standardize": False})),
        "m5-reg", {}),
    "irregular-quantile": lambda: (
        dict(changepoint_placement="quantile", n_changepoints=8),
        "irregular", {}),
    "logistic-cap-floor": lambda: (dict(growth="logistic"), "m5",
                                   {"logistic": True}),
    "explicit-changepoints": lambda: (
        dict(changepoints=(13600.0, 13650.5, 13700.0)), "m5", {}),
    "conditional-weekly": lambda: (
        dict(seasonalities=({"name": "yearly", "period": 365.25,
                             "fourier_order": 4},
                            {"name": "weekly", "period": 7.0,
                             "fourier_order": 3,
                             "condition_name": "on_season"})),
        "m5", {"conditions": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_fit_data_bitwise(case):
    kw, data_kind, extra = CASES[case]()
    jc, tc = _pair(**kw)
    if data_kind == "irregular":
        ds, y = _irregular()
        regs = None
    else:
        batch = m5_like(64, 400, seed=2,
                        with_regressors=data_kind == "m5-reg")
        ds, y, regs = batch.ds, batch.y, batch.regressors
    b, t_len = np.asarray(y).shape
    kwargs = {}
    if regs is not None:
        kwargs["regressors"] = regs
    if extra.get("logistic"):
        rng = np.random.default_rng(1)
        kwargs["cap"] = np.nanmax(y, axis=1, keepdims=True) * 1.5 \
            + np.zeros((b, t_len))
        kwargs["floor"] = rng.uniform(0.0, 0.5, b)
    if extra.get("conditions"):
        kwargs["conditions"] = {
            "on_season": (np.arange(t_len)[None, :] % 10 < 6)
            .repeat(b, 0)
        }
    with np.errstate(all="ignore"):
        got = tdesign.prepare_fit_data(ds, y, tc, **kwargs)
        want = jdesign.prepare_fit_data(ds, y, jc, as_numpy=True, **kwargs)
    _assert_same_prep(got, want)


def test_m5_like_generator_matches():
    a = m5_like(40, 300, seed=5)
    b = jax_m5_like(40, 300, seed=5)
    for f in b._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


@pytest.mark.parametrize("grid", ["shared", "per-series"])
def test_seasonal_feature_matrix_and_conditions_bitwise(grid):
    rng = np.random.default_rng(0)
    ds = 18000.0 + np.arange(120) * 0.5
    if grid == "per-series":
        ds = ds[None, :] + rng.uniform(0, 400, (5, 1))
    seas_t = (tcfg.YEARLY, tcfg.WEEKLY, tcfg.DAILY)
    seas_j = (jcfg.YEARLY, jcfg.WEEKLY, jcfg.DAILY)
    a = tseason.seasonal_feature_matrix(ds, seas_t)
    b = jseason.seasonal_feature_matrix(ds, seas_j)
    np.testing.assert_array_equal(a, np.asarray(b))
    cond_t = (tcfg.YEARLY, dataclasses.replace(tcfg.WEEKLY,
                                               condition_name="c"))
    cond_j = (jcfg.YEARLY, dataclasses.replace(jcfg.WEEKLY,
                                               condition_name="c"))
    x_t = tseason.seasonal_feature_matrix(ds, cond_t)
    x_j = jseason.seasonal_feature_matrix(ds, cond_j)
    c = {"c": rng.uniform(size=(5, 120)) < 0.5}
    np.testing.assert_array_equal(
        tseason.apply_conditions(x_t, cond_t, c, 5),
        np.asarray(jseason.apply_conditions(x_j, cond_j, c, 5)),
    )
    assert tseason.auto_seasonalities(ds) == tuple(
        getattr(tcfg, s.name.upper()) for s in jseason.auto_seasonalities(ds)
    )


@pytest.mark.parametrize("grid", ["shared", "per-series"])
def test_prepare_predict_data_time_map_and_features_bitwise(grid):
    batch = m5_like(32, 400, seed=2, with_regressors=False)
    jc, tc = _pair()
    _, meta = tdesign.prepare_fit_data(batch.ds, batch.y, tc)
    _, jmeta = jdesign.prepare_fit_data(batch.ds, batch.y, jc,
                                        as_numpy=True)
    if grid == "shared":
        ds = np.concatenate([batch.ds, batch.ds[-1] + np.arange(1, 29)])
    else:
        last = meta.ds_start + meta.ds_span
        ds = last[:, None] + np.arange(1, 33)[None, :] * 1.0
    got = tpredict.prepare_predict_data(ds, meta, tc, torch.device("cpu"))
    want = jpredict.prepare_predict_data(ds, jmeta, jc)
    for f in ("t", "s", "cap", "X_season", "X_reg", "mult_mask",
              "prior_scales"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f,
        )


FINGERPRINT_CONFIGS = [
    dict(),
    dict(growth="logistic", n_changepoints=10),
    dict(changepoint_placement="quantile", interval_width=0.9,
         uncertainty_samples=500),
    dict(changepoints=(18000.0, 18100.5)),
    dict(seasonalities=({"name": "weekly", "period": 7.0,
                         "fourier_order": 2, "mode": "multiplicative",
                         "condition_name": "wk"},),
         regressors=({"name": "promo", "prior_scale": 3.0},),
         seasonality_mode="multiplicative"),
]


@pytest.mark.parametrize("i", range(len(FINGERPRINT_CONFIGS)))
def test_config_fingerprint_matches_the_jax_package(i):
    jc, tc = _pair(**FINGERPRINT_CONFIGS[i])
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tckpt.config_fingerprint(tc) == jckpt.config_fingerprint(jc)
    # The manifest round trip rebuilds an equal config in each package.
    assert tckpt._config_from_dict(dataclasses.asdict(jc)) == tc


def _plain(v):
    """A default with the port's / JAX package's dataclasses as dicts."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def test_config_classes_field_for_field():
    for name in ("SeasonalityConfig", "RegressorConfig", "ProphetConfig",
                 "SolverConfig", "McmcConfig", "AdviConfig",
                 "ShardingConfig"):
        a = [(f.name, _plain(f.default)) for f in
             dataclasses.fields(getattr(tcfg, name))]
        b = [(f.name, _plain(f.default)) for f in
             dataclasses.fields(getattr(jcfg, name))]
        assert a == b, name
    assert tcfg.NUMERICS_REV == jcfg.NUMERICS_REV == 7
