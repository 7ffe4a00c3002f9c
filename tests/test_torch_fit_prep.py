"""The fit's transfer form against the JAX package: the host packing
(``pack_fit_data``, ``_bitpack_time``, ``_indicator_reg_cols``,
``packable_batch``) is BITWISE equal; the device-side ``unpack_fit_data``
and ``take_fit_data`` rebuild the same FitData.

``unpack_fit_data`` rebuilds ``t`` as ds_rel * t_inv_span - t_off in
float32 in both packages; XLA may contract that into one fused
multiply-add where torch rounds the product first, so ``t`` is held to
2 ulps of 1.0 (its values lie in [-1, 1.2]); everything else is exact.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from tsspark_tpu import config as jcfg
from tsspark_tpu.models.prophet import design as jdesign
from tsspark_tpu_torch import config as tcfg
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.models.prophet import design as tdesign

torch.set_num_threads(2)


def _cfgs(**kw):
    out = []
    for mod in (jcfg, tcfg):
        out.append(mod.ProphetConfig(
            seasonalities=(mod.SeasonalityConfig("yearly", 365.25, 8),
                           mod.SeasonalityConfig("weekly", 7.0, 3)),
            regressors=(mod.RegressorConfig("holiday", standardize=False),
                        mod.RegressorConfig("price"),
                        mod.RegressorConfig("promo", standardize=False)),
            n_changepoints=25, **kw))
    return out


@pytest.fixture(scope="module")
def m5():
    """A config-3-shaped batch: 40 series x 203 days (T not a multiple of
    8, so the bit-packing pads), onset-masked, with holiday, price and
    promo regressors."""
    return m5_like(40, 203, seed=3)


def _prepared(batch, cfg_j, cfg_t, ds=None):
    ds = batch.ds if ds is None else ds
    kw = dict(mask=batch.mask, regressors=batch.regressors)
    y = np.nan_to_num(batch.y)
    dj, mj = jdesign.prepare_fit_data(ds, y, cfg_j, as_numpy=True, **kw)
    dt, mt = tdesign.prepare_fit_data(ds, y, cfg_t, **kw)
    return (dj, mj), (dt, mt)


def _assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    npt.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("u8", [None, (0, 2), ()])
def test_pack_fit_data_is_bitwise_equal(m5, u8):
    cj, ct = _cfgs()
    (dj, mj), (dt, mt) = _prepared(m5, cj, ct)
    pj, uj = jdesign.pack_fit_data(dj, mj, m5.ds, reg_u8_cols=u8,
                                   collapse_cap=True)
    pt, ut = tdesign.pack_fit_data(dt, mt, m5.ds, reg_u8_cols=u8,
                                   collapse_cap=True)
    assert uj == ut
    if u8 is None:
        assert ut == (0, 2)  # holiday and promo are exact 0/1 columns
    assert pt._fields == pj._fields
    for f in pt._fields:
        _assert_bitwise(getattr(pt, f), getattr(pj, f))


def test_pack_rejects_what_the_transit_cannot_carry(m5):
    _, ct = _cfgs()
    _, (dt, mt) = _prepared(m5, *_cfgs())
    with pytest.raises(ValueError, match="non-0/1"):
        tdesign.pack_fit_data(dt, mt, m5.ds, reg_u8_cols=(1,))
    frac = dt._replace(mask=dt.mask * np.float32(0.5))
    with pytest.raises(ValueError, match="exact 0/1"):
        tdesign.pack_fit_data(frac, mt, m5.ds)
    with pytest.raises(ValueError, match="shared"):
        tdesign.pack_fit_data(dt, mt, np.broadcast_to(m5.ds, dt.y.shape))


@pytest.mark.parametrize("t_len,k", [(16, 2), (203, 3), (9, 1), (8, 0)])
def test_bitpack_and_indicator_cols_are_bitwise_equal(t_len, k):
    rng = np.random.default_rng(t_len)
    a = (rng.uniform(size=(5, t_len, k)) < 0.3).astype(np.float32)
    _assert_bitwise(tdesign._bitpack_time(a), jdesign._bitpack_time(a))
    back = tdesign._bitunpack_time(
        torch.from_numpy(tdesign._bitpack_time(a)), t_len)
    npt.assert_array_equal(back.numpy(), a.astype(np.uint8))
    x = np.concatenate([a, rng.normal(size=(5, t_len, 1)).astype(
        np.float32)], axis=-1)
    assert tdesign._indicator_reg_cols(x) == jdesign._indicator_reg_cols(x)


def test_packable_batch_matches():
    ds = np.arange(10.0)
    m01 = np.ones((2, 10))
    mfrac = m01 * 0.5
    for args in [(ds, None), (ds, m01), (ds, mfrac),
                 (np.broadcast_to(ds, (2, 10)), None)]:
        assert tdesign.packable_batch(*args) == jdesign.packable_batch(*args)


@pytest.mark.parametrize("growth", ["linear", "logistic"])
def test_unpack_fit_data_rebuilds_the_fitdata(m5, growth):
    cj, ct = _cfgs(growth=growth)
    cap = None if growth == "linear" else np.full(m5.y.shape, 1e3)
    y = np.nan_to_num(m5.y)
    kw = dict(mask=m5.mask, regressors=m5.regressors, cap=cap)
    dj, mj = jdesign.prepare_fit_data(m5.ds, y, cj, as_numpy=True, **kw)
    dt, mt = tdesign.prepare_fit_data(m5.ds, y, ct, **kw)
    collapse = growth != "logistic"
    pj, u8 = jdesign.pack_fit_data(dj, mj, m5.ds, collapse_cap=collapse)
    pt, _ = tdesign.pack_fit_data(dt, mt, m5.ds, collapse_cap=collapse)
    want = jdesign.unpack_fit_data(jdesign.PackedFitData(
        *(jnp.asarray(a) for a in pj)), u8)
    got = tdesign.unpack_fit_data(tdesign.packed_to_device(pt, "cpu"), u8)
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if f == "t":
            npt.assert_allclose(g, w, rtol=0, atol=2 * np.finfo(
                np.float32).eps)
            # And the plain path's host-float64 t, to the same order.
            npt.assert_allclose(g, dt.t, rtol=0, atol=4e-7)
        else:
            npt.assert_array_equal(g, w, err_msg=f)
    # The mask and the exact-0/1 columns survive the transit bit-exactly.
    npt.assert_array_equal(got.mask.numpy(), dt.mask)
    npt.assert_array_equal(got.y.numpy(), dt.y)
    npt.assert_array_equal(got.X_reg.numpy(), dt.X_reg)


def test_take_fit_data_matches(m5):
    cj, ct = _cfgs()
    (dj, _), (dt, _) = _prepared(m5, cj, ct)
    idx = np.array([5, 0, 7, 7, 39])
    want = jdesign.take_fit_data(jdesign.FitData(*map(jnp.asarray, dj)),
                                 jnp.asarray(idx))
    on = tdesign.fitdata_to_device(dt, "cpu")
    got = tdesign.take_fit_data(on, torch.from_numpy(idx))
    for f in got._fields:
        npt.assert_array_equal(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), err_msg=f)
    assert got.X_season.ndim == 2  # the shared calendar matrix is carried
    assert tdesign.PACKED_PER_SERIES_FIELDS \
        == jdesign.PACKED_PER_SERIES_FIELDS


def test_out_of_span_warning_once_per_batch():
    kw = dict(changepoints=(10.0, 50.0, 95.0), seasonalities=())
    ct = tcfg.ProphetConfig(**kw)
    ds = np.arange(100.0)
    y = np.ones((3, 100))
    y[0, :60] = np.nan  # row 0 starts after two of the changepoints
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tdesign.warn_out_of_span_changepoints(ct, ds, y, None)
        with tdesign.changepoint_span_warning_suppressed():
            tdesign.prepare_fit_data(ds, y, ct)
            tdesign.warn_out_of_span_changepoints(ct, ds, y, None)
    msgs = [str(r.message) for r in rec]
    assert len(msgs) == 1 and msgs[0].startswith("1 of 3 series")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tdesign.prepare_fit_data(ds, y, ct)
    assert len(rec) == 1
