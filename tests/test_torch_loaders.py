"""The port's real-format loaders (``tsspark_tpu_torch.data.loaders``)
against the JAX package's: the 5 tests of ``tests/test_loaders.py`` on
tiny files in the actual M5 (Kaggle) and M4 CSV layouts, each also
holding the port's ``SeriesBatch`` bitwise to the JAX package's on the
same temporary files.  (The real competition files are not in the
repository; a run on the real M5 waits for them.)"""

import numpy as np
import pandas as pd
import pytest
import torch

from tsspark_tpu.data import loaders as jloaders
from tsspark_tpu_torch.data import loaders

torch.set_num_threads(2)


def _same_batch(a, b):
    for f in ("ds", "y", "mask", "regressors", "cap"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert np.asarray(a.series_ids).dtype == np.asarray(b.series_ids).dtype
    np.testing.assert_array_equal(a.series_ids, b.series_ids)
    assert tuple(a.regressor_names) == tuple(b.regressor_names)


@pytest.fixture
def m5_files(tmp_path):
    # 3 series x 5 days in the Kaggle M5 layout.
    sales = pd.DataFrame({
        "id": ["A_1_CA_1_validation", "A_2_CA_1_validation",
               "B_1_TX_1_validation"],
        "item_id": ["A_1", "A_2", "B_1"],
        "dept_id": ["A", "A", "B"],
        "cat_id": ["A", "A", "B"],
        "store_id": ["CA_1", "CA_1", "TX_1"],
        "state_id": ["CA", "CA", "TX"],
        **{f"d_{k}": v for k, v in zip(
            range(1, 6),
            [[3, 0, 2], [1, 1, 0], [0, 2, 5], [4, 0, 1], [2, 3, 0]],
        )},
    })
    cal = pd.DataFrame({
        "date": pd.date_range("2016-01-01", periods=6, freq="D").astype(str),
        "wm_yr_wk": [11601, 11601, 11601, 11601, 11602, 11602],
        "d": [f"d_{k}" for k in range(1, 7)],
        "event_name_1": [None, "NewYear", None, None, None, None],
        "event_name_2": [None] * 6,
        "snap_CA": [1, 0, 1, 0, 0, 0],
        "snap_TX": [0, 0, 0, 1, 1, 0],
    })
    prices = pd.DataFrame({
        "store_id": ["CA_1", "CA_1", "CA_1", "TX_1"],
        "item_id": ["A_1", "A_1", "A_2", "B_1"],
        "wm_yr_wk": [11601, 11602, 11601, 11601],
        "sell_price": [2.5, 2.75, 1.0, 9.99],
    })
    paths = {}
    for name, frame in (("sales", sales), ("cal", cal), ("prices", prices)):
        p = tmp_path / f"{name}.csv"
        frame.to_csv(p, index=False)
        paths[name] = str(p)
    return paths


def test_load_m5(m5_files):
    batch = loaders.load_m5(
        m5_files["sales"], m5_files["cal"], m5_files["prices"]
    )
    assert batch.y.shape == (3, 5)  # calendar tail row d_6 dropped
    np.testing.assert_allclose(batch.y[0], [3, 1, 0, 4, 2])
    assert batch.ds[0] == 16801.0  # 2016-01-01 is epoch day 16801
    assert batch.regressor_names == ("holiday", "price", "promo")
    holiday, price, promo = (batch.regressors[..., i] for i in range(3))
    np.testing.assert_allclose(holiday[0], [0, 1, 0, 0, 0])
    np.testing.assert_allclose(price[0], [2.5, 2.5, 2.5, 2.5, 2.75])
    np.testing.assert_allclose(price[1], [1.0] * 5)
    np.testing.assert_allclose(promo[0], [1, 0, 1, 0, 0])
    np.testing.assert_allclose(promo[2], [0, 0, 0, 1, 1])
    _same_batch(batch, jloaders.load_m5(
        m5_files["sales"], m5_files["cal"], m5_files["prices"]))
    _same_batch(loaders.load_m5(m5_files["sales"], m5_files["cal"],
                                m5_files["prices"], n_series=2),
                jloaders.load_m5(m5_files["sales"], m5_files["cal"],
                                 m5_files["prices"], n_series=2))


def test_load_m5_without_prices(m5_files):
    batch = loaders.load_m5(m5_files["sales"], m5_files["cal"])
    np.testing.assert_allclose(batch.regressors[..., 1], 0.0)
    _same_batch(batch, jloaders.load_m5(m5_files["sales"], m5_files["cal"]))


def test_load_m4(tmp_path):
    df = pd.DataFrame({
        "V1": ["H1", "H2"],
        "V2": [10.0, 5.0],
        "V3": [11.0, 6.0],
        "V4": [12.0, np.nan],  # H2 is shorter
    })
    p = tmp_path / "Hourly-train.csv"
    df.to_csv(p, index=False)
    batch = loaders.load_m4(str(p), freq_hours=1.0)
    assert batch.y.shape == (2, 3)
    np.testing.assert_allclose(batch.y[0], [10, 11, 12])
    np.testing.assert_allclose(batch.y[1][1:], [5, 6])
    assert np.isnan(batch.y[1][0]) and batch.mask[1][0] == 0.0
    np.testing.assert_allclose(np.diff(batch.ds), 1 / 24.0)
    _same_batch(batch, jloaders.load_m4(str(p), freq_hours=1.0))
    _same_batch(loaders.load_m4(str(p), freq_hours=24.0, start_day=100.0),
                jloaders.load_m4(str(p), freq_hours=24.0, start_day=100.0))


def test_loaded_batch_imports_into_plane(m5_files, tmp_path):
    """Real CSV data rides the same manifest as the generators: load ->
    import_batch -> open_batch round-trips bitwise, content-hash keyed;
    the JAX package's ``open_batch`` reads the port's import."""
    from tsspark_tpu.data import plane as jplane
    from tsspark_tpu_torch.data import plane

    batch = loaders.load_m5(
        m5_files["sales"], m5_files["cal"], m5_files["prices"]
    )
    root = str(tmp_path / "plane")
    d = plane.import_batch(batch, "m5_csv", root=root, shard_rows=2)
    assert plane.is_complete(d)
    got = plane.open_batch(d)
    ref = plane.batch_columns(batch)
    np.testing.assert_array_equal(np.asarray(got.y), ref["y"])
    np.testing.assert_array_equal(np.asarray(got.mask), ref["mask"])
    np.testing.assert_array_equal(np.asarray(got.regressors), ref["reg"])
    np.testing.assert_array_equal(got.series_ids, batch.series_ids)
    assert got.regressor_names == batch.regressor_names
    assert plane.import_batch(batch, "m5_csv", root=root,
                              shard_rows=2) == d
    changed = batch._replace(y=batch.y + 1.0)
    assert plane.import_batch(changed, "m5_csv", root=root,
                              shard_rows=2) != d
    _same_batch(jplane.open_batch(d), got)


def test_load_m4_feeds_fit(tmp_path):
    """The loaded layout flows straight into the port's batched fit."""
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        ProphetConfig,
        SeasonalityConfig,
        SolverConfig,
    )

    rng = np.random.default_rng(0)
    n = 72
    rows = {"V1": ["H1", "H2"]}
    for k in range(n):
        y = 10 + 2 * np.sin(2 * np.pi * k / 24)
        rows[f"V{k + 2}"] = [y + rng.normal(0, 0.1),
                             y * 0.5 + rng.normal(0, 0.1)]
    p = tmp_path / "Hourly-train.csv"
    pd.DataFrame(rows).to_csv(p, index=False)
    batch = loaders.load_m4(str(p))
    _same_batch(batch, jloaders.load_m4(str(p)))
    bk = get_backend(
        "cuda",
        ProphetConfig(seasonalities=(SeasonalityConfig("daily", 1.0, 3),),
                      n_changepoints=3),
        SolverConfig(max_iters=80), device="cpu",
    )
    state = bk.fit(batch.ds, np.nan_to_num(batch.y), mask=batch.mask)
    assert bool(np.isfinite(np.asarray(state.loss)).all())
