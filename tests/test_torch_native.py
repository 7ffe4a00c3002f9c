"""The port's native ingest engine (``tsspark_tpu_torch.native``) against
the JAX package's (``tsspark_tpu.native``): ``bulk_pivot``,
``HistoryStore`` (append, union_grid, materialize) and ``ParamTable``
give the same bits on the same inputs, through the compiled library and
through the numpy fallback alike.  Host ingest, no device kernel."""

import os

import numpy as np
import pytest

from tsspark_tpu import native as jnative
from tsspark_tpu_torch import native as tnative


@pytest.fixture(params=["compiled", "fallback"])
def path(request, monkeypatch):
    """Both packages through their compiled library, or both through the
    numpy fallback (``_load`` returning no library)."""
    if request.param == "fallback":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return request.param


def test_port_library_builds_into_its_build_dir():
    assert tnative.available()
    so = tnative._build()
    assert os.path.dirname(so) == tnative.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    # Nothing is written next to the port's source.
    assert not [f for f in os.listdir(os.path.dirname(tnative._SRC))
                if f.endswith(".so")]
    assert not [f for f in os.listdir(os.path.dirname(tnative.__file__))
                if f.endswith(".so")]


def _stream(rng, n_series=40, n_rows=6000, days=300):
    """Unsorted rows with duplicate (series, day) pairs."""
    sids = rng.integers(0, n_series, n_rows).astype(np.int64)
    days_ = rng.integers(0, days, n_rows).astype(np.float64)
    vals = rng.normal(10, 3, n_rows)
    return sids, days_, vals


@pytest.mark.parametrize("n", [500, 200_000])  # below and past the threads
def test_bulk_pivot_bitwise(path, n):
    rng = np.random.default_rng(n)
    b, t = 300, 400
    rows = rng.integers(0, b, n)
    cols = rng.integers(0, t, n)
    vals = rng.normal(size=n)
    got = tnative.bulk_pivot(rows, cols, vals, b, t)
    want = jnative.bulk_pivot(rows, cols, vals, b, t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("max_history", [64, 4096])
def test_history_store_bitwise(path, max_history):
    """Three appends (out of order, duplicates, past the bound), then the
    union grid and the materialized batch of a subset with an unknown
    code, in both packages."""
    rng = np.random.default_rng(max_history)
    hj = jnative.HistoryStore(max_history)
    ht = tnative.HistoryStore(max_history)
    for _ in range(3):
        sids, days, vals = _stream(rng)
        hj.append(sids, days, vals)
        ht.append(sids, days, vals)
    assert len(ht) == len(hj)
    for s in range(40):
        assert ht.series_length(s) == hj.series_length(s)
    codes = np.asarray([3, 0, 17, 99, 25, 3], np.int64)
    grid_t, grid_j = ht.union_grid(codes), hj.union_grid(codes)
    assert np.array_equal(grid_t, grid_j)
    y_t, y_j = ht.materialize(codes, grid_t), hj.materialize(codes, grid_j)
    assert np.array_equal(y_t, y_j, equal_nan=True)
    assert np.isnan(y_t[3]).all()  # the unknown code


def test_history_store_threaded_materialize_bitwise():
    """Past 64 series the compiled materialize runs threaded."""
    rng = np.random.default_rng(5)
    hj, ht = jnative.HistoryStore(4096), tnative.HistoryStore(4096)
    sids, days, vals = _stream(rng, n_series=500, n_rows=60_000, days=200)
    hj.append(sids, days, vals)
    ht.append(sids, days, vals)
    codes = np.arange(500, dtype=np.int64)
    grid = ht.union_grid(codes)
    assert np.array_equal(ht.materialize(codes, grid),
                          hj.materialize(codes, grid), equal_nan=True)


def test_param_table_bitwise(path):
    rng = np.random.default_rng(2)
    tj, tt = jnative.ParamTable(7), tnative.ParamTable(7)
    for _ in range(3):
        ids = rng.integers(0, 50, 30).astype(np.int64)
        rows = rng.normal(size=(30, 7))
        tj.update(ids, rows)
        tt.update(ids, rows)
    assert len(tt) == len(tj)
    q = np.asarray([1, 49, 1000, 7, 7], np.int64)
    rt, ft = tt.lookup(q)
    rj, fj = tj.lookup(q)
    assert np.array_equal(rt, rj) and np.array_equal(ft, fj)
    it, et = tt.export()
    ij, ej = tj.export()
    assert np.array_equal(it, ij) and np.array_equal(et, ej)
    with pytest.raises(ValueError):
        tt.update(np.zeros(2, np.int64), np.zeros((2, 6)))
