"""Host changes that make room in ``chip_smoke.py``'s time, each held to
the bits of the code it replaced, on the CPU at a small size:

* the chunked fit's threaded prep (``CudaBackend.PREP_WORKERS``): each
  chunk prepared on a worker thread is the bytes of ``prepare_fit_data``
  + ``pack_fit_data`` on that chunk (the functions
  ``tests/test_torch_fit_prep.py`` holds against the JAX package), and
  the fit (rescue pass, two-phase fit) the bits of the sequential one;
* ``design.prepare_fit_data_blocks`` (a large batch's prep as row blocks
  on threads): the bytes of one ``prepare_fit_data`` call;
* the run's set-up (``chip_smoke.setup_data``): its generators on
  threads give the bits of one after another, and phase serve's registry
  built from ``batch3`` is the bits of the one built from its own
  ``m5_like(..., with_regressors=False)``.
"""

import os

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import chip_smoke
from tsspark_tpu_torch.backends import cuda as cuda_mod
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import SolverConfig
from tsspark_tpu_torch.data.datasets import m5_like
from tsspark_tpu_torch.eval import configs
from tsspark_tpu_torch.models.prophet import design

torch.set_num_threads(2)

N, DAYS, CHUNK = 80, 240, 32  # three chunks, the last one padded


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    npt.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


def _same_state(a, b):
    for f in ("theta", "loss", "grad_norm", "converged", "n_iters",
              "status"):
        _bitwise(getattr(a, f), getattr(b, f), f)
    for f in a.meta._fields:
        _bitwise(getattr(a.meta, f), getattr(b.meta, f), f)


@pytest.fixture(scope="module")
def batch():
    b = m5_like(N, DAYS, seed=4)
    return (b.ds, np.nan_to_num(b.y), b.mask, b.regressors)


def _backend(**kw):
    return get_backend("cuda", configs.CONFIG3, SolverConfig(max_iters=30),
                       device="cpu", chunk_size=CHUNK, **kw)


def test_threaded_chunk_prep_is_the_bytes_of_the_direct_prep(batch,
                                                             monkeypatch):
    """Every chunk's prepared batch, made on a worker thread, is the
    bytes ``prepare_fit_data`` and ``pack_fit_data`` give that chunk
    directly (padding included)."""
    ds, y, mask, reg = batch
    bk = _backend()
    u8 = cuda_mod._indicator_reg_cols(reg)
    seen = []
    real = bk._fit_padded

    def spy(*args, **kw):
        seen.append((args, kw["host"]))
        return real(*args, **kw)

    monkeypatch.setattr(bk, "_fit_padded", spy)
    bk._fit_main(ds, y, mask=mask, regressors=reg, reg_u8_cols=u8)
    assert len(seen) == 3
    for i, (args, host) in enumerate(seen):
        b = args[1].shape[0]
        lo = i * CHUNK
        assert b == min(CHUNK, N - lo)
        pad = lambda a: cuda_mod._pad_batch(a[lo:lo + b], CHUNK)  # noqa
        m = pad(mask).astype(np.float64).copy()
        m[b:] = 0.0
        data, meta = design.prepare_fit_data(
            ds, pad(y), configs.CONFIG3, mask=m, regressors=pad(reg))
        packed, u8_direct = design.pack_fit_data(
            data, meta, ds, reg_u8_cols=u8, collapse_cap=True)
        assert host.reg_u8_cols == u8_direct
        for f in packed._fields:
            _bitwise(getattr(host.packed, f), getattr(packed, f), f)
        for f in meta._fields:
            _bitwise(getattr(host.meta, f), getattr(meta, f), f)


@pytest.mark.parametrize("twophase", [False, True])
def test_threaded_chunk_prep_fits_the_same_bits(batch, monkeypatch,
                                                twophase):
    """The fit with the rescue pass (and the two-phase fit) on threaded
    prep is the bits of the same fit with each chunk prepared just before
    its solve; the stage clock still counts every chunk's prep and pack."""
    ds, y, mask, reg = batch
    out = {}
    for workers in (0, 4):
        monkeypatch.setattr(cuda_mod, "PREP_WORKERS", workers)
        bk = _backend()
        fit = bk.fit_twophase if twophase else bk.fit
        out[workers] = (fit(ds, y, mask=mask, regressors=reg),
                        dict(bk.stages.calls))
    _same_state(out[0][0], out[4][0])
    calls0, calls4 = out[0][1], out[4][1]
    for stage in ("prep", "pack", "solve"):
        assert calls0[stage] == calls4[stage], stage
    assert "prep_wait" in calls4 and "prep_wait" not in calls0


def test_serve_batch_is_batch3_without_its_regressors():
    """``m5_like`` draws the regressors' values either way: its series
    without them are the bits of its series with them."""
    a = m5_like(50, 130, seed=2, with_regressors=False)
    b = m5_like(50, 130, seed=2)
    for f in ("ds", "y", "mask", "series_ids"):
        npt.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    _bitwise(a.y, b.y)
    assert a.regressors is None and b.regressors is not None


class _Args:
    seed = 0


@pytest.fixture()
def small_run(monkeypatch):
    """``chip_smoke``'s sizes cut down (the fleet's rows, days and cuts)."""
    for name, v in (("FULL_SERIES", 60), ("FULL_DAYS", 150),
                    ("C4_SERIES", 8), ("FLEET_SERIES", 90),
                    ("FLEET_CUT", 16), ("M5_FLEET_DAYS", 40)):
        monkeypatch.setattr(chip_smoke, name, v)
    monkeypatch.setattr(chip_smoke, "eval12_batches",
                        lambda: {1: m5_like(3, 50, seed=5)})


def _npy(root):
    out = {}
    for d, _sub, files in os.walk(root):
        for f in files:
            if f.endswith(".npy"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _same(a, b, what):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):  # a SeriesBatch
        assert type(a) is type(b), what
        for f, x, y in zip(a._fields, a, b):
            if x is None or isinstance(x, tuple):
                assert x == y, f"{what}.{f}"
            else:
                npt.assert_array_equal(x, y, err_msg=f"{what}.{f}")
    else:
        npt.assert_array_equal(a, b, err_msg=what)


def test_setup_on_threads_is_the_bits_of_one_after_another(
        small_run, tmp_path):
    runs = {}
    for workers in (0, 4):
        root = str(tmp_path / f"serve{workers}")
        os.makedirs(root)
        runs[workers] = chip_smoke.setup_data(_Args(), root, workers=workers)
    seq, par = runs[0], runs[4]
    for key in ("batch3", "batch4", "stream5_df", "fleet_df", "fleet_sub",
                "m5_df", "m5_ids", "m5_sub", "batches12"):
        _same(seq[key], par[key], key)
    _same(seq["serve"]["batch"], par["serve"]["batch"], "serve batch")
    assert _npy(seq["serve"]["root"]) == _npy(par["serve"]["root"])
    assert len(seq["fleet_df"].series_id.unique()) == len(
        chip_smoke.fleet_rows())


def test_serve_registry_from_batch3_is_the_bits_of_its_own_batch(
        small_run, tmp_path, monkeypatch):
    """The registry built from ``batch3``'s copy is the bits of the one
    built, as before, from ``m5_like(..., with_regressors=False)``."""
    batch3 = m5_like(chip_smoke.FULL_SERIES, chip_smoke.FULL_DAYS, seed=2)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = chip_smoke.serve_registry(_Args(), str(tmp_path / "a"), batch3)
    own = m5_like(chip_smoke.FULL_SERIES, chip_smoke.FULL_DAYS, seed=2,
                  with_regressors=False)
    want = chip_smoke.serve_registry(_Args(), str(tmp_path / "b"), own)
    _same(got["batch"], own, "batch")
    files = _npy(got["root"])
    assert files and files == _npy(want["root"])
    assert got["batch"].y is not batch3.y  # a copy, not batch3's arrays


def _case(name):
    import dataclasses

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.data.datasets import wiki_logistic_like

    if name == "config3":
        b = m5_like(300, 200, seed=6)
        return (configs.CONFIG3, b.ds, b.y,
                dict(mask=b.mask, regressors=b.regressors))
    if name == "quantile_changepoints":
        b = m5_like(300, 200, seed=7, with_regressors=False)
        return (ProphetConfig(changepoint_placement="quantile"), b.ds, b.y,
                dict(mask=b.mask))
    b = wiki_logistic_like(300, 150, seed=3)
    cfg = dataclasses.replace(configs.CONFIG4)
    return (cfg, b.ds, b.y,
            dict(mask=b.mask, cap=b.cap, floor=np.full(300, 0.5)))


@pytest.mark.parametrize("case", ["config3", "quantile_changepoints",
                                  "logistic"])
def test_blocked_prep_is_the_bits_of_one_call(case):
    """``prepare_fit_data_blocks`` (row blocks on threads, the prep of
    ``fit_mcmc``, the calibration's ADVI and ``chip_smoke.py``'s
    full-fleet preps) is the bytes of one ``prepare_fit_data`` call."""
    cfg, ds, y, kw = _case(case)
    want_d, want_m = design.prepare_fit_data(ds, y, cfg, **kw)
    got_d, got_m = design.prepare_fit_data_blocks(ds, y, cfg, block=64,
                                                  **kw)
    for f in want_d._fields:
        _bitwise(getattr(got_d, f), getattr(want_d, f), f)
    for f in want_m._fields:
        _bitwise(getattr(got_m, f), getattr(want_m, f), f)
