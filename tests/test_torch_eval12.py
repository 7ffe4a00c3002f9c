"""Eval configs 1 and 2 and the parity audit (``eval/parity.py``) in the
port, against the JAX package on the CPU.

* The generators (``peyton_manning_like``, ``m4_hourly_like``) give the
  JAX package's bytes at the published sizes.
* Configs 1 (400 days) and 2 (8 series at the full 960 hours: ragged
  lengths, the hourly grid, length buckets considered) fitted on the
  port's plain path against the JAX package's ``TpuBackend`` on the CPU,
  both through the audit's ``_smape_per_series``: per-series train sMAPE
  within ``TRAIN_TOL`` and holdout within ``HOLDOUT_TOL`` (readings: train
  0.0003 and 0.0026, holdout 0.080 and 0.009; the two solvers stop at
  different float32 points, and a 290-day holdout extrapolates the
  difference).
* ``run_parity`` at scale 0.01 on configs 1 and 2 has the JAX record's
  keys and meets the parity budget of ``tests/test_backends.py:77-78``
  against the scipy oracle (per series <= 0.1, |mean| <= 0.05); the full
  four-config audit is ``-m slow``.
"""

import json
import sys

import numpy as np
import pytest
import torch

from tsspark_tpu.data import datasets as jdata
from tsspark_tpu.eval import parity as jparity
from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.eval import configs, parity

torch.set_num_threads(2)

TRAIN_TOL = 0.02
HOLDOUT_TOL = 0.25
SERIES_BUDGET = 0.1
MEAN_BUDGET = 0.05
SMALL = ("config1_peyton", "config2_m4_hourly")


@pytest.mark.parametrize("name,kw", [
    ("peyton_manning_like", {}),
    ("m4_hourly_like", {}),
    ("peyton_manning_like", {"n_days": 400}),
    ("m4_hourly_like", {"n_series": 8}),
])
def test_generators_give_the_jax_packages_bytes(name, kw):
    want = getattr(jdata, name)(**kw)
    got = getattr(datasets, name)(**kw)
    assert got._fields == want._fields
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None or isinstance(w, tuple):
            assert g == w, f
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def test_trend_with_changepoints_bytes():
    t = np.linspace(0, 1, 97)
    a = jdata._trend_with_changepoints(np.random.default_rng(4), t, 3,
                                       0.5, 0.8)
    b = datasets._trend_with_changepoints(np.random.default_rng(4), t, 3,
                                          0.5, 0.8)
    assert a.tobytes() == b.tobytes()


def test_configs_are_the_jax_packages():
    from tsspark_tpu.eval import parity as jp

    cases = jp._case_configs(0.01)
    for name, (cfg, solver) in {
            "config1_peyton": (configs.CONFIG1, configs.SOLVER1),
            "config2_m4_hourly": (configs.CONFIG2, configs.SOLVER2)}.items():
        _, jcfg, jsolver = cases[name]
        assert [(s.name, s.period, s.fourier_order, s.mode)
                for s in cfg.seasonalities] == \
            [(s.name, s.period, s.fourier_order, s.mode)
             for s in jcfg.seasonalities]
        assert cfg.n_changepoints == jcfg.n_changepoints
        assert cfg.growth == jcfg.growth
        assert solver.max_iters == jsolver.max_iters


@pytest.fixture(scope="module")
def legs():
    """Each small config through both packages' batched legs."""
    jcases, pcases = jparity._case_configs(0.01), parity._case_configs(0.01)
    out = {}
    for name in SMALL:
        jb, jc, js = jcases[name]
        pb, pc, ps = pcases[name]
        out[name] = (jparity._smape_per_series(jc, js, jb, "tpu"),
                     parity._smape_per_series(pc, ps, pb, "cuda",
                                              device="cpu"))
    return out


@pytest.mark.parametrize("name", SMALL)
def test_configs_against_the_jax_package(legs, name):
    (jtr, jho, _), (ptr, pho, _) = legs[name]
    assert ptr.shape == jtr.shape and np.isfinite(ptr).all()
    assert np.abs(ptr - jtr).max() <= TRAIN_TOL, np.abs(ptr - jtr).max()
    assert np.abs(pho - jho).max() <= HOLDOUT_TOL, np.abs(pho - jho).max()


def test_config2_shape_and_length_plan():
    """Config 2 at 8 series keeps the JAX package's ragged right-aligned
    layout; the backend's length-bucket plan is the same function of the
    mask as the JAX package's."""
    from tsspark_tpu.backends.registry import get_backend as jget
    from tsspark_tpu_torch.backends.registry import get_backend

    b = datasets.m4_hourly_like(n_series=64)
    split = configs.split_point(b.y.shape[1])
    lengths = b.mask.sum(axis=1)
    assert lengths.min() >= 700 and lengths.max() <= 960
    assert (b.mask[:, -1] == 1).all()
    pb = get_backend("cuda", configs.CONFIG2, configs.SOLVER2, device="cpu")
    jcase = jparity._case_configs(0.01)["config2_m4_hourly"]
    jb = jget("tpu", jcase[1], jcase[2])
    want = jb._plan_length_buckets(b.y[:, :split], b.mask[:, :split])
    got = pb._plan_length_buckets(b.y[:, :split], b.mask[:, :split])
    if want is None:
        assert got is None
    else:
        assert len(got) == len(want)
        for (gi, glo, ghi), (wi, wlo, whi) in zip(got, want):
            assert np.array_equal(np.asarray(gi), np.asarray(wi))
            assert (glo, ghi) == (wlo, whi)


def test_run_parity_record_and_budget():
    got = parity.run_parity(0.01, configs=list(SMALL), device="cpu")
    assert set(got) == set(SMALL)
    want_keys = {
        "n_series", "smape_train_cpu", "smape_train_tpu",
        "delta_train_mean", "delta_train_max_abs", "smape_holdout_cpu",
        "smape_holdout_tpu", "delta_holdout_mean",
        "delta_holdout_max_abs", "delta_holdout_dist",
        "delta_train_dist", "fit_seconds_cpu", "fit_seconds_tpu",
    }
    for name, rec in got.items():
        assert set(rec) == want_keys
        assert set(rec["delta_holdout_dist"]) == {"p50", "p95", "max"}
        assert rec["delta_train_max_abs"] <= SERIES_BUDGET, (name, rec)
        assert abs(rec["delta_train_mean"]) <= MEAN_BUDGET, (name, rec)
    assert got["config1_peyton"]["n_series"] == 1
    assert got["config2_m4_hourly"]["n_series"] == 8


def test_parity_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "parity.json"
    monkeypatch.setattr(sys, "argv", ["parity"])
    parity.main(["--scale", "0.01", "--configs", "config2_m4_hourly",
                 "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["kind"] == "eval-parity" and rec["platform"] == "cpu"
    assert list(rec["configs"]) == ["config2_m4_hourly"]
    assert set(rec) == {"kind", "unix", "trace_id", "git_rev",
                        "numerics_rev", "platform", "scale", "configs"}
    assert json.loads(capsys.readouterr().out) == rec


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        configs.config2_m4_hourly(scale=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run_parity(0.01, configs=["config1_peyton"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main(["--configs", "config1_peyton"])


@pytest.mark.parametrize("which", ["1", "2"])
def test_cli_runs_configs_1_and_2(monkeypatch, capsys, which):
    monkeypatch.setattr(sys, "argv", ["configs", which, "--device", "cpu",
                                      "--scale", "0.01"])
    configs.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = out[f"config{which}"]
    assert rec["n_series"] == {"1": 1, "2": 4}[which]
    assert rec["n_timesteps"] == {"1": 180, "2": 864}[which]
    assert np.isfinite(rec["smape_train"]) and rec["smape_train"] < 10


def test_ridge_init_where_float32_cholesky_fails():
    """Config 1 at 180 days (yearly order 10 on half a year): the Gram
    is too near singular for LAPACK's float32 Cholesky, which the JAX
    package's XLA factorization passes.  That row is solved in float64
    (finite, as the JAX package's init is), and a row that factors in
    float32 (the same feature columns under a 1e4x stronger ridge) keeps
    its bits beside a row that fails."""
    from tsspark_tpu_torch.models.prophet import design, init

    b = datasets.peyton_manning_like(n_days=200)
    data = design.fitdata_to_device(design.prepare_fit_data(
        b.ds[:180], np.nan_to_num(b.y[:, :180]), configs.CONFIG1,
        mask=b.mask[:, :180])[0], "cpu")
    assert torch.isfinite(init.ridge_init(data, configs.CONFIG1)).all()
    phi = init._feature_matrix(data, 1).expand(2, -1, -1)
    y = data.y.expand(2, -1)
    mask = data.mask.expand(2, -1)
    prec = torch.full((phi.shape[-1],), 0.01)
    sigma2 = torch.tensor([1e-4, 1.0])
    gram = torch.matmul((phi * mask[..., None]).transpose(1, 2), phi)
    a = gram[0] + torch.eye(phi.shape[-1]) * (prec * sigma2[0] + 1e-6)
    assert torch.linalg.cholesky_ex(a)[1] != 0   # float32 refuses row 0
    both = init._ridge_solve(phi, y, mask, prec, sigma2)
    # The same batch width with no failing row (the batched products'
    # rounding depends on the width).
    good = init._ridge_solve(phi, y, mask, prec, torch.tensor([1.0, 1.0]))
    assert torch.isfinite(both[1]).all()
    assert torch.equal(both[1], good[1])


@pytest.mark.slow
def test_full_four_config_audit():
    """The four-config audit at scale 0.01 on the CPU (the scipy oracle
    on 1, 8, 304 and 4 series; minutes): every config within the parity
    budget on the training span, as the JAX package's record is."""
    got = parity.run_parity(0.01, device="cpu")
    print(json.dumps(got, indent=1))
    assert set(got) == {"config1_peyton", "config2_m4_hourly",
                        "config3_m5", "config4_wiki_logistic"}
    for name, rec in got.items():
        assert abs(rec["delta_train_mean"]) <= MEAN_BUDGET, (name, rec)
