"""The port's uncertainty tier around the ADVI fit and the plane: the demo
generator, the gold audit and the calibration eval, against the JAX
package's.

* ``demo_weekly_rows`` / ``dataset_ids``: the reference's bytes, in any
  row range (seed blocks of 1,024 rows).
* ``gold.select_rows``, ``gold.quantile_divergence`` and
  ``calibrate.coverage_eval``: the reference's values bitwise (host numpy
  on the same inputs).
* ``gold.audit_version`` on 2 rows with a short ``McmcConfig``: its
  ``gold_audit.json`` reads in the JAX package's ``load_audit``.
* ``run_calibration_smoke`` on the CPU (the reference's default 24
  series): mode ``"advi"``, the reference's report structure, and a
  ``coverage_abs_gap`` within ``GAP_DISTANCE`` of the JAX package's run
  at the same seed.  The two runs share the workload's bytes but not their
  draws (the ADVI fit's and the gold audit's generators differ), so the
  gap can differ by sampling alone: on this workload both read 0.2 (every
  held-out cell inside the 80% band, the reference's own reading), the
  medians' rates 0.41-0.54 of 0.5.  The gap is saturated here: a
  posterior sd cut to 0.61x still reads 0.2.  So the runs' served bands
  are also held to each other: per bucket, the median over cells of
  log(port's q900 - q100 width / the JAX package's) within
  ``WIDTH_LIMIT``.  Readings: -0.006 to 0.029 over the port's generator
  seeds 0-3; an sd scaled by exp(-0.1) or exp(0.1) reads -0.076 or
  0.065, and the planted fault (rho lowered by 0.25, sd 0.78x) -0.17.

No test here binds a run of the JAX package's ``obs`` context.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from tsspark_tpu.data import datasets as jdatasets
from tsspark_tpu.uncertainty import calibrate as jcalibrate
from tsspark_tpu.uncertainty import gold as jgold
from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    McmcConfig,
    ProphetConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data import datasets as tdatasets
from tsspark_tpu_torch.serve import ParamRegistry
from tsspark_tpu_torch.uncertainty import advi, calibrate, gold

torch.set_num_threads(2)

CFG = ProphetConfig(seasonalities=(SeasonalityConfig("weekly", 7.0, 2),),
                    n_changepoints=3)
GAP_DISTANCE = 0.1
WIDTH_LIMIT = 0.05


@pytest.mark.parametrize("lo,hi,steps,seed", [
    (0, 24, 180, 0), (1000, 1100, 60, 3), (3000, 3010, 180, 7)])
def test_demo_weekly_rows_are_the_references_bytes(lo, hi, steps, seed):
    got = tdatasets.demo_weekly_rows(lo, hi, n_steps=steps, seed=seed)
    want = jdatasets.demo_weekly_rows(lo, hi, n_steps=steps, seed=seed)
    for f in ("ds", "y", "mask", "series_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    with pytest.raises(ValueError):
        tdatasets.demo_weekly_rows(5, 5)


@pytest.mark.parametrize("gen", ["demo_weekly", "m5"])
def test_dataset_ids_are_the_references(gen):
    for lo, hi in ((0, 12), (9990, 10010), (99_998, 100_003)):
        np.testing.assert_array_equal(tdatasets.dataset_ids(gen, lo, hi),
                                      jdatasets.dataset_ids(gen, lo, hi))


def test_select_rows_and_quantile_divergence_are_the_references():
    for n, v, m, s in ((5, 1, 8, 0), (30490, 3, 8, 0), (1000, 7, 16, 2)):
        np.testing.assert_array_equal(
            gold.select_rows(n, v, max_series=m, seed=s),
            jgold.select_rows(n, v, max_series=m, seed=s))
    rng = np.random.default_rng(0)
    samples = rng.normal(0, 1, (60, 4, 10)).astype(np.float32)
    mu = rng.normal(0, 0.2, (4, 10)).astype(np.float32)
    rho = rng.normal(-0.5, 0.3, (4, 10)).astype(np.float32)
    want = jgold.quantile_divergence(samples, mu, rho)
    np.testing.assert_array_equal(gold.quantile_divergence(samples, mu, rho),
                                  want)
    np.testing.assert_array_equal(
        gold.quantile_divergence(torch.from_numpy(samples), mu, rho), want)


def test_coverage_eval_is_the_references():
    rng = np.random.default_rng(1)
    y = rng.normal(0, 1, (7, 16))
    cols = {100: np.full((7, 16), -1.28, np.float32),
            500: rng.normal(0, 0.1, (7, 16)).astype(np.float32),
            900: np.full((7, 16), 1.28, np.float32)}
    valid = rng.uniform(size=(7, 16)) < 0.8
    for v in (None, valid):
        assert calibrate.coverage_eval(cols, y, v) \
            == jcalibrate.coverage_eval(cols, y, v)
    with pytest.raises(ValueError):
        calibrate.coverage_eval(cols, y, np.zeros((7, 16), bool))


def _demo_version(tmp_path):
    batch = tdatasets.demo_weekly_rows(0, 6, n_steps=150, seed=0)
    y = np.nan_to_num(batch.y).astype(np.float32)
    backend = get_backend("cuda", CFG, SolverConfig(max_iters=25),
                          device="cpu")
    state = backend.fit(batch.ds, y)
    reg = ParamRegistry(str(tmp_path / "registry"), CFG)
    reg.publish(state, batch.series_ids, step=np.ones(6))
    mu = np.nan_to_num(state.theta.numpy())
    advi.save_posterior(reg.version_dir(1), advi.AdviPosterior(
        mu=mu, rho=np.full_like(mu, -3.0), elbo=np.zeros(6, np.float32)),
        seed=0, num_steps=0)
    return reg, batch, y


def test_audit_version_writes_what_the_jax_package_reads(tmp_path):
    reg, batch, y = _demo_version(tmp_path)
    short = McmcConfig(num_samples=40, num_warmup=40, num_leapfrog=6)
    rep = gold.audit_version(reg, version=1,
                             arrays=(batch.ds, y, batch.mask, None),
                             max_series=2, seed=0, mcmc_config=short,
                             device="cpu")
    assert rep["rows"] == [int(r) for r in jgold.select_rows(6, 1,
                                                             max_series=2)]
    assert len(rep["qdiv"]) == 2 and np.isfinite(rep["qdiv_max"])
    assert np.isfinite(rep["rhat_max"]) and np.isfinite(rep["ess_min"])
    got = jgold.load_audit(reg.version_dir(1))
    assert got == rep == gold.load_audit(reg.version_dir(1))
    # Deterministic under (seed, version).
    again = gold.audit_version(reg, version=1,
                               arrays=(batch.ds, y, batch.mask, None),
                               max_series=2, seed=0, mcmc_config=short,
                               device="cpu")
    assert again["qdiv"] == rep["qdiv"]
    # No posterior, or no arrays: nothing to audit / a refusal.
    os.remove(os.path.join(reg.version_dir(1), advi.POSTERIOR_FILE))
    assert gold.audit_version(reg, version=1, arrays=(batch.ds, y, None,
                                                      None)) is None
    assert gold.load_audit(str(tmp_path / "nowhere")) is None


def test_audit_version_needs_arrays(tmp_path):
    """Without ``arrays`` the audit reads its rows off the data plane:
    a ``data_dir`` that is no complete plane dataset is refused."""
    reg, _, _ = _demo_version(tmp_path)
    with pytest.raises(FileNotFoundError):
        gold.audit_version(reg, str(tmp_path / "data"), version=1,
                           device="cpu")


def _jax_obs_binding():
    from tsspark_tpu.obs import context as jobs

    return jobs.active(), jobs.trace_id()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    root = tmp_path_factory.mktemp("calibration")
    before = _jax_obs_binding()
    port = calibrate.run_calibration_smoke(str(root / "port"), seed=0,
                                           read_probes=50, device="cpu",
                                           data_root=str(root / "pdata"))
    ref = jcalibrate.run_calibration_smoke(
        str(root / "jax"), seed=0, read_probes=50,
        data_root=str(root / "data"))
    return port, ref, (before, _jax_obs_binding()), root


def _band_widths(scratch) -> dict:
    """{bucket: (n, H) float64 q900 - q100} of the smoke's served plane."""
    vdir = sorted(glob.glob(os.path.join(scratch, "registry", "v*")))[-1]
    out = {}
    for hb in (8, 16, 32):
        col = lambda q: np.load(os.path.join(  # noqa: E731
            vdir, f"qcol_h{hb}_q{q:03d}.npy")).astype(np.float64)
        out[hb] = col(900) - col(100)
    return out


def _width_log_ratios(port_dir, ref_dir) -> dict:
    """Per bucket, the median over cells of log(port width / ref width)."""
    got, want = _band_widths(port_dir), _band_widths(ref_dir)
    return {hb: float(np.median(np.log(got[hb] / want[hb]))) for hb in got}


def test_calibration_smoke_on_the_cpu_against_the_jax_package(reports):
    port, ref, _, root = reports
    cal, jcal = port["calibration"], ref["calibration"]
    assert port["kind"] == ref["kind"] == "calibration-eval"
    assert cal["mode"] == jcal["mode"] == "advi"
    assert set(port) == set(ref)
    assert set(cal) == set(jcal)
    assert set(cal["buckets"]) == set(jcal["buckets"]) == {"8", "16", "32"}
    for hb, rep in cal["buckets"].items():
        assert set(rep) == set(jcal["buckets"][hb])
        assert rep["n_cells"] == jcal["buckets"][hb]["n_cells"]
    assert set(cal["gold"]) == set(jcal["gold"])
    assert cal["gold"]["rows"] == jcal["gold"]["rows"]
    assert port["device"] == "cpu"
    assert port["config_fingerprint"] == ref["config_fingerprint"]
    assert port["numerics_rev"] == ref["numerics_rev"]
    assert 0.0 <= cal["coverage_abs_gap"] <= 0.5
    assert abs(cal["coverage_abs_gap"] - jcal["coverage_abs_gap"]) \
        <= GAP_DISTANCE
    ratios = _width_log_ratios(str(root / "port"), str(root / "jax"))
    assert max(abs(r) for r in ratios.values()) <= WIDTH_LIMIT, ratios


def test_calibration_band_widths_fail_a_narrowed_posterior(reports,
                                                           monkeypatch):
    """The planted fault: every posterior sd cut to exp(-0.25) = 0.78x.
    The saturated gap does not see it; the band widths must."""
    _, ref, _, root = reports
    fit = advi.fit_advi

    def narrowed(*args, **kw):
        post = fit(*args, **kw)
        return post._replace(rho=post.rho - 0.25)

    monkeypatch.setattr(advi, "fit_advi", narrowed)
    bad = calibrate.run_calibration_smoke(str(root / "narrowed"), seed=0,
                                          read_probes=50, device="cpu")
    assert bad["calibration"]["coverage_abs_gap"] \
        == ref["calibration"]["coverage_abs_gap"]
    ratios = _width_log_ratios(str(root / "narrowed"), str(root / "jax"))
    assert max(abs(r) for r in ratios.values()) > WIDTH_LIMIT, ratios


def test_calibration_smokes_leave_the_jax_obs_binding_as_it_was(reports):
    """Neither smoke binds (or unbinds) a run of the JAX package's obs
    context: a file run before this one on the same worker may have left
    one bound, and the next file must find it as it was."""
    before, after = reports[2]
    assert after == before
    assert jax.config.jax_platforms == "cpu"


#: The ADVI tier's coverage against the JAX package's at a width where
#: sampling noise can decide (ROADMAP Queue 3 item 2).
COVERAGE_SERIES = 2048
#: Per bucket, |port - JAX| coverage within this many standard errors of
#: the difference (each package's across-series variance of a series'
#: coverage over the square root of the series).
COVERAGE_Z = 3.0


def _series_coverage(scratch, n_series, data_root,
                     holdout=calibrate.DEFAULT_HOLDOUT):
    """{bucket: per-series share of held-out cells inside the served
    q100-q900 band} of a calibration smoke's version, as
    ``evaluate_version`` aligns the plane's grid to the held-out days
    (the port reads either package's registry and quantile plane)."""
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.uncertainty import qplane

    reg = ParamRegistry.open(os.path.join(scratch, "registry"))
    v = reg.active_version()
    snap = reg.load(v)
    view = qplane.attach(reg.version_dir(v), expected_n=n_series)
    spec = plane.DatasetSpec("demo_weekly", n_series, 180, seed=0)
    batch = plane.open_batch(plane.dataset_dir(spec, data_root))
    ds = np.asarray(batch.ds, np.float64)
    y = np.asarray(batch.y, np.float64)
    cut = len(ds) - holdout
    ds_f, y_f = ds[cut:], y[:, cut:]
    idx = np.arange(n_series, dtype=np.int64)
    out = {}
    for hb in view.buckets:
        grid, cols = qplane.quantile_batch(view, snap, idx, int(hb))
        pos = np.clip(np.searchsorted(ds_f, grid), 0, len(ds_f) - 1)
        valid = np.isclose(ds_f[pos], grid)
        y_t = y_f[idx[:, None], pos]
        lo, hi = min(cols), max(cols)
        inside = (y_t >= cols[lo]) & (y_t <= cols[hi])
        out[str(int(hb))] = (inside & valid).sum(1) / np.maximum(
            valid.sum(1), 1)
    return out


@pytest.mark.slow
def test_advi_coverage_against_the_jax_package_at_2048_series(tmp_path):
    """``run_calibration_smoke`` in both packages on the same 2,048
    ``demo_weekly`` series: each bucket's 80%-band coverage, and so the
    worst bucket's ``coverage_abs_gap``, within COVERAGE_Z standard
    errors of sampling noise of the JAX package's (the two runs share the
    workload's bytes, not their draws).  Prints the readings."""
    before = _jax_obs_binding()
    port = calibrate.run_calibration_smoke(
        str(tmp_path / "port"), n_series=COVERAGE_SERIES, seed=0,
        read_probes=20, gold_audit=False, device="cpu",
        data_root=str(tmp_path / "pdata"))
    ref = jcalibrate.run_calibration_smoke(
        str(tmp_path / "jax"), n_series=COVERAGE_SERIES, seed=0,
        read_probes=20, gold_audit=False, data_root=str(tmp_path / "data"))
    assert _jax_obs_binding() == before
    # Both read the workload off the port's plane (the same bytes).
    got = _series_coverage(str(tmp_path / "port"), COVERAGE_SERIES,
                           str(tmp_path / "pdata"))
    want = _series_coverage(str(tmp_path / "jax"), COVERAGE_SERIES,
                            str(tmp_path / "pdata"))
    readings = {}
    for hb, rep in port["calibration"]["buckets"].items():
        jrep = ref["calibration"]["buckets"][hb]
        a, b = got[hb], want[hb]
        # The per-series shares average back to the report's coverage.
        assert abs(a.mean() - rep["interval_empirical"]) < 0.02
        assert abs(b.mean() - jrep["interval_empirical"]) < 0.02
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        d = rep["interval_empirical"] - jrep["interval_empirical"]
        readings[hb] = {"port": rep["interval_empirical"],
                        "jax": jrep["interval_empirical"],
                        "diff": round(d, 6), "se": round(float(se), 6),
                        "z": round(float(d / se), 3)}
    # Both bands over-cover (the gap is saturated near 0.2), so their
    # widths are held too, as at the smoke's 24 series.
    ratios = _width_log_ratios(str(tmp_path / "port"), str(tmp_path / "jax"))
    print("coverage at 2,048 series:", readings,
          "gap port / jax:", port["calibration"]["coverage_abs_gap"],
          ref["calibration"]["coverage_abs_gap"],
          "median log width ratio:", ratios)
    assert max(abs(r) for r in ratios.values()) <= WIDTH_LIMIT, ratios
    for hb, r in readings.items():
        assert abs(r["z"]) <= COVERAGE_Z, (hb, readings)
    worst = max(r["se"] for r in readings.values())
    assert abs(port["calibration"]["coverage_abs_gap"]
               - ref["calibration"]["coverage_abs_gap"]) \
        <= COVERAGE_Z * worst
