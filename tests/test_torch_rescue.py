"""The rescue pass's two starts (warm from the stuck point, fresh from the
ridge init) share one prep and pack of the stuck rows
(``CudaBackend._fit_main(starts=)`` / ``ProphetModel.fit(starts=)``):
each start's state is the bits of a fit of its own, on one chunk and
across chunks, packed and segmented."""

import numpy as np
import pytest
import torch

from tsspark_tpu_torch.backends.registry import get_backend
from tsspark_tpu_torch.config import (
    ProphetConfig,
    RegressorConfig,
    SeasonalityConfig,
    SolverConfig,
)
from tsspark_tpu_torch.data import datasets

torch.set_num_threads(2)

CFG = ProphetConfig(
    seasonalities=(SeasonalityConfig("weekly", 7.0, 3),),
    regressors=(RegressorConfig("holiday", standardize=False),
                RegressorConfig("price")),
    n_changepoints=6,
)
FIELDS = ("loss", "grad_norm", "converged", "n_iters", "status")


def _same(a, b):
    assert torch.equal(torch.as_tensor(a.theta), torch.as_tensor(b.theta))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for x, y in zip(a.meta, b.meta):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk,segment", [(32, None), (16, None),
                                           (32, 8)])
def test_starts_share_one_prep_bitwise(chunk, segment):
    b = datasets.m5_like(n_series=24, n_days=160, seed=4)
    ds, y, m = np.asarray(b.ds), b.y, b.mask
    reg = np.asarray(b.regressors)[..., :2]
    solver = SolverConfig(max_iters=30, precond="gn_diag")
    bk = get_backend("cuda", CFG, solver, device="cpu", chunk_size=chunk,
                     iter_segment=segment, length_buckets=1, rescue=False)
    init = np.random.default_rng(0).normal(
        0, 0.05, (24, CFG.num_params)).astype(np.float32)
    kw = dict(mask=m, regressors=reg)
    warm_alone = bk.fit(ds, y, init=init, **kw)
    fresh_alone = bk.fit(ds, y, **kw)
    warm, fresh = bk._fit_main(ds, y, init=init, starts=(None,), **kw)
    _same(warm, warm_alone)
    _same(fresh, fresh_alone)
    assert bk._fit_main(ds, y, init=init, **kw).loss.shape == (24,)


def test_rescue_pass_result_unchanged_by_the_shared_prep(monkeypatch):
    """The whole fit, rescue pass included: with the shared prep it is the
    fit the two separate rescue fits gave."""
    from tsspark_tpu_torch.backends import cuda
    from tsspark_tpu_torch.ops import lbfgs

    b = datasets.m5_like(n_series=24, n_days=160, seed=5)
    ds, y, m = np.asarray(b.ds), b.y, b.mask
    reg = np.asarray(b.regressors)[..., :2]
    solver = SolverConfig(max_iters=25)
    fit = lambda: get_backend("cuda", CFG, solver, device="cpu").fit(  # noqa: E731
        ds, y, mask=m, regressors=reg)
    got = fit()
    orig = cuda.CudaBackend._fit_main

    def separate(self, ds, y, init=None, starts=(), **kw):
        if not starts:
            return orig(self, ds, y, init=init, **kw)
        return [orig(self, ds, y, init=i, **kw) for i in (init, *starts)]

    monkeypatch.setattr(cuda.CudaBackend, "_fit_main", separate)
    plain = get_backend("cuda", CFG, solver, device="cpu", rescue=False).fit(
        ds, y, mask=m, regressors=reg)
    stuck = np.isin(plain.status, (lbfgs.STATUS_FLOOR, lbfgs.STATUS_STALLED))
    assert stuck.sum() > 0  # the pass has rows to refit
    _same(got, fit())
