"""The front end on the card (skipped without one): ``chip_smoke.py``'s
phase ``frontend`` at a small size — (a) the long-frame ``Forecaster``
fit, its state, forecast and components bitwise a direct ``CudaBackend``
fit of the same arrays, the plain CPU leg within the fit budget; (b) the
cross-validation frame bitwise the array CV; (c) the ``mcmc_samples``
route; (d) ``python -m tsspark_tpu_torch`` in child processes on the
card, each output bitwise the same command in this process, the kernel
library loaded and not rebuilt.  The phase's own ``require`` checks are
the assertions.  No JAX here: the comparisons are within the port."""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


class _Now:
    """The CPU leg run in this process (``ParityFits.submit``'s
    ``.get()``)."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def get(self):
        return self.fn(*self.args)


def test_frontend_legs_at_a_small_size_on_the_card(card, monkeypatch):
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.eval import configs

    for name, value in (("FE_SERIES", 64), ("FE_CPU_SUBSET", 8),
                        ("FE_CV_SERIES", 32), ("FE_MCMC_SERIES", 16),
                        ("FE_CLI_SERIES", 16),
                        ("FE_CV", {"horizon": "28D", "period": "60D",
                                   "initial": "100D"})):
        monkeypatch.setattr(chip_smoke, name, value)
    batch = m5_like(64, 400, seed=2)
    split = configs.split_point(400)
    leg = _Now(chip_smoke.frontend_cpu_job,
               chip_smoke.fe_long_frame(batch, 8, 0, split),
               chip_smoke.fe_holiday(batch))
    out = chip_smoke.phase_frontend(card, batch, leg)
    assert out["a"]["state_fields_not_bitwise_direct"] == []
    assert out["b"]["columns_not_bitwise_backtest"] == []
    assert out["d"]["outputs_not_bitwise_in_process"] == []
    assert all(r["builds"] == 0 for r in out["d"]["children"].values())
    assert np.isfinite(out["a"]["smape_holdout"])
