"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card or raise — never a silent
move to the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import tsspark_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    tsspark_tpu_torch.__path__, "tsspark_tpu_torch."))
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
loaded = [m for m, mod in sys.modules.items() if mod is not None]
bad = [m for m in loaded
       if m == "tsspark_tpu" or m.startswith("tsspark_tpu.")
       or m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")]
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # Every module of the slice was imported (the walk saw the package).
    for mod in ("tsspark_tpu_torch.kernels.forward",
                "tsspark_tpu_torch.kernels.bands",
                "tsspark_tpu_torch.kernels.loss",
                "tsspark_tpu_torch.kernels.fan",
                "tsspark_tpu_torch.kernels.draws",
                "tsspark_tpu_torch.ops.hmc",
                "tsspark_tpu_torch.models.prophet.loss",
                "tsspark_tpu_torch.models.prophet.init",
                "tsspark_tpu_torch.ops.lbfgs",
                "tsspark_tpu_torch.serve.engine",
                "tsspark_tpu_torch.backends.cuda",
                "tsspark_tpu_torch.backends.cpu",
                "tsspark_tpu_torch.eval.metrics",
                "tsspark_tpu_torch.eval.configs",
                "tsspark_tpu_torch.carry",
                "tsspark_tpu_torch.native",
                "tsspark_tpu_torch.frame",
                "tsspark_tpu_torch.resilience.policy",
                "tsspark_tpu_torch.resilience.faults",
                "tsspark_tpu_torch.obs.context",
                "tsspark_tpu_torch.obs.metrics",
                "tsspark_tpu_torch.perf.autotune",
                "tsspark_tpu_torch.streaming.warmstart",
                "tsspark_tpu_torch.streaming.state",
                "tsspark_tpu_torch.streaming.source",
                "tsspark_tpu_torch.streaming.driver",
                "tsspark_tpu_torch.kernels.advi",
                "tsspark_tpu_torch.io.errors",
                "tsspark_tpu_torch.io.durable",
                "tsspark_tpu_torch.io.budget",
                "tsspark_tpu_torch.io.ladder",
                "tsspark_tpu_torch.plane.protocol",
                "tsspark_tpu_torch.serve.fplane",
                "tsspark_tpu_torch.serve.snapplane",
                "tsspark_tpu_torch.eval.parity",
                "tsspark_tpu_torch.obs.history",
                "tsspark_tpu_torch.data",
                "tsspark_tpu_torch.data.datasets",
                "tsspark_tpu_torch.data.plane",
                "tsspark_tpu_torch.data.ingest",
                "tsspark_tpu_torch.data.loaders",
                "tsspark_tpu_torch.uncertainty",
                "tsspark_tpu_torch.uncertainty.advi",
                "tsspark_tpu_torch.uncertainty.qplane",
                "tsspark_tpu_torch.uncertainty.gold",
                "tsspark_tpu_torch.uncertainty.calibrate",
                "tsspark_tpu_torch.orchestrate",
                "tsspark_tpu_torch.resilience",
                "tsspark_tpu_torch.resilience.integrity",
                "tsspark_tpu_torch.resilience.report",
                "tsspark_tpu_torch.perf",
                "tsspark_tpu_torch.perf.recorder",
                "tsspark_tpu_torch.backends.registry",
                "tsspark_tpu_torch.kernels.build",
                "tsspark_tpu_torch.models.holidays",
                "tsspark_tpu_torch.utils.checkpoint",
                "tsspark_tpu_torch.eval.backtest",
                "tsspark_tpu_torch.eval.diagnostics",
                "tsspark_tpu_torch.fit",
                "tsspark_tpu_torch.fit.prophet",
                "tsspark_tpu_torch.__main__",
                "tsspark_tpu_torch.spark",
                "tsspark_tpu_torch.plot",
                "tsspark_tpu_torch.serve.cache",
                "tsspark_tpu_torch.serve.pool",
                "tsspark_tpu_torch.serve.replica",
                "tsspark_tpu_torch.serve.aotbank",
                "tsspark_tpu_torch.serve.__main__",
                "tsspark_tpu_torch.obs.regress",
                "tsspark_tpu_torch.utils.procmem",
                "tsspark_tpu_torch.parallel.mesh",
                "tsspark_tpu_torch.parallel.sharding",
                "tsspark_tpu_torch.resident",
                "tsspark_tpu_torch.refit",
                "tsspark_tpu_torch.utils.platform",
                "tsspark_tpu_torch.utils.profiling",
                "tsspark_tpu_torch.sched",
                "tsspark_tpu_torch.alerts",
                "tsspark_tpu_torch.alerts.score",
                "tsspark_tpu_torch.alerts.sink",
                "tsspark_tpu_torch.alerts.stream",
                "tsspark_tpu_torch.alerts.__main__",
                "tsspark_tpu_torch.alerts.bench",
                "tsspark_tpu_torch.bench_scale",
                "tsspark_tpu_torch.serve.planebench",
                "tsspark_tpu_torch.obs.ledger",
                "tsspark_tpu_torch.obs.watch",
                "tsspark_tpu_torch.obs.__main__",
                "tsspark_tpu_torch.perf.__main__",
                "tsspark_tpu_torch.utils.logging"):
        assert mod in out["modules"]


_HISTORY_LEAN = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["torch"] = None        # any `import torch` now raises
from tsspark_tpu_torch.obs import history, regress  # noqa: F401
from tsspark_tpu_torch.utils import procmem  # noqa: F401
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0]
                        in ("torch", "jax", "numpy"))))
"""


_OBS_TOOLS_LEAN = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["torch"] = None        # any `import torch` now raises
from tsspark_tpu_torch.obs import __main__, ledger, watch  # noqa: F401
from tsspark_tpu_torch.perf import __main__ as perf_main  # noqa: F401
from tsspark_tpu_torch.utils import logging  # noqa: F401
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0]
                        in ("torch", "jax"))))
"""


def test_obs_and_perf_tools_import_without_torch():
    """The run ledger, the live watch and the ``obs`` / ``perf`` CLIs are
    device-free, as the reference's (which never import JAX)."""
    proc = _run(_OBS_TOOLS_LEAN)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_history_and_sentinel_import_without_torch():
    """The run history and the sentinel are device-free: a history read
    works where the card (or torch) is unusable."""
    proc = _run(_HISTORY_LEAN)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_DATA_PLANE_LEAN = r"""
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["torch"] = None        # any `import torch` now raises
from tsspark_tpu_torch.data import ingest, plane  # noqa: F401
import tsspark_tpu_torch.data as data
data.DatasetSpec("m5", 4, 8)
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0]
                        in ("torch", "jax", "pandas"))))
"""


def test_data_plane_imports_without_torch():
    """The plane and the ingest (and the data package's export surface)
    import with torch and jax blocked, and without pandas: the ingest's
    child processes stay lean."""
    proc = _run(_DATA_PLANE_LEAN)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_prefix_check_tells_the_two_packages_apart():
    # tsspark_tpu_torch starts with "tsspark_tpu": the check above must not
    # flag the port itself, and must flag the JAX package.
    is_jax_pkg = lambda m: m == "tsspark_tpu" or m.startswith("tsspark_tpu.")  # noqa: E731
    assert not is_jax_pkg("tsspark_tpu_torch")
    assert not is_jax_pkg("tsspark_tpu_torch.serve")
    assert is_jax_pkg("tsspark_tpu") and is_jax_pkg("tsspark_tpu.config")


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    proc = _run(
        "import sys, runpy; sys.argv = ['chip_smoke.py']; "
        "import torch; torch.cuda.is_available = lambda: False; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')"
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_streaming_entry_point_raises_without_a_card(monkeypatch):
    """The streaming driver runs on the card unless asked for the CPU."""
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingForecaster()
    assert StreamingForecaster(device="cpu").device.type == "cpu"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_card(monkeypatch,
                                                          tmp_path):
    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.models.prophet.model import ProphetModel
    from tsspark_tpu_torch.serve import ParamRegistry, PredictionEngine

    _no_card(monkeypatch)
    cfg = ProphetConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProphetModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("cuda", cfg)
    reg = ParamRegistry(str(tmp_path / "reg"), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionEngine(reg)
    # Asking for the CPU explicitly is the only way onto it.
    assert ProphetModel(cfg, device="cpu").device.type == "cpu"
    assert PredictionEngine(reg, device="cpu").backend.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.design import FitData

    cfg = ProphetConfig(seasonalities=(), n_changepoints=0)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    data = FitData(t=meta(2, 3), y=meta(2, 3), mask=meta(2, 3),
                   s=meta(2, 0), cap=meta(2, 3), X_season=meta(3, 0),
                   X_reg=meta(2, 3, 0), prior_scales=meta(0),
                   mult_mask=meta(0))
    before = fk.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fk.forward(meta(2, 3), data, cfg)
    assert fk.launches == before


def test_cpu_wrappers_count_no_launches():
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.model import ProphetModel
    from tsspark_tpu_torch.carry import fitstate_from_numpy

    cfg = ProphetConfig(n_changepoints=3)
    b = 4
    rng = np.random.default_rng(0)
    state = fitstate_from_numpy({
        "theta": rng.normal(0, 0.1, (b, cfg.num_params)),
        "loss": np.zeros(b), "grad_norm": np.zeros(b),
        "converged": np.ones(b, bool), "n_iters": np.zeros(b, np.int32),
        "y_scale": np.ones(b), "floor": np.zeros(b),
        "ds_start": np.full(b, 18000.0), "ds_span": np.full(b, 100.0),
        "reg_mean": np.zeros((b, 0)), "reg_std": np.ones((b, 0)),
        "changepoints": np.tile([0.2, 0.4, 0.6], (b, 1)),
    })
    f0, b0 = fk.launches, bk.launches
    out = ProphetModel(cfg, device="cpu").predict(
        state, 18100.0 + np.arange(5.0), num_samples=16)
    assert out["yhat_lower"].shape == (b, 5)
    assert (fk.launches, bk.launches) == (f0, b0)


def test_advi_runs_on_the_card_or_raises(monkeypatch):
    """fit_advi's default device is the card (it raises without one); K7's
    wrapper refuses a device other than the CPU and CUDA; on the CPU the
    plain versions run and no launch is counted."""
    from tsspark_tpu_torch.config import AdviConfig, ProphetConfig
    from tsspark_tpu_torch.kernels import advi as advi_k
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.uncertainty import advi

    cfg = ProphetConfig(seasonalities=(), n_changepoints=2)
    rng = np.random.default_rng(2)
    ds = np.arange(40.0)
    y = 3.0 + 0.1 * ds + rng.normal(0, 0.2, (2, 40))
    data, _ = prepare_fit_data(ds, y, cfg)
    theta0 = rng.normal(0, 0.1, (2, cfg.num_params)).astype(np.float32)
    short = AdviConfig(num_steps=3)
    before = (lk.launches, advi_k.launches)
    post = advi.fit_advi(theta0, data, torch.Generator().manual_seed(0),
                         cfg, short, device="cpu")
    assert post.mu.shape == (2, cfg.num_params)
    assert (lk.launches, advi_k.launches) == before
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        advi_k.advi_step(m(8, 5), m(8), m(4, 2, 5), m(2, 5),
                         *[m(2, 5) for _ in range(6)],
                         advi_k.adam_scalars(short, 0))
    assert advi_k.launches == before[1]
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        advi.fit_advi(theta0, data, None, cfg, short)


def test_cpu_mcmc_counts_no_launches():
    """fit_mcmc and predict_mcmc on the CPU run K3's and K6's plain
    versions: no kernel launch is counted."""
    from tsspark_tpu_torch.config import McmcConfig, ProphetConfig
    from tsspark_tpu_torch.kernels import draws as dk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.model import ProphetModel

    cfg = ProphetConfig(seasonalities=(), n_changepoints=2)
    rng = np.random.default_rng(1)
    ds = np.arange(40.0)
    y = 3.0 + 0.1 * ds + rng.normal(0, 0.2, (2, 40))
    before = (lk.launches, dk.launches)
    model = ProphetModel(cfg, device="cpu")
    state = model.fit_mcmc(ds, y, mcmc_config=McmcConfig(
        num_samples=4, num_warmup=4, num_leapfrog=2))
    out = model.predict_mcmc(state, 40.0 + np.arange(5.0))
    assert out["yhat_lower"].shape == (2, 5)
    assert (lk.launches, dk.launches) == before


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(
        "import sys, runpy; sys.argv = ['chip_smoke.py']; "
        "import torch; torch.cuda.is_available = lambda: True; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')",
        cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
