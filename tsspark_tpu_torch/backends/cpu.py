"""CPU reference backend: per-series scipy L-BFGS-B.

The parity oracle for the batched solver: the same loss (the port's
plain ``value_and_grad_batch`` on CPU float32 tensors, gradient written
out by hand), the same design tensors and the same warm-start policy
(``SolverConfig.init``), driven by an independent, battle-tested
optimizer one series at a time.  Its job is correctness, not speed.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from tsspark_tpu_torch.backends.registry import (
    ForecastBackend,
    register_backend,
)
from tsspark_tpu_torch.models.prophet.design import (
    fitdata_to_device,
    prepare_fit_data,
    take_fit_data,
)
from tsspark_tpu_torch.models.prophet.init import initial_theta
from tsspark_tpu_torch.models.prophet.loss import value_and_grad_batch
from tsspark_tpu_torch.models.prophet.model import FitState, ProphetModel


@register_backend
class CpuBackend(ForecastBackend):
    name = "cpu"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._model = ProphetModel(self.config, self.solver_config,
                                   device="cpu")
        self.device = self._model.device

    def fit(self, ds, y, mask=None, cap=None, floor=None, regressors=None,
            init=None, conditions=None) -> FitState:
        cfg = self.config
        data_np, meta = prepare_fit_data(
            ds, y, cfg, mask=mask, cap=cap, floor=floor,
            regressors=regressors, conditions=conditions,
        )
        data = fitdata_to_device(data_np, "cpu")
        # Same warm-start policy as the batched path, so parity runs
        # compare solver behavior, not starting points.
        theta0 = init if init is not None else initial_theta(
            data, cfg, self.solver_config)
        theta0 = np.asarray(torch.as_tensor(theta0).detach().cpu(),
                            np.float64)
        b = theta0.shape[0]
        out = np.empty_like(theta0)
        losses = np.empty(b)
        grad_norms = np.empty(b)
        conv = np.empty(b, bool)
        n_iters = np.empty(b, np.int32)

        for i in range(b):
            data_i = take_fit_data(data, torch.tensor([i]))

            def f_and_g(th):
                f, g = value_and_grad_batch(
                    torch.from_numpy(th.astype(np.float32))[None], data_i,
                    cfg)
                return float(f[0]), g[0].double().numpy()

            res = scipy.optimize.minimize(
                f_and_g,
                theta0[i],
                jac=True,
                method="L-BFGS-B",
                options={
                    "maxiter": self.solver_config.max_iters,
                    "ftol": 1e-9,
                    "gtol": 1e-7,
                },
            )
            out[i] = res.x
            losses[i] = res.fun
            grad_norms[i] = np.abs(np.asarray(res.jac)).max()
            conv[i] = res.success
            n_iters[i] = res.nit

        return FitState(
            theta=torch.from_numpy(out.astype(np.float32)),
            meta=meta,
            loss=losses.astype(np.float32),
            grad_norm=grad_norms.astype(np.float32),
            converged=conv,
            n_iters=n_iters,
        )

    def _numpy(self, out):
        return {k: v.cpu().numpy() for k, v in out.items()}

    def predict(self, state, ds, cap=None, regressors=None, seed=0,
                num_samples=None, conditions=None):
        return self._numpy(self._model.predict(
            state, ds, cap=cap, regressors=regressors, seed=seed,
            num_samples=num_samples, conditions=conditions,
        ))

    def components(self, state, ds, cap=None, regressors=None,
                   conditions=None):
        return self._numpy(self._model.components(
            state, ds, cap=cap, regressors=regressors,
            conditions=conditions,
        ))
