"""High-level batched Prophet model: predict on padded arrays.

The array-level API the ``cuda`` backend sits on.  This slice of the
port serves fitted parameters: ``predict`` and ``components`` run on the
card (or, when asked, on the CPU); ``fit`` waits for the MAP-fit slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig, SolverConfig
from tsspark_tpu_torch.device import resolve_device
from tsspark_tpu_torch.models.prophet import predict as predict_mod
from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.utils.spans import StageClock


class FitState(NamedTuple):
    """Fitted parameters + scaling metadata + solver diagnostics.

    ``theta`` is a float32 (B, P) tensor; ``meta`` stays host numpy
    float64; the diagnostics are host numpy arrays.  ``status`` is None
    on states that never ran the solver.
    """

    theta: torch.Tensor
    meta: ScalingMeta
    loss: np.ndarray
    grad_norm: np.ndarray
    converged: np.ndarray
    n_iters: np.ndarray
    status: Optional[np.ndarray] = None


class ProphetModel:
    """Batched Prophet-style forecaster over fitted parameters.

    Example:
      model = ProphetModel(ProphetConfig())          # on the card
      fc = model.predict(state, future_days)          # dict of (B, H)
    """

    def __init__(self, config: ProphetConfig = ProphetConfig(),
                 solver_config: SolverConfig = SolverConfig(),
                 device=None):
        self.config = config
        self.solver_config = solver_config
        self.device = resolve_device(device)
        # Host seconds of "prep" (time map, features, copies to the
        # device) and "forecast" (the model's launches; on the card they
        # return before the kernels finish).
        self.stages = StageClock()

    def fit(self, *args, **kwargs) -> FitState:
        raise NotImplementedError("MAP fit: next port slice")

    def _theta(self, state: FitState) -> torch.Tensor:
        return torch.as_tensor(state.theta).to(self.device, torch.float32)

    def predict(
        self,
        state: FitState,
        ds: np.ndarray,
        cap: Optional[np.ndarray] = None,
        regressors: Optional[np.ndarray] = None,
        seed: int = 0,
        num_samples: Optional[int] = None,
        conditions=None,
        return_samples: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Forecast on an arbitrary time grid (in-sample and/or future)."""
        with self.stages.span("prep"):
            data = predict_mod.prepare_predict_data(
                ds, state.meta, self.config, self.device, cap=cap,
                regressors=regressors, conditions=conditions,
            )
            theta = self._theta(state)
        with self.stages.span("forecast"):
            return predict_mod.forecast(
                theta, data, state.meta, self.config, seed=seed,
                num_samples=num_samples, return_samples=return_samples,
            )

    def components(self, state: FitState, ds, cap=None, regressors=None,
                   conditions=None) -> Dict[str, torch.Tensor]:
        data = predict_mod.prepare_predict_data(
            ds, state.meta, self.config, self.device, cap=cap,
            regressors=regressors, conditions=conditions,
        )
        return predict_mod.component_breakdown(
            self._theta(state), data, state.meta, self.config
        )
