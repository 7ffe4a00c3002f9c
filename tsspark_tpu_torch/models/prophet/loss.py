"""Batched negative log-posterior for the Prophet MAP fit.

The public Prophet probability model:

  y_t ~ Normal(yhat_t, sigma)                 (masked over padding / missing)
  k ~ Normal(0, k_prior_scale)
  m ~ Normal(0, m_prior_scale)
  delta_j ~ Laplace(0, changepoint_prior_scale)   <- sparsity over changepoints
  beta_f ~ Normal(0, prior_scale_f)
  sigma ~ HalfNormal(sigma_prior_scale)

Everything is per-series independent, so the batch loss is a (B,) vector
and the gradient is a (B, P) block of per-series gradients.  The Laplace
prior's |delta| kink is smoothed with a tiny Huber radius so the batched
L-BFGS (ops/lbfgs.py) sees a C1 objective.

``neg_log_posterior`` is the plain PyTorch loss (autograd can run through
it).  The solver's entry points run the hand-written kernels on a CUDA
tensor: ``value_batch`` and ``value_and_grad_batch`` launch K3
(``kernels.loss``), ``fan_value_closed_form`` launches K4
(``kernels.fan``); on a CPU tensor each runs its kernel's plain version,
whose gradient is written out by hand.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import fan as fan_kernel
from tsspark_tpu_torch.kernels import loss as loss_kernel
from tsspark_tpu_torch.models.prophet.design import FitData

_HUBER_EPS = loss_kernel.HUBER_EPS
# Floor on the observation noise (scaled units): without it the MAP
# objective is unbounded below for (near-)interpolating series.
_SIGMA_FLOOR = loss_kernel.SIGMA_FLOOR
_smooth_abs = loss_kernel.smooth_abs


def neg_log_posterior(theta: torch.Tensor, data: FitData,
                      config: ProphetConfig) -> torch.Tensor:
    """Per-series negative log posterior, shape (B,), in plain torch ops:
    the value half of K3's plain version (autograd runs through it)."""
    return loss_kernel.loss_plain(theta, data, config, grad=False)[0]


def value_batch(theta: torch.Tensor, data: FitData,
                config: ProphetConfig) -> torch.Tensor:
    """Per-series losses, no gradient.  ``theta`` is (B, P) or a stack
    (N, B, P) of trial points on the same (B, T) data -> (B,) or (N, B)."""
    lead = theta.shape[:-1]
    f, _ = loss_kernel.loss(theta.reshape(-1, theta.shape[-1]).contiguous(),
                            data, config, grad=False)
    return f.reshape(lead)


def has_closed_form_fan(config: ProphetConfig) -> bool:
    """True when the line-search fan has a closed form along a ray: linear
    growth (any feature modes).  Logistic/flat growth is not polynomial in
    the trend parameters, so those configs use the stacked fan."""
    return config.growth == "linear"


def fan_value_closed_form(
    theta: torch.Tensor,      # (B, P) current point
    direction: torch.Tensor,  # (B, P) search direction
    ladder: torch.Tensor,     # (K, B) candidate step sizes
    data: FitData,
    config: ProphetConfig,
) -> torch.Tensor:
    """Closed-form losses (K, B) for the whole Armijo step ladder (K4 on
    the card; ``kernels.fan.fan_plain`` documents the algebra)."""
    return fan_kernel.fan(theta.contiguous(), direction.contiguous(),
                          ladder.contiguous(), data, config)


def value_and_grad_batch(theta: torch.Tensor, data: FitData,
                         config: ProphetConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-series losses (B,) and gradients (B, P)."""
    return loss_kernel.loss(theta.contiguous(), data, config, grad=True)
