"""Parameter layout for the batched Prophet model.

The flat ``(batch, P)`` float32 tensor packs
``[k, m, log_sigma, delta[0:n_cp], beta[0:F]]``, the same layout as the
JAX package, so fitted parameters cross between the two unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tsspark_tpu_torch.config import ProphetConfig


class ProphetParams(NamedTuple):
    """Structured view of one (or a batch of) parameter vector(s)."""

    k: torch.Tensor          # (B,)   base trend growth rate
    m: torch.Tensor          # (B,)   trend offset
    log_sigma: torch.Tensor  # (B,)   log observation noise
    delta: torch.Tensor      # (B, n_changepoints) changepoint rate adjustments
    beta: torch.Tensor       # (B, F) seasonal + regressor coefficients


def unpack(theta: torch.Tensor, config: ProphetConfig) -> ProphetParams:
    """Split a flat (..., P) parameter tensor into structured views."""
    n_cp = config.n_changepoints
    f = config.num_features
    if theta.shape[-1] != 3 + n_cp + f:
        raise ValueError(
            f"theta last dim {theta.shape[-1]} != expected {3 + n_cp + f}"
        )
    return ProphetParams(
        k=theta[..., 0],
        m=theta[..., 1],
        log_sigma=theta[..., 2],
        delta=theta[..., 3 : 3 + n_cp],
        beta=theta[..., 3 + n_cp :],
    )


def pack(params: ProphetParams) -> torch.Tensor:
    """Inverse of :func:`unpack`."""
    return torch.cat(
        [
            params.k[..., None],
            params.m[..., None],
            params.log_sigma[..., None],
            params.delta,
            params.beta,
        ],
        dim=-1,
    )


def init_theta(config: ProphetConfig, y: torch.Tensor, mask: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Data-driven initialization, batched over series (the "heuristic"
    init of ``SolverConfig.init``).

    Prophet's initializer: k/m from the endpoints of the (scaled) series,
    deltas and betas at zero, sigma at the masked std of y.

    Args:
      y:    (B, T) scaled observations (already divided by per-series scale).
      mask: (B, T) 1.0 where observed.
      t:    (B, T) scaled time in [0, 1] (per series).

    Returns:
      (B, P) flat initial parameters.
    """
    eps = 1e-8
    n = torch.clamp(mask.sum(dim=-1), min=1.0)

    # First/last observed values and times per series (masked argmin/argmax).
    big = torch.where(mask > 0, t, torch.inf)
    small = torch.where(mask > 0, t, -torch.inf)
    i0 = torch.argmin(big, dim=-1, keepdim=True)
    i1 = torch.argmax(small, dim=-1, keepdim=True)
    t0, t1 = t.gather(-1, i0)[:, 0], t.gather(-1, i1)[:, 0]
    y0, y1 = y.gather(-1, i0)[:, 0], y.gather(-1, i1)[:, 0]

    k0 = (y1 - y0) / torch.clamp(t1 - t0, min=eps)
    m0 = y0 - k0 * t0

    mean = (y * mask).sum(dim=-1) / n
    var = (((y - mean[:, None]) ** 2) * mask).sum(dim=-1) / n
    sigma0 = torch.sqrt(torch.clamp(var, min=eps))
    log_sigma0 = torch.log(torch.clamp(sigma0, min=1e-3))

    batch = y.shape[0]
    return pack(
        ProphetParams(
            k=k0,
            m=m0,
            log_sigma=log_sigma0,
            delta=y.new_zeros((batch, config.n_changepoints)),
            beta=y.new_zeros((batch, config.num_features)),
        )
    )
