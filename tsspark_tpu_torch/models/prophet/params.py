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
