"""Trend functions: piecewise-linear, logistic-growth-with-cap, and flat.

Plain PyTorch versions of the JAX package's trend family.  The
changepoint sums are written as loops over the (small, default 25)
changepoint axis of elementwise ops on (B, T) tensors, in changepoint
order: the same order the forward kernel (``csrc/forward.cu``) adds in,
and every op is row- and timestep-local, so a row's values do not
depend on the batch it rides in.  On the card the model's forward pass
goes through that kernel; these functions are its plain version and
the component breakdown's trend.
"""

from __future__ import annotations

import numpy as np
import torch


def step_weighted_sum(values: torch.Tensor, t: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """sum_j values_j * 1[t >= s_j].

    values, s: (B, n_cp); t: (B, T) -> (B, T).  A changepoint is active
    AT its own timestamp (``searchsorted(side="right")``).
    """
    out = torch.zeros_like(t)
    for j in range(s.shape[-1]):
        out = out + torch.where(t >= s[..., j : j + 1],
                                values[..., j : j + 1], 0.0)
    return out


def piecewise_linear(t: torch.Tensor, k: torch.Tensor, m: torch.Tensor,
                     delta: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """g(t) = k*t + m + sum_j delta_j * relu(t - s_j)  (the hinge form of
    Prophet's continuous piecewise-linear trend).

    Shapes: t (B, T); k, m (B,); delta, s (B, n_cp).  Returns (B, T).
    """
    g = k[..., None] * t + m[..., None]
    for j in range(s.shape[-1]):
        g = g + delta[..., j : j + 1] * torch.clamp(
            t - s[..., j : j + 1], min=0.0
        )
    return g


def _safe_div(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-10
              ) -> torch.Tensor:
    small = torch.where(b < 0, -eps, eps)
    return a / torch.where(b.abs() < eps, small, b)


def _logistic_gamma(k: torch.Tensor, m: torch.Tensor, delta: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """Offset adjustments keeping the logistic trend continuous.

    Sequential recursion over changepoints (public Prophet definition):
      gamma_j = (s_j - m - sum_{l<j} gamma_l) * (1 - k_{j-1} / k_j)
    with k_j = k + sum_{l<=j} delta_l.  A Python loop over n_cp.
    """
    # k_j = k + (delta_0 + ... + delta_j), the running sum taken in
    # changepoint order as the forward kernel takes it: the recursion is
    # ill-conditioned where k_j nears 0, so every version must form k_j
    # from the same sums to agree there.
    gammas = []
    gamma_sum = torch.zeros_like(m)
    csum = torch.zeros_like(k)
    k_prev = k
    for j in range(delta.shape[-1]):
        csum = csum + delta[..., j]
        k_next = k + csum
        gamma_j = (s[..., j] - m - gamma_sum) * (
            1.0 - _safe_div(k_prev, k_next)
        )
        gammas.append(gamma_j)
        gamma_sum = gamma_sum + gamma_j
        k_prev = k_next
    if not gammas:
        return torch.zeros_like(delta)
    return torch.stack(gammas, dim=-1)


def logistic(t: torch.Tensor, cap: torch.Tensor, k: torch.Tensor,
             m: torch.Tensor, delta: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """Logistic growth trend with (possibly time-varying) capacity.

    g(t) = cap(t) / (1 + exp(-(k + A(t)delta) * (t - (m + A(t)gamma)))).

    Shapes: t, cap (B, T); k, m (B,); delta, s (B, n_cp).  Returns (B, T).
    """
    rate = k[..., None] + step_weighted_sum(delta, t, s)
    gamma = _logistic_gamma(k, m, delta, s)
    offset = m[..., None] + step_weighted_sum(gamma, t, s)
    return cap * torch.sigmoid(rate * (t - offset))


def flat(t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Constant trend g(t) = m."""
    return m[..., None].expand(t.shape).to(t.dtype)


def uniform_changepoints(t_first: np.ndarray, t_last: np.ndarray,
                         n_changepoints: int, changepoint_range: float
                         ) -> np.ndarray:
    """Per-series changepoint grid (host numpy), uniform over the first
    ``changepoint_range`` fraction of each series' observed span, skipping
    the first observation.  Returns (B, n_changepoints)."""
    if n_changepoints == 0:
        return np.zeros(t_first.shape + (0,), t_first.dtype)
    span = (t_last - t_first) * changepoint_range
    fracs = np.arange(1, n_changepoints + 1,
                      dtype=t_first.dtype) / n_changepoints
    return t_first[..., None] + span[..., None] * fracs[None, :]
