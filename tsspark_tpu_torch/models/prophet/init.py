"""Solver initialization: closed-form ridge warm start for the MAP fit.

For additive composition the Prophet mean is LINEAR in every parameter
except the observation noise:

    yhat = k*t + m + sum_j delta_j * relu(t - s_j) + X @ beta

so the MAP problem with the Laplace changepoint prior replaced by its
Gaussian moment-match is a batched masked ridge regression: one
``(B, Q, Q)`` Gram (a large batched product, ``torch.matmul``) and a
batched Cholesky solve (``torch.linalg``; TF32 is off, see
``device.set_precision``).  L-BFGS then only has to account for the
Laplace-vs-Gaussian prior difference and the sigma coupling.

Non-additive cases degrade gracefully: multiplicative features are treated
as additive for the init, and non-linear growth (logistic/flat) keeps an
endpoint heuristic for (k, m) and ridge-solves only the feature betas
against the de-trended target.
"""

from __future__ import annotations

import torch

from tsspark_tpu_torch.config import ProphetConfig, SolverConfig
from tsspark_tpu_torch.models.prophet import trend as trend_mod
from tsspark_tpu_torch.models.prophet.params import (
    ProphetParams,
    init_theta,
    pack,
    unpack,
)


def _masked_sigma(resid: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked residual std, floored away from log(0)."""
    n = torch.clamp(mask.sum(dim=-1), min=1.0)
    var = (resid * resid * mask).sum(dim=-1) / n
    return torch.sqrt(torch.clamp(var, min=1e-8))


#: Rows the ridge solve has refactored in float64 since the count was
#: last set to 0 (their float32 Cholesky refused; see ``_ridge_solve``).
float64_rows = 0


def _ridge_solve(
    phi: torch.Tensor,         # (B, T, Q) design columns
    y: torch.Tensor,           # (B, T) target
    mask: torch.Tensor,        # (B, T)
    prior_prec: torch.Tensor,  # (Q,) Gaussian prior precision per column
    sigma2: torch.Tensor,      # (B,) noise variance estimate
) -> torch.Tensor:
    """Batched masked ridge: argmin ||mask*(y - phi w)||^2/sigma2 + w'Λw."""
    phi_m = phi * mask[..., None]
    # (B, Q, Q) Gram and (B, Q) moment: batched products in full float32.
    gram = torch.matmul(phi_m.transpose(1, 2), phi)
    rhs = torch.matmul(phi_m.transpose(1, 2), y[..., None])
    del phi_m
    q = phi.shape[-1]
    lam = prior_prec[None, :] * sigma2[:, None] + 1e-6
    a = gram + torch.eye(q, dtype=phi.dtype, device=phi.device)[None] \
        * lam[:, :, None]
    chol, info = torch.linalg.cholesky_ex(a)
    bad = info != 0
    # A factorization that fails gives NaN rows instead of raising for the
    # whole batch.
    chol = torch.where(bad[:, None, None], torch.nan, chol)
    z = torch.linalg.solve_triangular(chol, rhs, upper=False)
    w = torch.linalg.solve_triangular(chol.transpose(1, 2), z,
                                      upper=True)[..., 0]
    if bool(bad.any()):
        # LAPACK's float32 Cholesky refuses a nearly singular Gram (a
        # season longer than the series, e.g. yearly order 10 on 180
        # days) that XLA's factors; those rows are solved in float64
        # instead, and any row that fails there too stays NaN.  Rows
        # that factor in float32 keep their float32 bits.
        global float64_rows
        float64_rows += int(bad.sum())
        a64, rhs64 = a[bad].double(), rhs[bad].double()
        chol64, info64 = torch.linalg.cholesky_ex(a64)
        chol64 = torch.where((info64 != 0)[:, None, None], torch.nan,
                             chol64)
        z64 = torch.linalg.solve_triangular(chol64, rhs64, upper=False)
        w[bad] = torch.linalg.solve_triangular(
            chol64.transpose(1, 2), z64, upper=True)[..., 0].to(w.dtype)
    return w


def _feature_matrix(data, b: int) -> torch.Tensor:
    """(B, T, F) stacked seasonal + regressor columns (broadcast shared grid)."""
    xs = data.X_season
    if xs.ndim == 2:
        xs = xs[None].expand((b,) + tuple(xs.shape))
    return torch.cat([xs, data.X_reg], dim=-1)


def _logistic_km_init(y: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
                      cap: torch.Tensor):
    """Batched logit-space endpoint init for the logistic trend.

    Invert the sigmoid at the observed endpoints (Prophet's
    ``logistic_growth_init`` does the same per series):

        L_i = logit(clip(y_i / cap_i))  =>  k = (L1 - L0) / (t1 - t0),
                                            m = t0 - L0 / k.
    """
    eps = 1e-8
    big = torch.where(mask > 0, t, torch.inf)
    small = torch.where(mask > 0, t, -torch.inf)
    i0 = torch.argmin(big, dim=-1, keepdim=True)
    i1 = torch.argmax(small, dim=-1, keepdim=True)
    at = lambda a, i: a.gather(-1, i)[:, 0]  # noqa: E731
    t0, t1 = at(t, i0), at(t, i1)
    cap0 = torch.clamp(at(cap, i0), min=eps)
    cap1 = torch.clamp(at(cap, i1), min=eps)
    r0 = torch.clamp(at(y, i0) / cap0, 0.01, 0.99)
    r1 = torch.clamp(at(y, i1) / cap1, 0.01, 0.99)
    # Near-identical endpoints leave the rate unidentifiable; nudge r0 so
    # the init still points somewhere definite (Prophet's 1.05 bump).
    r0 = torch.where((r0 - r1).abs() <= 0.01,
                     torch.clamp(r0 * 1.05, 0.01, 0.99), r0)
    l0 = torch.log(r0 / (1.0 - r0))
    l1 = torch.log(r1 / (1.0 - r1))
    # Degenerate span (single observed point; all-masked padding rows):
    # start those rows flat instead of at a manufactured huge rate.
    span = t1 - t0
    degenerate = span < 1e-6
    k0 = torch.where(degenerate, 0.0,
                     (l1 - l0) / torch.clamp(span, min=eps))
    safe_k = torch.where(k0.abs() < eps,
                         torch.where(k0 < 0, -eps, eps), k0)
    m0 = torch.where(k0.abs() >= eps, t0 - l0 / safe_k, 0.5 * (t0 + t1))
    return k0, m0


def ridge_init(data, config: ProphetConfig) -> torch.Tensor:
    """Closed-form warm start (B, P) for the batched MAP solve.

    ``data`` is a design.FitData of tensors on one device.  Fully-masked
    padding rows come out as all-zero parameters with floor sigma (their
    Gram is pure prior): inert, as the chunk padding needs.
    """
    y, mask, t = data.y, data.mask, data.t
    b, _ = y.shape
    n_cp = config.n_changepoints
    f = config.num_features
    dev, dtype = y.device, y.dtype

    # Rough sigma estimate for the prior/likelihood balance: masked std of y.
    n = torch.clamp(mask.sum(dim=-1), min=1.0)
    mean = (y * mask).sum(dim=-1) / n
    sigma2_0 = torch.clamp(_masked_sigma(y - mean[:, None], mask) ** 2,
                           min=1e-4)

    feats = [] if f == 0 else [_feature_matrix(data, b)]
    feat_prec = (1.0 / torch.tensor(config.feature_prior_scales(),
                                    dtype=dtype, device=dev)) ** 2

    if config.growth == "linear":
        # Columns in theta packing order minus log_sigma:
        #   [t (k), 1 (m), relu(t - s_j) (delta), features (beta)].
        cols = [t[..., None], torch.ones_like(t)[..., None]]
        if n_cp:
            cols.append(torch.clamp(t[..., None] - data.s[:, None, :],
                                    min=0.0))
        cols += feats
        phi = torch.cat(cols, dim=-1)
        del cols, feats
        # Laplace(0, b) moment-matched to Normal(0, sqrt(2) b).
        cp_prec = torch.full((n_cp,), 0.5 / (config.changepoint_prior_scale
                                             ** 2), dtype=dtype, device=dev)
        prior_prec = torch.cat([
            torch.tensor([1.0 / config.k_prior_scale ** 2,
                          1.0 / config.m_prior_scale ** 2],
                         dtype=dtype, device=dev),
            cp_prec,
            feat_prec,
        ])
        w = _ridge_solve(phi, y, mask, prior_prec, sigma2_0)
        k0, m0 = w[:, 0], w[:, 1]
        delta0 = w[:, 2:2 + n_cp]
        beta0 = w[:, 2 + n_cp:]
        yhat = torch.matmul(phi, w[..., None])[..., 0]
        del phi
    else:
        # Non-linear growth: growth-aware endpoint heuristic for (k, m);
        # ridge only for the feature betas against the de-trended target.
        delta0 = y.new_zeros((b, n_cp))
        if config.growth == "logistic":
            k0, m0 = _logistic_km_init(y, mask, t, data.cap)
            g0 = trend_mod.logistic(t, data.cap, k0, m0, delta0, data.s)
        else:
            # Flat trend: the MAP-optimal constant is the masked mean.
            n_f = torch.clamp(mask.sum(dim=-1), min=1.0)
            k0 = y.new_zeros((b,))
            m0 = (y * mask).sum(dim=-1) / n_f
            g0 = trend_mod.flat(t, m0)
        if f:
            phi = feats[0]
            w = _ridge_solve(phi, y - g0, mask, feat_prec, sigma2_0)
            beta0 = w
            yhat = g0 + torch.matmul(phi, w[..., None])[..., 0]
        else:
            beta0 = y.new_zeros((b, 0))
            yhat = g0

    sigma = _masked_sigma(y - yhat, mask)
    log_sigma0 = torch.log(torch.clamp(sigma, min=1e-3))
    return pack(ProphetParams(k=k0, m=m0, log_sigma=log_sigma0,
                              delta=delta0, beta=beta0))


def initial_theta(data, config: ProphetConfig,
                  solver_config: SolverConfig) -> torch.Tensor:
    """Dispatch on SolverConfig.init: "ridge" (default) or "heuristic"."""
    if solver_config.init == "ridge":
        return ridge_init(data, config)
    return init_theta(config, data.y, data.mask, data.t)


def curvature_diag(data, config: ProphetConfig, theta0: torch.Tensor
                   ) -> torch.Tensor:
    """(B, P) inverse Gauss-Newton-diagonal of the MAP objective at theta0.

    The L-BFGS initial metric (ops/lbfgs.py): the Prophet posterior mixes
    parameters whose curvatures differ by orders of magnitude, and in
    float32 the unpreconditioned solver stalls on such series.  The GN
    diagonal is exact for every linear parameter; non-linear growth reuses
    the linear-trend columns as scale proxies.
    """
    p = unpack(theta0, config)
    mask, t = data.mask, data.t
    b = t.shape[0]
    dtype, dev = t.dtype, t.device
    sigma = 1e-5 + torch.exp(p.log_sigma)  # matches loss._SIGMA_FLOOR
    w = mask / (sigma * sigma)[:, None]  # (B, T) residual precision
    n_obs = mask.sum(dim=-1)

    h_k = (w * t * t).sum(dim=-1) + 1.0 / config.k_prior_scale ** 2
    h_m = w.sum(dim=-1) + 1.0 / config.m_prior_scale ** 2
    # d2/dlog_sigma2 of [n log sigma + SSR/(2 sigma^2)] ~ 2 n at the optimum;
    # the floor keeps fully-masked padding rows finite.
    h_sig = torch.clamp(2.0 * n_obs, min=1.0) \
        + 1.0 / config.sigma_prior_scale ** 2
    parts = [h_k[:, None], h_m[:, None], h_sig[:, None]]
    if config.n_changepoints:
        relu = torch.clamp(t[:, :, None] - data.s[:, None, :], min=0.0)
        h_delta = torch.matmul(w[:, None, :], relu * relu)[:, 0]
        del relu
        # Laplace(0, b) moment-matched to Normal(0, sqrt(2) b), like the
        # ridge init: the kink's own curvature would freeze changepoints.
        h_delta = h_delta + 0.5 / config.changepoint_prior_scale ** 2
        parts.append(h_delta)
    if config.num_features:
        x = _feature_matrix(data, b)
        h_beta = torch.matmul(w[:, None, :], x * x)[:, 0]
        h_beta = h_beta + 1.0 / torch.tensor(
            config.feature_prior_scales(), dtype=dtype, device=dev) ** 2
        parts.append(h_beta)
    return 1.0 / torch.cat(parts, dim=-1)
