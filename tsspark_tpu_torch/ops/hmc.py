"""Batched Hamiltonian Monte Carlo with Stan-style warmup adaptation.

The JAX package's sampler (``ops/hmc.py`` there) in torch ops: ONE chain
PER SERIES, all chains advanced in lockstep by a host loop of batched
(B, P) tensor ops, the log density one call for the whole batch (K3 on
the card, through ``models.prophet.model.mcmc_core``).

Adaptation follows Stan's scheme in two phases of the warmup:

  phase A (first half of warmup): dual-averaging step size (Nesterov; per
    chain) against a unit metric while a Welford accumulator estimates the
    posterior variance;
  phase B (second half): metric is set to the phase-A variance estimate,
    dual averaging restarts, Welford restarts; at the end the metric is
    updated again and the step size freezes at the averaged iterate.

Momenta are drawn per chain with the diagonal metric M^-1 = var(theta);
a trajectory is a fixed number of leapfrog steps with a multiplicative
step-size jitter; a non-finite or exploding Hamiltonian is a divergence
and rejects that chain's proposal only.

Variates come from an explicit ``torch.Generator`` on the chains'
device, three per transition: a standard normal ``z`` (B, P) for the
momenta, a U(0, 1) ``jit_u`` (B,) for the jitter and a U(0, 1)
``acc_u`` (B,) for the Metropolis test.  ``_hmc_transition`` takes them
as arguments and ``sample`` takes a ``draws`` callable in place of the
generator, so the JAX package's own draws can be fed in.  Every
statistic is float32, as the JAX package keeps it.

``split_rhat_ess`` is the convergence summary, in float64: a numpy copy
of the JAX package's over blocks of series on a few host threads, or,
for draws on the card, the same arithmetic in torch on the card (held to
the numpy version at float64 tolerance).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import McmcConfig

# Dual-averaging constants (Hoffman & Gelman 2014, as used by Stan).
_DA_GAMMA = np.float32(0.05)
_DA_T0 = np.float32(10.0)
_DA_KAPPA = np.float32(0.75)

LogDensity = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
#: transition index -> (z (B, P), jit_u (B,), acc_u (B,))
Draws = Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class ChainState(NamedTuple):
    theta: torch.Tensor         # (B, P) current positions
    logp: torch.Tensor          # (B,)   cached log density
    grad: torch.Tensor          # (B, P) cached gradient of log density
    inv_mass: torch.Tensor      # (B, P) diagonal metric M^-1 (~ posterior var)
    # dual averaging (per chain)
    log_step: torch.Tensor      # (B,)
    log_step_avg: torch.Tensor  # (B,)
    da_stat: torch.Tensor       # (B,)   running H_t statistic
    da_mu: torch.Tensor         # (B,)   shrinkage target
    # Welford variance accumulator
    w_count: np.float32         # host scalar: every chain counts alike
    w_mean: torch.Tensor        # (B, P)
    w_m2: torch.Tensor          # (B, P)


class HmcResult(NamedTuple):
    samples: torch.Tensor       # (S, B, P) post-warmup draws
    accept_rate: torch.Tensor   # (B,) mean acceptance prob over sampling
    step_size: torch.Tensor     # (B,) adapted step size
    inv_mass: torch.Tensor      # (B, P) adapted diagonal metric
    divergences: torch.Tensor   # (B,) divergent-transition count over sampling


class SampleTiming:
    """Host seconds in the transition loops and the leapfrog steps run
    (log-density calls inside trajectories), summed over every ``sample``
    in the process; reset before reading."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.host_s = 0.0
        self.leapfrogs = 0


timing = SampleTiming()


def _leapfrog(logdensity_and_grad: LogDensity, theta, r, grad, eps,
              inv_mass, n_steps: int):
    """n_steps of leapfrog; eps is per-chain (B, 1)."""
    th, mom, g = theta, r, grad
    logp = None
    for _ in range(n_steps):
        mom_half = mom + 0.5 * eps * g
        th = th + eps * inv_mass * mom_half
        logp, g = logdensity_and_grad(th)
        mom = mom_half + 0.5 * eps * g
    timing.leapfrogs += n_steps
    return th, mom, g, logp


def _jitter_factor(jit_u: torch.Tensor, step_jitter: float) -> torch.Tensor:
    """The multiplicative step jitter U(1 - j, 1 + j) from a U(0, 1) draw,
    formed as ``jax.random.uniform`` forms it: u * (hi - lo) + lo in
    float32, floored at lo."""
    lo = np.float32(1.0 - step_jitter)
    hi = np.float32(1.0 + step_jitter)
    return torch.clamp(jit_u * float(hi - lo) + float(lo), min=float(lo))


def _hmc_transition(state: ChainState, logdensity_and_grad: LogDensity,
                    config: McmcConfig, z: torch.Tensor, jit_u: torch.Tensor,
                    acc_u: torch.Tensor):
    """One batched HMC proposal + per-chain Metropolis accept, on the
    given draws (see the module docstring).

    Returns (new_state, accept_prob (B,), divergent (B,)).
    """
    # r ~ N(0, M): std = 1/sqrt(inv_mass).
    r0 = z / torch.sqrt(torch.clamp(state.inv_mass, min=1e-12))
    eps = torch.exp(state.log_step)
    if config.step_jitter > 0:
        eps = eps * _jitter_factor(jit_u, config.step_jitter)
    eps = eps[:, None]

    theta1, r1, grad1, logp1 = _leapfrog(
        logdensity_and_grad, state.theta, r0, state.grad, eps,
        state.inv_mass, config.num_leapfrog,
    )

    kin0 = 0.5 * torch.sum(r0 * r0 * state.inv_mass, dim=-1)
    kin1 = 0.5 * torch.sum(r1 * r1 * state.inv_mass, dim=-1)
    h0 = -state.logp + kin0
    h1 = -logp1 + kin1
    log_alpha = torch.clamp(h0 - h1, max=0.0)
    divergent = ~torch.isfinite(h1) | ((h1 - h0) > config.divergence_threshold)
    accept_prob = torch.where(divergent, torch.zeros_like(log_alpha),
                              torch.exp(log_alpha))

    accept = (acc_u < accept_prob) & ~divergent
    acc = accept[:, None]
    new_state = state._replace(
        theta=torch.where(acc, theta1, state.theta),
        logp=torch.where(accept, logp1, state.logp),
        grad=torch.where(acc, grad1, state.grad),
    )
    return new_state, accept_prob, divergent


def _da_update(state: ChainState, accept_prob: torch.Tensor, i: np.float32,
               config: McmcConfig) -> ChainState:
    """Per-chain Nesterov dual averaging toward target acceptance; ``i``
    the float32 dual-averaging counter."""
    t = np.float32(i) + _DA_T0
    eta = np.float32(1.0) / t
    target = np.float32(config.target_accept)
    stat = (float(np.float32(1.0) - eta) * state.da_stat
            + float(eta) * (float(target) - accept_prob))
    log_step = state.da_mu - float(np.sqrt(t) / _DA_GAMMA) * stat
    w = np.power(t, -_DA_KAPPA, dtype=np.float32)
    log_step_avg = (float(w) * log_step
                    + float(np.float32(1.0) - w) * state.log_step_avg)
    return state._replace(da_stat=stat, log_step=log_step,
                          log_step_avg=log_step_avg)


def _welford_update(state: ChainState, theta: torch.Tensor) -> ChainState:
    c = np.float32(state.w_count + np.float32(1.0))
    d = theta - state.w_mean
    mean = state.w_mean + d / float(c)
    m2 = state.w_m2 + d * (theta - mean)
    return state._replace(w_count=c, w_mean=mean, w_m2=m2)


def _welford_var(state: ChainState, regularize: bool = True) -> torch.Tensor:
    n = np.maximum(state.w_count - np.float32(1.0), np.float32(1.0))
    var = state.w_m2 / float(n)
    if regularize:
        # Stan's shrinkage toward unit metric for short windows.
        w = np.float32(state.w_count / (state.w_count + np.float32(5.0)))
        var = float(w) * var + float(
            np.float32(np.float32(1.0) - w) * np.float32(1e-3))
    return torch.clamp(var, min=1e-10)


def _switch(s: ChainState) -> ChainState:
    """Phase switch: install the estimated metric, restart adaptation."""
    ls = s.log_step_avg  # keep the adapted scale as the new start
    return s._replace(
        inv_mass=_welford_var(s),
        log_step=ls,
        log_step_avg=ls,
        da_stat=torch.zeros_like(s.da_stat),
        da_mu=ls + float(np.log(np.float32(10.0))),
        w_count=np.float32(0.0),
        w_mean=torch.zeros_like(s.w_mean),
        w_m2=torch.zeros_like(s.w_m2),
    )


def generator_draws(generator: torch.Generator, b: int, p: int,
                    device: torch.device) -> Draws:
    """The sampler's own variates: per transition z, jit_u, acc_u from
    ``generator`` (on ``device``), in that order."""

    def draw(_i: int):
        z = torch.randn((b, p), generator=generator, device=device)
        jit_u = torch.rand((b,), generator=generator, device=device)
        acc_u = torch.rand((b,), generator=generator, device=device)
        return z, jit_u, acc_u

    return draw


def sample(
    logdensity_fn: LogDensity,
    theta0: torch.Tensor,
    generator: Optional[torch.Generator],
    config: McmcConfig,
    draws: Optional[Draws] = None,
) -> HmcResult:
    """Run B parallel HMC chains from theta0 (B, P).

    Args:
      logdensity_fn: (B, P) -> ((B,) log densities, (B, P) gradients), the
        whole batch in one call.
      theta0: per-chain initial positions (typically the MAP fit, jittered).
      generator: the variates' source (on theta0's device), unless
        ``draws`` gives them: transition i (warmup first, then sampling)
        takes ``draws(i)``.
      config: sampler settings.

    Returns:
      HmcResult with (num_samples, B, P) draws on theta0's device.
    """
    theta0 = theta0.to(torch.float32).contiguous()
    b, p = theta0.shape
    dev = theta0.device
    if draws is None:
        draws = generator_draws(generator, b, p, dev)
    logp0, grad0 = logdensity_fn(theta0)

    init_log_step = torch.full((b,), float(np.log(
        np.float32(config.init_step_size))), dtype=torch.float32, device=dev)
    state = ChainState(
        theta=theta0,
        logp=logp0,
        grad=grad0,
        inv_mass=torch.ones((b, p), dtype=torch.float32, device=dev),
        log_step=init_log_step,
        log_step_avg=init_log_step,
        da_stat=torch.zeros((b,), dtype=torch.float32, device=dev),
        da_mu=init_log_step + float(np.log(np.float32(10.0))),
        w_count=np.float32(0.0),
        w_mean=torch.zeros((b, p), dtype=torch.float32, device=dev),
        w_m2=torch.zeros((b, p), dtype=torch.float32, device=dev),
    )

    warmup = config.num_warmup
    phase_a = warmup // 2
    da_i = np.float32(1.0)
    t0 = time.perf_counter()
    for i in range(warmup):
        state, accept_prob, _ = _hmc_transition(state, logdensity_fn, config,
                                                *draws(i))
        state = _da_update(state, accept_prob, da_i, config)
        state = _welford_update(state, state.theta)
        if i == phase_a - 1:
            state = _switch(state)
            da_i = np.float32(0.0)
        else:
            da_i = np.float32(da_i + np.float32(1.0))

    # Freeze: final metric from phase-B stats, step size = averaged iterate.
    state = state._replace(inv_mass=_welford_var(state),
                           log_step=state.log_step_avg)

    n_s = config.num_samples
    samples = torch.empty((n_s, b, p), dtype=torch.float32, device=dev)
    accept_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    div_count = torch.zeros((b,), dtype=torch.int32, device=dev)
    for j in range(n_s):
        state, accept_prob, divergent = _hmc_transition(
            state, logdensity_fn, config, *draws(warmup + j))
        samples[j] = state.theta
        accept_sum += accept_prob
        div_count += divergent.to(torch.int32)
    timing.host_s += time.perf_counter() - t0

    return HmcResult(
        samples=samples,
        accept_rate=accept_sum / float(n_s),
        step_size=torch.exp(state.log_step),
        inv_mass=state.inv_mass,
        divergences=div_count,
    )


# -- convergence summary -------------------------------------------------------

#: Series a block of ``split_rhat_ess`` takes: ~50 MB of float64 draws at
#: 300 draws and 53 parameters, ~4x that in the FFT's buffers.
RHAT_BLOCK = 384


def _split_rhat_ess_block(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """split_rhat_ess on one (S, b, P) block of float64 draws.  The time
    axis is moved last (the FFT runs along contiguous rows); every
    (series, parameter) is computed on its own."""
    s = x.shape[0]
    n = s // 2
    ch = np.stack([x[:n], x[s - n:]], axis=0)          # (2, n, b, P)
    ch = np.ascontiguousarray(np.moveaxis(ch, 1, -1))  # (2, b, P, n)
    mean_c = ch.mean(axis=-1)                          # (2, b, P)
    var_c = ch.var(axis=-1, ddof=1)                    # (2, b, P)
    w = var_c.mean(axis=0)                             # within-chain
    b_var = n * mean_c.var(axis=0, ddof=1)             # between-chain
    var_hat = (n - 1) / n * w + b_var / n
    # Degenerate (constant) marginals: perfectly converged by convention.
    degen = (w < 1e-300) | (var_hat < 1e-300)
    rhat = np.where(degen, 1.0, np.sqrt(var_hat / np.where(degen, 1.0, w)))

    # FFT autocovariance per half-chain (biased, as Stan uses).
    xc = ch - mean_c[..., None]
    m = 1
    while m < 2 * n:
        m *= 2
    f = np.fft.rfft(xc, n=m, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=-1)[..., :n].real / n
    rho = 1.0 - (w[..., None] - acov.mean(axis=0)) / np.where(
        degen, 1.0, var_hat
    )[..., None]                                       # (b, P, n)
    rho[..., 0] = 1.0

    n_pairs = n // 2
    pair = rho[..., 0:2 * n_pairs:2] + rho[..., 1:2 * n_pairs:2]
    pos = pair > 0                                     # (b, P, n_pairs)
    first_neg = np.argmin(pos, axis=-1)                # 0 when all positive
    k_stop = np.where(pos.all(axis=-1), n_pairs, first_neg)
    pair_mono = np.minimum.accumulate(pair, axis=-1)
    keep = np.arange(n_pairs) < k_stop[..., None]
    # tau = 1 + 2*sum_{t>=1} rho_t = 2*sum_k pair_k - 1  (pair_0 holds rho_0).
    tau = np.maximum(2.0 * (pair_mono * keep).sum(axis=-1) - 1.0, 1.0)
    total = 2 * n
    ess = np.where(degen, float(total), np.clip(total / tau, 1.0, total))
    return rhat, ess


#: Series a block of ``split_rhat_ess`` takes on the card: ~0.26 GB of
#: float64 draws at 300 draws and 53 parameters, ~12x that at the FFT's
#: peak.
RHAT_CARD_BLOCK = 2048


def _split_rhat_ess_block_torch(x: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_split_rhat_ess_block`` in torch on ``x``'s device: one (S, b, P)
    block of float64 draws, the same arithmetic step for step (the sums'
    order, and so the last bits, are the device's)."""
    s = x.shape[0]
    n = s // 2
    ch = torch.stack([x[:n], x[s - n:]], dim=0)        # (2, n, b, P)
    ch = ch.movedim(1, -1).contiguous()                # (2, b, P, n)
    mean_c = ch.mean(dim=-1)
    var_c = ch.var(dim=-1, correction=1)
    w = var_c.mean(dim=0)
    b_var = n * mean_c.var(dim=0, correction=1)
    var_hat = (n - 1) / n * w + b_var / n
    degen = (w < 1e-300) | (var_hat < 1e-300)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    rhat = torch.where(degen, one, torch.sqrt(
        var_hat / torch.where(degen, one, w)))

    xc = ch - mean_c[..., None]
    m = 1
    while m < 2 * n:
        m *= 2
    f = torch.fft.rfft(xc, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n] / n
    rho = 1.0 - (w[..., None] - acov.mean(dim=0)) / torch.where(
        degen, one, var_hat)[..., None]
    rho[..., 0] = 1.0

    n_pairs = n // 2
    pair = rho[..., 0:2 * n_pairs:2] + rho[..., 1:2 * n_pairs:2]
    pos = pair > 0
    first_neg = torch.argmin(pos.to(torch.uint8), dim=-1)
    k_stop = torch.where(pos.all(dim=-1),
                         torch.full_like(first_neg, n_pairs), first_neg)
    pair_mono = torch.cummin(pair, dim=-1).values
    keep = torch.arange(n_pairs, device=x.device) < k_stop[..., None]
    tau = torch.clamp(2.0 * (pair_mono * keep).sum(dim=-1) - 1.0, min=1.0)
    total = 2 * n
    ess = torch.where(degen, torch.full_like(tau, float(total)),
                      torch.clamp(total / tau, 1.0, float(total)))
    return rhat, ess


def split_rhat_ess(samples, block: int = RHAT_BLOCK,
                   threads: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Split-R-hat and bulk ESS per (series, parameter) from (S, B, P)
    draws (a tensor on any device, or an array), in float64: on the card
    for draws there (``_split_rhat_ess_block_torch`` over blocks of
    ``RHAT_CARD_BLOCK`` series), else on the host.

    One chain per series is what the lockstep sampler produces, so the
    single chain is split in half (Stan's split-R-hat).  ESS follows
    Stan's FFT autocovariance + Geyer initial-monotone-positive-sequence
    truncation, averaged over the two half-chains.  Every (series,
    parameter) is independent, so the series are taken in blocks of
    ``block`` on ``threads`` host threads (default: the host's cores, at
    most 8) and the result is the same bits as one block of them all:
    (S, 30,490, 53) draws would take 3.9 GB in float64 at once, before
    the FFT's padded copies.

    Returns (rhat (B, P), ess (B, P)).
    """
    s, b, p = samples.shape
    if s < 4:
        raise ValueError(f"need >= 4 draws for split diagnostics, got {s}")
    if isinstance(samples, torch.Tensor) and samples.is_cuda:
        parts = [_split_rhat_ess_block_torch(
            samples[:, lo:lo + RHAT_CARD_BLOCK].to(torch.float64))
            for lo in range(0, b, RHAT_CARD_BLOCK)]
        return (torch.cat([r for r, _ in parts]).cpu().numpy(),
                torch.cat([e for _, e in parts]).cpu().numpy())
    rhat = np.empty((b, p), np.float64)
    ess = np.empty((b, p), np.float64)

    def run(lo: int) -> None:
        hi = min(lo + block, b)
        part = samples[:, lo:hi]
        if isinstance(part, torch.Tensor):
            part = part.detach().cpu().numpy()
        rhat[lo:hi], ess[lo:hi] = _split_rhat_ess_block(
            np.asarray(part, np.float64))

    starts = range(0, b, block)
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    if threads <= 1 or len(starts) <= 1:
        for lo in starts:
            run(lo)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(run, starts))
    return rhat, ess
