"""Batched mean-field ADVI over the padded (n_series, T) design tensors.

The port of the JAX package's ``uncertainty/advi.py``.  Every series'
diagonal-Gaussian posterior over the flat theta packing (``params.py``:
``[k, m, log_sigma, delta, beta]``), parameterized as ``(mu, rho)`` with
stddev ``exp(rho)``, advances in lockstep over the same padded data the
MAP solve ran on.  The objective per series ``b`` is the negative
reparameterized ELBO

    L_b = E_eps[ neg_log_posterior(mu + exp(rho) * eps) ]_b
          - sum_p rho_{b,p}

(the entropy of a diagonal Gaussian up to a constant), its expectation
over ``num_elbo_samples`` = K draws a step, and Adam on ``(mu, rho)``
from ``mu = theta0`` (the MAP fit) and ``rho = init_rho``.

A step (``elbo_step``) is the counterpart of the reference's scan body
(``tsspark_tpu/uncertainty/advi.py:87-104``):

1. the step's draws ``eps`` (K, B, P) (``draws(i)``; by default standard
   normals from the caller's ``torch.Generator`` on the data's device);
2. the draw stack theta = mu + exp(rho) eps as one (K B, P) tensor;
3. K3 in gradient mode on that stack (``kernels.loss.loss``, which scores
   row i on data row i % B);
4. K7 (``kernels.advi.advi_step``): the ELBO gradient over the draws and
   the Adam update, in place.

On the card both steps are kernels; with ``device="cpu"`` their plain
versions run.  ``elbo`` is minus the last step's per-series losses, taken
before its update, as the reference returns it.  A posterior is saved
and loaded in the reference's ``.npz`` format (``save_posterior``,
``load_posterior``), so either package reads the other's.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tsspark_tpu_torch.config import NUMERICS_REV, AdviConfig, ProphetConfig
from tsspark_tpu_torch.device import resolve_device
from tsspark_tpu_torch.kernels import advi as advi_k
from tsspark_tpu_torch.kernels import loss as loss_k
from tsspark_tpu_torch.models.prophet.design import FitData, fitdata_to_device
from tsspark_tpu_torch.utils.atomic import atomic_write

__all__ = [
    "AdviPosterior",
    "fit_advi",
    "save_posterior",
    "load_posterior",
    "POSTERIOR_FILE",
    "POSTERIOR_FORMAT",
]

POSTERIOR_FORMAT = 1
POSTERIOR_FILE = "advi_posterior.npz"

#: ``draws(i)`` -> the (K, B, P) standard normals of step i.
Draws = Callable[[int], torch.Tensor]


class AdviPosterior(NamedTuple):
    """Per-series diagonal-Gaussian posterior over the flat theta."""

    mu: object    # (B, P) posterior mean
    rho: object   # (B, P) log posterior stddev
    elbo: object  # (B,)   final per-series ELBO estimate


class AdviState(NamedTuple):
    """The loop's state: parameters and Adam moments, all (B, P)."""

    mu: torch.Tensor
    rho: torch.Tensor
    m_mu: torch.Tensor
    v_mu: torch.Tensor
    m_rho: torch.Tensor
    v_rho: torch.Tensor


def init_state(theta0: torch.Tensor, advi: AdviConfig) -> AdviState:
    """``mu = theta0``, ``rho = init_rho``, moments 0 (fresh tensors)."""
    mu = theta0.to(torch.float32).clone().contiguous()
    z = lambda: torch.zeros_like(mu)  # noqa: E731
    return AdviState(mu, torch.full_like(mu, advi.init_rho), z(), z(), z(),
                     z())


def _stack(mu, rho, eps):
    """(sd, the (K B, P) draw stack mu + sd * eps_k)."""
    k_draws, b, p = eps.shape
    sd = torch.exp(rho)
    return sd, (mu + sd * eps).reshape(k_draws * b, p)


def _elbo_losses(mu, rho, data, config, eps):
    """Per-series negative ELBO, (B,), over the draws ``eps`` (K, B, P):
    K3's value mode on the draw stack (its plain version on the CPU)."""
    _, stack = _stack(mu, rho, eps)
    f, _ = loss_k.loss(stack, data, config, grad=False)
    return advi_k.elbo_losses(f, rho, eps.shape[0])


def elbo_step(state: AdviState, data: FitData, config: ProphetConfig,
              eps: torch.Tensor, step: int, advi: AdviConfig
              ) -> torch.Tensor:
    """One ADVI step on ``state`` (updated in place) with the draws
    ``eps`` (K, B, P); returns the (B,) losses before the update."""
    sd, stack = _stack(state.mu, state.rho, eps)
    f, g = loss_k.loss(stack, data, config, grad=True)
    return advi_k.advi_step(g, f, eps, sd, *state,
                            advi_k.adam_scalars(advi, step))


def generator_draws(generator: torch.Generator, k_draws: int, b: int,
                    p: int, device: torch.device) -> Draws:
    """Standard normals (K, B, P) a step from ``generator``."""
    return lambda _i: torch.randn((k_draws, b, p), generator=generator,
                                  device=device)


def fit_advi(
    theta0,
    data: FitData,
    generator: Optional[torch.Generator],
    config: ProphetConfig,
    advi: Optional[AdviConfig] = None,
    *,
    device=None,
    draws: Optional[Draws] = None,
) -> AdviPosterior:
    """Fit every series' mean-field posterior.

    Args:
      theta0: (B, P) warm start, the MAP fit's theta (numpy or tensor).
      data: the SAME padded FitData the MAP solve ran on (host numpy or
        tensors); moved to ``device`` (``None``: the card).
      generator: the draws' source, on ``device``, unless ``draws`` gives
        them (step i takes ``draws(i)``, (K, B, P) on ``device``).
    Returns an ``AdviPosterior`` of (B, P) tensors on ``device`` and the
    (B,) ELBO.
    """
    advi = AdviConfig() if advi is None else advi
    dev = resolve_device(device)
    data = fitdata_to_device(data, dev)
    if not isinstance(theta0, torch.Tensor):
        theta0 = torch.from_numpy(np.array(theta0, np.float32))
    state = init_state(theta0.to(dev), advi)
    b, p = state.mu.shape
    if draws is None:
        draws = generator_draws(generator, advi.num_elbo_samples, b, p, dev)
    for i in range(advi.num_steps):  # num_steps >= 1 (AdviConfig)
        losses = elbo_step(state, data, config, draws(i), i, advi)
    return AdviPosterior(mu=state.mu, rho=state.rho, elbo=-losses)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def save_posterior(version_dir: str, post: AdviPosterior, *, seed: int,
                   num_steps: int) -> str:
    """Persist the posterior into a registry version dir, atomically: one
    ``.npz`` with an identity header (format, NUMERICS_REV, shape, seed,
    steps), field for field the JAX package's."""
    path = os.path.join(version_dir, POSTERIOR_FILE)
    mu, rho, elbo = _host(post.mu), _host(post.rho), _host(post.elbo)
    header = json.dumps({
        "format": POSTERIOR_FORMAT,
        "numerics_rev": NUMERICS_REV,
        "n_series": int(mu.shape[0]),
        "num_params": int(mu.shape[1]),
        "seed": int(seed),
        "num_steps": int(num_steps),
    }).encode()

    def _write(f):
        buf = io.BytesIO()
        np.savez(buf, header=np.frombuffer(header, np.uint8),
                 mu=mu, rho=rho, elbo=elbo)
        f.write(buf.getvalue())

    atomic_write(path, _write)
    return path


def load_posterior(version_dir: str):
    """(AdviPosterior of numpy arrays, header dict), or None when the
    artifact is absent, unreadable, of another format or NUMERICS_REV, or
    misshapen: callers then serve the MAP tier, never suspect draws."""
    path = os.path.join(version_dir, POSTERIOR_FILE)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            mu, rho, elbo = z["mu"], z["rho"], z["elbo"]
    except Exception:
        return None
    if header.get("format") != POSTERIOR_FORMAT:
        return None
    if header.get("numerics_rev") != NUMERICS_REV:
        return None
    if mu.shape != rho.shape or mu.shape[0] != elbo.shape[0]:
        return None
    return AdviPosterior(mu=mu, rho=rho, elbo=elbo), header
