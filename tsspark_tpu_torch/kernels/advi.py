"""K7 ``advi``: the ELBO gradient's reduction over the draws and the Adam
step of batched mean-field ADVI, as one CUDA kernel.

``advi_step`` is the wrapper ``uncertainty.advi`` calls once a step, after
K3 has scored the (K B, P) draw stack in gradient mode.  On CPU tensors it
runs the plain PyTorch version, ``advi_plain``; on CUDA tensors it launches
``csrc/advi.cu`` or raises.  ``launches`` counts kernel launches.

Both versions take the same float32 operation order (the JAX package's
``_fit_advi`` step, ``tsspark_tpu/uncertainty/advi.py:87-104``), each
operation rounded on its own, the gradient's sums over the draws in
ascending order and the loss's two sums (over the K draws' losses and
over the P rhos) as the kernel's lanes take them (``lane_sum``), so on
one device they give the same bits:

    g_mu   = sum_k g_k / K
    g_rho  = (sum_k (g_k / K) eps_k) sd - 1
    loss_b = (sum_k f_k,b) / K - sum_p rho_bp          (before the update)
    m <- b1 m + (1 - b1) g;   v <- b2 v + ((1 - b2) g) g
    p <- p - (lr (m / c1)) / (sqrt(v / c2) + eps),     c = 1 - b^t

``mu``, ``rho`` and the four Adam moments are updated in place; the
per-series loss is returned.  A non-finite draw's loss or gradient
propagates into its series' parameters, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tsspark_tpu_torch.config import AdviConfig
from tsspark_tpu_torch.kernels import COUNT_LOCK, build
from tsspark_tpu_torch.kernels.forward import _require

#: Kernel launches since the count was last set to 0.
launches = 0


def _count() -> None:
    """One launch, counted under ``COUNT_LOCK`` (two threads may launch)."""
    global launches
    with COUNT_LOCK:
        launches += 1


class AdamScalars(NamedTuple):
    """The step's float32 constants, computed on the host as the JAX
    package computes them (``b^t`` a float32 power of a float32 t)."""

    inv_k: float
    b1: float
    omb1: float
    b2: float
    omb2: float
    c1: float
    c2: float
    lr: float
    eps: float


def adam_scalars(advi: AdviConfig, step: int) -> AdamScalars:
    """Constants of Adam step ``step`` (0-based: t = step + 1)."""
    one = np.float32(1.0)
    t = np.float32(step + 1)
    b1, b2 = np.float32(advi.adam_b1), np.float32(advi.adam_b2)
    return AdamScalars(
        inv_k=float(one / np.float32(advi.num_elbo_samples)),
        b1=float(b1), omb1=float(one - b1),
        b2=float(b2), omb2=float(one - b2),
        c1=float(one - b1 ** t), c2=float(one - b2 ** t),
        lr=float(np.float32(advi.learning_rate)),
        eps=float(np.float32(advi.adam_eps)),
    )


def _seq_sum(cols):
    """Ascending-order sum of a sequence of same-shaped tensors."""
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def lane_sum(cols) -> torch.Tensor:
    """The sum of a sequence of same-shaped tensors as a warp of the
    kernel takes it: lane l adds the terms l, l + 32, ... in ascending
    order from 0, then a fixed tree adds the 32 lanes' sums (at each
    level lane j gets lane j + half's sum: 16, 8, 4, 2, 1)."""
    lanes = []
    for lane in range(32):
        acc = torch.zeros_like(cols[0])
        for c in cols[lane::32]:
            acc = acc + c
        lanes.append(acc)
    half = 16
    while half:
        lanes = [lanes[j] + lanes[j + half] for j in range(half)]
        half //= 2
    return lanes[0]


def _divisor(x, like: torch.Tensor) -> torch.Tensor:
    """A divisor as a tensor on ``like``'s device: a CUDA division by a
    host scalar multiplies by its reciprocal, not the kernel's quotient."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def elbo_losses(f, rho, k_draws: int) -> torch.Tensor:
    """(B,) negative ELBO from the stack's losses f (K B,): the mean over
    the draws minus sum_p rho, each sum a ``lane_sum``."""
    b, p = rho.shape
    f = f.reshape(k_draws, b)
    return lane_sum([f[k] for k in range(k_draws)]) \
        / _divisor(k_draws, rho) - lane_sum([rho[:, j] for j in range(p)])


def elbo_grads(g, eps, sd, inv_k: float):
    """(g_mu, g_rho), each (B, P), from the stack's gradient g (K B, P)."""
    k_draws, b, p = eps.shape
    g = g.reshape(k_draws, b, p)
    gs = [g[k] * inv_k for k in range(k_draws)]
    g_rho = _seq_sum([gs[k] * eps[k] for k in range(k_draws)]) * sd - 1.0
    return _seq_sum(gs), g_rho


def advi_plain(g, f, eps, sd, mu, rho, m_mu, v_mu, m_rho, v_rho,
               sc: AdamScalars) -> torch.Tensor:
    """The plain version of ``advi_step`` (same arguments, same in-place
    updates, same bits on one device)."""
    loss = elbo_losses(f, rho, eps.shape[0])
    g_mu, g_rho = elbo_grads(g, eps, sd, sc.inv_k)
    c1, c2 = _divisor(sc.c1, mu), _divisor(sc.c2, mu)
    for param, m, v, grad in ((mu, m_mu, v_mu, g_mu),
                              (rho, m_rho, v_rho, g_rho)):
        m.copy_(sc.b1 * m + sc.omb1 * grad)
        v.copy_(sc.b2 * v + (sc.omb2 * grad) * grad)
        param.copy_(param - (sc.lr * (m / c1))
                    / (torch.sqrt(v / c2) + sc.eps))
    return loss


def advi_step(g, f, eps, sd, mu, rho, m_mu, v_mu, m_rho, v_rho,
              sc: AdamScalars) -> torch.Tensor:
    """One step's reduction and Adam update.

    Args:
      g, f: K3's gradient (K B, P) and loss (K B,) on the draw stack.
      eps: (K, B, P) the step's draws; sd: (B, P) exp(rho), the stack's.
      mu, rho, m_mu, v_mu, m_rho, v_rho: (B, P), updated in place.
      sc: ``adam_scalars`` of the step.
    Returns the (B,) per-series negative ELBO before the update.
    """
    dev = mu.device
    if dev.type == "cpu":
        return advi_plain(g, f, eps, sd, mu, rho, m_mu, v_mu, m_rho,
                          v_rho, sc)
    if dev.type != "cuda":
        raise ValueError(f"advi: unsupported device {dev}")
    k_draws, b, p = eps.shape
    _require("g", g, (k_draws * b, p), dev)
    _require("f", f, (k_draws * b,), dev)
    _require("eps", eps, (k_draws, b, p), dev)
    for name, x in (("sd", sd), ("mu", mu), ("rho", rho), ("m_mu", m_mu),
                    ("v_mu", v_mu), ("m_rho", m_rho), ("v_rho", v_rho)):
        _require(name, x, (b, p), dev)
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tsspark_advi(
            g.data_ptr(), f.data_ptr(), eps.data_ptr(), sd.data_ptr(),
            mu.data_ptr(), rho.data_ptr(), m_mu.data_ptr(), v_mu.data_ptr(),
            m_rho.data_ptr(), v_rho.data_ptr(), loss.data_ptr(),
            k_draws, b, p, *sc, stream,
        )
    build.check(err, "advi")
    _count()
    return loss
