"""Carry fitted weights between the JAX package and the port.

A fitted state crosses as plain numpy leaves: the JAX package's
``FitState`` fields (``theta``, ``loss``, ``grad_norm``, ``converged``,
``n_iters``, ``status``) and its ``ScalingMeta`` fields, in one flat
mapping.  ``theta`` becomes a float32 tensor on the chosen device; the
scaling metadata stays host float64 (``ds_start`` is absolute epoch days,
which float32 would quantize to ~5 minutes).  The other way across is
the parameter registry: the port opens an npz version the JAX package
published (``serve.registry.ParamRegistry.open``).

A full-posterior fit (``McmcState``) crosses the same way: its own
leaves (``samples`` (S, B, P), ``accept_rate``, ``step_size``,
``divergences`` and, when present, ``rhat`` and ``ess``), its
``ScalingMeta`` fields, and its ``map_state``'s FitState leaves under a
``map_`` prefix (``map_theta``, ``map_loss``, ...).  ``samples`` becomes
a float32 tensor on the chosen device.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.models.prophet.model import FitState, McmcState

STATE_FIELDS = ("theta", "loss", "grad_norm", "converged", "n_iters")
MCMC_FIELDS = ("accept_rate", "step_size", "divergences")
MAP_PREFIX = "map_"


def fitstate_from_numpy(arrays: Mapping[str, np.ndarray],
                        device="cpu") -> FitState:
    """The port's FitState from numpy leaves (see the module docstring).
    ``status`` is optional."""
    meta = ScalingMeta(**{
        f: np.asarray(arrays[f], np.float64) for f in ScalingMeta._fields
    })
    status = arrays.get("status")
    return FitState(
        theta=torch.from_numpy(
            np.array(arrays["theta"], np.float32)  # a writable copy
        ).to(device),
        meta=meta,
        loss=np.asarray(arrays["loss"]),
        grad_norm=np.asarray(arrays["grad_norm"]),
        converged=np.asarray(arrays["converged"]),
        n_iters=np.asarray(arrays["n_iters"]),
        status=None if status is None else np.asarray(status),
    )


def fitstate_to_numpy(state: FitState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`fitstate_from_numpy`: one flat mapping of host
    numpy leaves (``status`` only when present)."""
    theta = state.theta
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    out = {"theta": np.asarray(theta)}
    for f in STATE_FIELDS[1:]:
        out[f] = np.asarray(getattr(state, f))
    if state.status is not None:
        out["status"] = np.asarray(state.status)
    out.update({k: np.asarray(v) for k, v in state.meta._asdict().items()})
    return out


def mcmcstate_from_numpy(arrays: Mapping[str, np.ndarray],
                         device="cpu") -> McmcState:
    """The port's McmcState from numpy leaves (see the module docstring);
    ``map_state`` goes through :func:`fitstate_from_numpy`."""
    map_leaves = {k[len(MAP_PREFIX):]: v for k, v in arrays.items()
                  if k.startswith(MAP_PREFIX)}
    map_leaves.update({f: arrays[f] for f in ScalingMeta._fields})
    map_state = fitstate_from_numpy(map_leaves, device)
    opt = {f: (None if arrays.get(f) is None else np.asarray(arrays[f]))
           for f in ("rhat", "ess")}
    return McmcState(
        samples=torch.from_numpy(
            np.array(arrays["samples"], np.float32)).to(device),
        meta=map_state.meta,
        map_state=map_state,
        **{f: np.asarray(arrays[f]) for f in MCMC_FIELDS},
        **opt,
    )


def mcmcstate_to_numpy(state: McmcState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`mcmcstate_from_numpy`: one flat mapping of host
    numpy leaves (``rhat`` and ``ess`` only when present)."""
    samples = state.samples
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    out = {"samples": np.asarray(samples)}
    for f in MCMC_FIELDS + ("rhat", "ess"):
        v = getattr(state, f)
        if v is not None:
            out[f] = np.asarray(v.detach().cpu() if isinstance(
                v, torch.Tensor) else v)
    for k, v in fitstate_to_numpy(state.map_state).items():
        out[k if k in ScalingMeta._fields else MAP_PREFIX + k] = v
    return out
