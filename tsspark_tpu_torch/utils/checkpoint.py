"""Checkpoints of fitted states: one ``.npz`` + one ``.json`` sidecar.

The same format as the JAX package's: the npz carries the FitState
leaves (``meta_``-prefixed ScalingMeta fields, ``extra_``-prefixed side
arrays) and a CRC stamp; the sidecar carries the config fingerprint and
the series ids.  Either package reads what the other wrote, as long as
the two configs hash to the same fingerprint.

``save_forecaster`` / ``load_forecaster`` add the long-frame front end's
context to the sidecar (and, for ``mcmc_samples`` fits, the posterior
draws to the npz), in the JAX package's layout: a fitted ``Forecaster``
saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from tsspark_tpu_torch.carry import fitstate_from_numpy, fitstate_to_numpy
from tsspark_tpu_torch.config import (
    ProphetConfig,
    RegressorConfig,
    SeasonalityConfig,
)
from tsspark_tpu_torch.models.prophet import trend as trend_mod
from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.models.prophet.model import FitState
from tsspark_tpu_torch.resilience import integrity
from tsspark_tpu_torch.utils.atomic import atomic_write


def config_fingerprint(config: ProphetConfig) -> str:
    """Stable hash of everything that determines the parameter layout."""
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True,
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_state(path: str, state: FitState, config: ProphetConfig,
               series_ids: Optional[np.ndarray] = None,
               extras: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a FitState to ``<base>.npz`` + ``<base>.json``, atomically,
    with the payload CRC stamp."""
    path = _base(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    leaves = fitstate_to_numpy(state)
    meta_keys = set(ScalingMeta._fields)
    host = {(f"meta_{k}" if k in meta_keys else k): v
            for k, v in leaves.items()}
    host.update({f"extra_{k}": np.asarray(v)
                 for k, v in (extras or {}).items()})
    host = integrity.stamp(host)
    atomic_write(path + ".npz", lambda fh: np.savez(fh, **host))
    if series_ids is None:
        sidecar_ids = None
    else:
        ids_arr = np.asarray(series_ids)
        if ids_arr.ndim == 0:  # sized-less iterable: materialize
            ids_arr = np.asarray(list(series_ids))
        if ids_arr.dtype.kind != "U":
            ids_arr = ids_arr.astype(np.str_)
        sidecar_ids = ids_arr.tolist()
    sidecar = {
        "fingerprint": config_fingerprint(config),
        "n_series": int(leaves["theta"].shape[0]),
        "series_ids": sidecar_ids,
        "format": 1,
    }
    atomic_write(path + ".json", lambda fh: json.dump(sidecar, fh),
                 mode="w")


# The sidecar names the backend as the JAX package registers it, so a
# saved Forecaster loads in either package: the batched path is "tpu"
# there and "cuda" here; the scipy oracle is "cpu" in both.
_SAVED_BACKEND = {"cuda": "tpu"}
_LOADED_BACKEND = {"tpu": "cuda"}


def save_forecaster(path: str, fc) -> None:
    """Persist a fitted Forecaster (state + config + frame context).

    Everything needed for ``load_forecaster(path).predict(...)`` in a fresh
    process: the FitState arrays, the model config, holiday calendars, and
    the pandas-front-end context (column names, training grid, datetime
    flag).  The CLI's ``fit`` -> ``predict`` round trip rides on this.
    """
    from tsspark_tpu_torch.frame import Forecaster  # local: import cycle

    if not isinstance(fc, Forecaster) or fc.state is None:
        raise ValueError("save_forecaster needs a fitted Forecaster")
    path = _base(path)
    save_state(path, fc.state, fc.config, series_ids=fc.series_ids)
    if fc.mcmc_state is not None:
        # Full-posterior fits must survive the round trip, or a reloaded
        # model silently downgrades to narrower MAP intervals.  The draws
        # dominate the file size — that is the cost of the mcmc_samples
        # choice, same as upstream Prophet's serialized Stan draws.
        with np.load(path + ".npz") as f:
            z = {k: np.asarray(f[k]) for k in f.files}
        z.pop(integrity.INTEGRITY_KEY, None)  # re-stamp over the new set
        ms = fc.mcmc_state
        z.update(
            mcmc_samples=torch.as_tensor(ms.samples).detach().cpu().numpy(),
            mcmc_accept_rate=np.asarray(ms.accept_rate),
            mcmc_step_size=np.asarray(ms.step_size),
            mcmc_divergences=np.asarray(ms.divergences),
        )
        z = integrity.stamp(z)
        atomic_write(path + ".npz", lambda fh: np.savez(fh, **z))
    with open(path + ".json") as f:
        sidecar = json.load(f)
    # The model config is stored with the holidays' regressor columns in
    # it; the holiday calendars themselves are stored to rebuild the
    # indicator features.
    sidecar["forecaster"] = {
        "mcmc_config": None if fc.mcmc_config is None
        else dataclasses.asdict(fc.mcmc_config),
        "config": dataclasses.asdict(fc.config),
        "backend": _SAVED_BACKEND.get(fc.backend.name, fc.backend.name),
        "id_col": fc.id_col, "ds_col": fc.ds_col, "y_col": fc.y_col,
        "cap_col": fc.cap_col, "floor_col": fc.floor_col,
        "regressor_cols": list(fc.regressor_cols),
        "holidays": [dataclasses.asdict(h) for h in fc.holidays],
        "was_datetime": fc._was_datetime,
        "train_ds": None if fc._train_ds is None else
        [float(v) for v in fc._train_ds],
        "freq_days": fc._freq_days,
        "solver_config": dataclasses.asdict(fc.backend.solver_config),
    }
    atomic_write(path + ".json", lambda fh: json.dump(sidecar, fh),
                 mode="w")


def load_forecaster(path: str, **backend_kwargs):
    """Rebuild a fitted Forecaster saved by :func:`save_forecaster` (by
    either package).  ``backend_kwargs`` go to the backend, as in
    ``Forecaster(...)``: ``device="cpu"`` for the plain path; by default
    it runs on the card."""
    from tsspark_tpu_torch.config import McmcConfig, SolverConfig
    from tsspark_tpu_torch.frame import Forecaster
    from tsspark_tpu_torch.models.holidays import Holiday

    path = _base(path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    ctx = sidecar.get("forecaster")
    if ctx is None:
        raise ValueError(
            f"{path}.json has no forecaster context (state-only checkpoint; "
            "use load_state)"
        )
    config = _config_from_dict(ctx["config"])
    holidays = tuple(
        Holiday(**{**h, "dates": tuple(h["dates"])}) for h in ctx["holidays"]
    )
    # Holiday regressor columns are already part of the stored config;
    # constructing with holidays would re-append them, so attach afterwards.
    fc = Forecaster(
        config,
        solver_config=SolverConfig(**ctx["solver_config"]),
        backend=_LOADED_BACKEND.get(ctx["backend"], ctx["backend"]),
        id_col=ctx["id_col"], ds_col=ctx["ds_col"], y_col=ctx["y_col"],
        cap_col=ctx["cap_col"], floor_col=ctx["floor_col"],
        regressor_cols=tuple(ctx["regressor_cols"]),
        **backend_kwargs,
    )
    fc.holidays = holidays
    # The stored user columns, as saved: with none, the constructor took
    # every configured regressor for a user column, the holidays' too,
    # and a reloaded holiday model would refuse ``predict(horizon=...)``
    # (the JAX package's loader still does).
    fc.regressor_cols = tuple(ctx["regressor_cols"])
    state, ids = load_state(path, config)
    fc.state = state
    fc.series_ids = ids
    fc._was_datetime = ctx["was_datetime"]
    fc._train_ds = None if ctx["train_ds"] is None else np.asarray(
        ctx["train_ds"], np.float64
    )
    fc._freq_days = ctx["freq_days"]
    with np.load(path + ".npz") as z:
        draws = ({k: np.asarray(z[k]) for k in z.files
                  if k.startswith("mcmc_")}
                 if "mcmc_samples" in z.files else None)
    if draws is not None:
        from tsspark_tpu_torch.models.prophet.model import McmcState
        from tsspark_tpu_torch.ops import hmc

        # Convergence diagnostics are a pure function of the draws — cheaper
        # to recompute on load than to version in the checkpoint format.
        rhat, ess = hmc.split_rhat_ess(draws["mcmc_samples"])
        fc.mcmc_state = McmcState(
            samples=torch.from_numpy(draws["mcmc_samples"]),
            meta=state.meta,
            accept_rate=draws["mcmc_accept_rate"],
            step_size=draws["mcmc_step_size"],
            divergences=draws["mcmc_divergences"],
            map_state=state,
            rhat=rhat,
            ess=ess,
        )
        if ctx.get("mcmc_config"):
            fc.mcmc_config = McmcConfig(**ctx["mcmc_config"])
    return fc


def load_extras(path: str) -> Dict[str, np.ndarray]:
    """The ``extras`` arrays a checkpoint was saved with (may be empty)."""
    path = _base(path)
    with np.load(path + ".npz") as z:
        return {
            k[len("extra_"):]: np.asarray(z[k])
            for k in z.files if k.startswith("extra_")
        }


def _config_from_dict(d: Dict) -> ProphetConfig:
    d = dict(d)
    d["seasonalities"] = tuple(
        SeasonalityConfig(**s) for s in d.get("seasonalities", ())
    )
    d["regressors"] = tuple(
        RegressorConfig(**r) for r in d.get("regressors", ())
    )
    return ProphetConfig(**d)


def load_state(path: str, config: ProphetConfig, strict: bool = True,
               return_extras: bool = False):
    """Load a FitState (theta a CPU tensor; the backend moves the rows
    it serves to its device); verifies the config fingerprint when
    ``strict``.

    Returns ``(state, series_ids)``, or ``(state, series_ids, extras)``
    with ``return_extras``.
    """
    path = _base(path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    if strict and sidecar["fingerprint"] != config_fingerprint(config):
        raise ValueError(
            "checkpoint was written with a different model config "
            f"(fingerprint {sidecar['fingerprint']}); pass strict=False to "
            "force-load"
        )
    with np.load(path + ".npz") as z:
        files = {k: np.asarray(z[k]) for k in z.files}
    leaves = {k[len("meta_"):]: v for k, v in files.items()
              if k.startswith("meta_")}
    if "changepoints" not in leaves:
        # Checkpoint predates per-series changepoint grids: uniform
        # placement is exactly reconstructible from the config.
        b = leaves["y_scale"].shape[0]
        leaves["changepoints"] = trend_mod.uniform_changepoints(
            np.zeros((b,)), np.ones((b,)),
            config.n_changepoints, config.changepoint_range,
        )
    leaves.update({k: files[k] for k in
                   ("theta", "loss", "grad_norm", "converged", "n_iters",
                    "status") if k in files})
    state = fitstate_from_numpy(leaves)
    ids = sidecar.get("series_ids")
    ids = None if ids is None else np.asarray(ids)
    if return_extras:
        extras = {k[len("extra_"):]: v for k, v in files.items()
                  if k.startswith("extra_")}
        return state, ids, extras
    return state, ids
