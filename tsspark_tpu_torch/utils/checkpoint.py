"""Checkpoints of fitted states: one ``.npz`` + one ``.json`` sidecar.

The same format as the JAX package's: the npz carries the FitState
leaves (``meta_``-prefixed ScalingMeta fields, ``extra_``-prefixed side
arrays) and a CRC stamp; the sidecar carries the config fingerprint and
the series ids.  Either package reads what the other wrote, as long as
the two configs hash to the same fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

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
