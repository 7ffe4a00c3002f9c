"""Quantile forecast columns: intervals as shared mmap pages.

The port of the JAX package's ``uncertainty/qplane.py``.  At version-flip
time the publisher computes the full (series x horizon bucket x quantile)
table and lands it in the version dir under the spec-first /
atomic-columns / CRC-sentinel-last protocol (``plane/protocol.py``):

* ``qplane_spec.json`` — identity record (bucket ladder, quantile set,
  draw count, seed, sampling mode, config fingerprint, NUMERICS_REV),
  written FIRST;
* ``qcol_h<bucket>_q<permille>.npy`` — one plain npy per (horizon bucket,
  quantile): ``(n_series, bucket)`` float32 in data units;
* ``qplaneok.json`` — the CRC sentinel, written LAST.  A torn publish
  fails it and is refused at attach; interval reads then fall back to
  the compute path.

The file layout is the reference's: a plane either package publishes
attaches in the other.

**Row-local sampling is the parity contract.**  Every cell comes from a
per-series host numpy sampler whose RNG is keyed on ``(seed, global_row)``
alone (``np.random.SeedSequence``), so the publisher's chunked compute
and the read path's few-row fallback run the same per-row function on the
same inputs: plane-served bytes equal fallback-computed bytes bit for
bit, and a full publish (either mode) may spread its rows over spawned
worker processes (``write_qplane``'s ``processes``) without changing a
byte.  The samplers are the reference's, line for line, so on the same
inputs they give the reference's bytes.

Two sampling modes, recorded in the spec:

* ``"map"`` — the Prophet MAP predictive recipe (simulated future
  changepoints + observation noise) around the deterministic forecast of
  the engine's own ``backend.predict(num_samples=0)`` (K1 on the card);
* ``"advi"`` — theta draws from the version's mean-field posterior
  (``uncertainty/advi.py``), each draw its own trend + seasonal
  trajectory, on the host.  Chosen when the posterior artifact is present
  and the config is eligible (no regressors or conditional
  seasonalities: their future values are not in the registry).

Logistic growth is refused: intervals for logistic configs stay on the
sampled compute path.  ``maybe_publish`` publishes the full plane, or on
a delta version whose base has a plane a delta plane
(``write_qplane_delta``: unchanged rows' cells are the base's bytes,
changed rows re-sampled), and bows to the disk-pressure ladder.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.io import (
    BackpressureError,
    DiskFullError,
    active_ladder,
    link_or_copy,
)
from tsspark_tpu_torch.plane.protocol import (
    attach_column,
    read_json,
    shard_crcs,
    shard_ranges,
    verify_crcs,
    write_column,
    write_sentinel,
    write_spec,
)
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.serve.fplane import (
    DEFAULT_HOT_HORIZONS,
    DEFAULT_SHARD_ROWS,
    _PUBLISH_CHUNK,
    _predict_rows,
    bucket_ladder,
    future_grid,
)
from tsspark_tpu_torch.uncertainty import advi as advi_mod

__all__ = [
    "QPLANE_FORMAT", "QPLANE_SPEC", "QPLANE_OK", "QCOL_PREFIX",
    "DEFAULT_QUANTILES", "DEFAULT_DRAWS", "QuantilePlaneError",
    "QPlaneView", "permille", "compute_rows", "write_qplane",
    "write_qplane_delta", "attach",
    "has_qplane", "verify_qplane", "quantile_batch", "quantile_rows",
    "maybe_publish", "qplane_nbytes",
]

#: Plane format revision (reader refuses unknown revisions).
QPLANE_FORMAT = 1

QPLANE_SPEC = "qplane_spec.json"
QPLANE_OK = "qplaneok.json"
QCOL_PREFIX = "qcol_"

#: Default published quantiles: the 80% band (ProphetConfig's
#: interval_width default) plus the median.
DEFAULT_QUANTILES = (0.1, 0.5, 0.9)

#: Sample paths per series (ProphetConfig.uncertainty_samples default).
DEFAULT_DRAWS = 256

DEFAULT_SEED = 0


class QuantilePlaneError(RuntimeError):
    """Structured quantile-plane failure.  ``reason`` is ``"absent"``
    (serve intervals through compute silently) or ``"corrupt"`` (torn
    publish — the reader must refuse it)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def permille(q: float) -> int:
    """Quantile -> integer permille column tag (0.1 -> 100)."""
    return int(round(float(q) * 1000))


def _col_name(hb: int, q: float) -> str:
    return f"h{int(hb)}_q{permille(q):03d}"


def _col_path(vdir: str, name: str) -> str:
    return os.path.join(vdir, f"{QCOL_PREFIX}{name}.npy")


def _advi_eligible(config) -> bool:
    """ADVI-mode sampling needs every design input recomputable from the
    future ds grid alone: regressor values and seasonality conditions
    live outside the registry, so their configs stay on MAP mode."""
    if config.growth == "logistic":
        return False
    if config.num_regressors:
        return False
    return not any(s.condition_name for s in config.seasonalities)


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as host float32 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# the row-local sampler (shared by publish and compute fallback)
# ---------------------------------------------------------------------------


def _row_rng(seed: int, global_row: int) -> np.random.Generator:
    """The parity key: one generator per (plane seed, global row) —
    nothing about batching, chunking, or padding can reach the draws."""
    return np.random.default_rng(
        np.random.SeedSequence((int(seed), int(global_row)))
    )


def _row_quantiles_map(det_trend, det_add, det_mult, t, theta_row,
                       y_scale, floor, config, qs, draws, seed,
                       global_row) -> np.ndarray:
    """(Q, T) float32 quantile forecasts in data units for ONE row,
    MAP mode: the ``models/prophet/predict.py`` uncertainty recipe
    (simulated future changepoints + observation noise), mirrored as
    host float32 numpy keyed on ``(seed, global_row)``."""
    rng = _row_rng(seed, global_row)
    scale, fl = float(y_scale), float(floor)
    det = ((np.asarray(det_trend, np.float64) - fl) / scale) \
        .astype(np.float32)
    add = (np.asarray(det_add, np.float64) / scale).astype(np.float32)
    mult = np.asarray(det_mult, np.float32)
    t = np.asarray(t, np.float32)
    t_len = t.shape[0]
    n_cp = config.n_changepoints
    theta_row = np.asarray(theta_row, np.float32)
    sigma = np.float32(np.exp(theta_row[2]))
    delta = theta_row[3:3 + n_cp]

    future = (t > 1.0).astype(np.float32)
    dt = np.diff(t, prepend=t[:1])
    mean_dt = float((dt * future).sum()) / max(float(future.sum()), 1.0)
    cp_prob = np.float32(np.clip(n_cp * mean_dt, 0.0, 1.0))
    lam = np.float32(
        max(float(np.abs(delta).mean()) if n_cp else 0.0, 1e-8)
    )

    s_draws = int(draws)
    u = rng.random((s_draws, t_len), dtype=np.float32)
    ind = (u < cp_prob).astype(np.float32) * future[None]
    lap = rng.laplace(0.0, 1.0, (s_draws, t_len)).astype(np.float32)
    new_delta = ind * lap * lam
    if config.growth == "linear":
        c = np.cumsum(new_delta, axis=-1)
        d = np.cumsum(new_delta * t[None], axis=-1)
        tr = det[None] + t[None] * c - d
    else:  # flat: no trend uncertainty beyond the deterministic path
        tr = np.broadcast_to(det[None], (s_draws, t_len))
    noise = rng.standard_normal((s_draws, t_len),
                                dtype=np.float32) * sigma
    samples = tr * (1.0 + mult[None]) + add[None] + noise
    q = np.quantile(samples, np.asarray(qs, np.float64), axis=0)
    return (q * scale + fl).astype(np.float32)


def _row_quantiles_advi(mu_row, rho_row, s_row, x_season, mult_mask, t,
                        y_scale, floor, config, qs, draws, seed,
                        global_row) -> np.ndarray:
    """(Q, T) float32 quantile forecasts in data units for ONE row,
    ADVI mode: each draw is a theta from the row's mean-field posterior
    with its own trend + seasonal trajectory (``forecast_from_draws``'s
    posterior-predictive shape, row-local host numpy)."""
    rng = _row_rng(seed, global_row)
    scale, fl = float(y_scale), float(floor)
    t = np.asarray(t, np.float32)
    t_len = t.shape[0]
    n_cp = config.n_changepoints
    s_draws = int(draws)

    mu_row = np.asarray(mu_row, np.float32)
    rho_row = np.asarray(rho_row, np.float32)
    z = rng.standard_normal((s_draws, mu_row.shape[0]),
                            dtype=np.float32)
    thetas = mu_row[None] + np.exp(rho_row[None]) * z  # (S, P)
    k, m = thetas[:, 0], thetas[:, 1]
    sigma = np.exp(thetas[:, 2])
    delta = thetas[:, 3:3 + n_cp]
    beta = thetas[:, 3 + n_cp:]

    # Deterministic trend per draw (hinge-basis piecewise linear —
    # trend.piecewise_linear's formula — or flat).
    if config.growth == "linear":
        s_row = np.asarray(s_row, np.float32)
        det = k[:, None] * t[None] + m[:, None]
        if n_cp:
            hinge = np.maximum(t[:, None] - s_row[None, :], 0.0)
            det = det + delta @ hinge.T.astype(np.float32)
    else:
        det = np.broadcast_to(m[:, None], (s_draws, t_len))

    # Simulated future changepoints, per-draw Laplace scale.
    future = (t > 1.0).astype(np.float32)
    dt = np.diff(t, prepend=t[:1])
    mean_dt = float((dt * future).sum()) / max(float(future.sum()), 1.0)
    cp_prob = np.float32(np.clip(n_cp * mean_dt, 0.0, 1.0))
    if n_cp:
        lam = np.maximum(np.abs(delta).mean(-1), 1e-8)  # (S,)
        u = rng.random((s_draws, t_len), dtype=np.float32)
        ind = (u < cp_prob).astype(np.float32) * future[None]
        lap = rng.laplace(0.0, 1.0, (s_draws, t_len)) \
            .astype(np.float32)
        new_delta = ind * lap * lam[:, None].astype(np.float32)
        if config.growth == "linear":
            c = np.cumsum(new_delta, axis=-1)
            d = np.cumsum(new_delta * t[None], axis=-1)
            tr = det + t[None] * c - d
        else:
            tr = det
    else:
        tr = det

    # Seasonal split per draw (additive/multiplicative by mode mask;
    # _advi_eligible guarantees no regressor columns).
    fs = config.num_seasonal_features
    beta_s = beta[:, :fs]
    mm = np.asarray(mult_mask[:fs], np.float32)
    x = np.asarray(x_season, np.float32)  # (T, Fs)
    add = (beta_s * (1.0 - mm)[None]) @ x.T
    mult = (beta_s * mm[None]) @ x.T

    noise = rng.standard_normal((s_draws, t_len), dtype=np.float32) \
        * sigma[:, None].astype(np.float32)
    samples = tr * (1.0 + mult) + add + noise
    q = np.quantile(samples, np.asarray(qs, np.float64), axis=0)
    return (q * scale + fl).astype(np.float32)


def _advi_rows(rows, mu, rho, s_cp, x_season, mult_mask, t, y_scale,
               floor, config, qs, draws, seed) -> np.ndarray:
    """(len(rows), Q, T) ADVI-mode quantiles of the global ``rows``, every
    per-row input already sliced to them.  Each row's draws are keyed on
    ``(seed, rows[i])`` alone, so any split of the rows, in any process,
    gives the same bytes."""
    out = np.empty((len(rows), len(qs), t.shape[1]), np.float32)
    for i, row in enumerate(rows):
        out[i] = _row_quantiles_advi(
            mu[i], rho[i], s_cp[i], x_season[i], mult_mask, t[i],
            y_scale[i], floor[i], config, qs, draws, seed, int(row),
        )
    return out


def _map_rows(rows, det_trend, det_add, det_mult, t, theta, y_scale,
              floor, config, qs, draws, seed) -> np.ndarray:
    """(len(rows), Q, T) MAP-mode quantiles of the global ``rows``, every
    per-row input already sliced to them (the deterministic components
    from ``backend.predict``).  Each row's draws are keyed on
    ``(seed, rows[i])`` alone, so any split of the rows, in any process,
    gives the same bytes."""
    out = np.empty((len(rows), len(qs), t.shape[1]), np.float32)
    for i, row in enumerate(rows):
        out[i] = _row_quantiles_map(
            det_trend[i], det_add[i], det_mult[i], t[i], theta[i],
            y_scale[i], floor[i], config, qs, draws, seed, int(row),
        )
    return out


#: A full publish at least this many rows wide samples its rows (either
#: mode) on worker processes (the read path's few-row fallback stays in
#: process), in parts of ``_PART_ROWS`` rows.
PARALLEL_MIN_ROWS = 4096
_PART_ROWS = 1024


def _publish_processes(n_rows: int) -> int:
    """Worker processes for a publish of ``n_rows``: one per core up to 8
    past ``PARALLEL_MIN_ROWS``, else none."""
    if n_rows < PARALLEL_MIN_ROWS:
        return 1
    return max(1, min(8, os.cpu_count() or 1))


def compute_rows(snap, config, backend, idx, hb, *,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 draws: int = DEFAULT_DRAWS,
                 seed: int = DEFAULT_SEED,
                 posterior=None,
                 chunk: int = _PUBLISH_CHUNK,
                 executor=None) -> Dict[int, np.ndarray]:
    """Quantile forecasts for snapshot rows ``idx`` at bucket ``hb`` — THE
    compute path, used by both the publisher (all rows) and the read-path
    fallback (the few uncovered rows).  Returns ``{permille: (len(idx),
    hb) float32}`` in data units.

    ``posterior`` (an ``AdviPosterior`` over ALL snapshot rows) selects
    ADVI-mode sampling; None means MAP mode, whose deterministic
    components come from ``backend.predict`` (K1 on the card, in this
    process).  ``executor`` (a process pool): the rows' sampling goes to
    it in contiguous parts, with the same bytes."""
    if config.growth == "logistic":
        raise QuantilePlaneError(
            "absent", "logistic growth has no row-local quantile "
            "recipe; intervals stay on the sampled compute path"
        )
    idx = np.asarray(idx, np.int64)
    hb = int(hb)
    sub, step = snap.take(idx)
    grid = future_grid(sub, step, hb)  # (n, hb) float64
    meta = sub.meta
    ds_start = np.asarray(meta.ds_start, np.float64)
    ds_span = np.asarray(meta.ds_span, np.float64)
    t = ((grid - ds_start[:, None]) / ds_span[:, None]) \
        .astype(np.float32)
    y_scale = np.asarray(meta.y_scale, np.float64)
    floor = np.asarray(meta.floor, np.float64)
    qs = tuple(float(q) for q in quantiles)
    out = np.empty((len(idx), len(qs), hb), np.float32)

    if posterior is not None:
        from tsspark_tpu_torch.models.prophet import seasonality

        mu = _host(posterior.mu)
        rho = _host(posterior.rho)
        s_cp = np.asarray(meta.changepoints, np.float32)
        x_season = seasonality.seasonal_feature_matrix(
            grid, config.seasonalities
        )  # (n, hb, Fs) host numpy
        mult_mask = np.asarray(
            [1.0 if m else 0.0 for m in config.feature_modes()],
            np.float32,
        )
        per_row = (mu[idx], rho[idx], s_cp, x_season)
        per_row_t = (t, y_scale, floor)
        step_rows = len(idx) if executor is None else _PART_ROWS
        parts = []
        for lo in range(0, len(idx), max(step_rows, 1)):
            hi = min(lo + step_rows, len(idx))
            args = (idx[lo:hi], *(a[lo:hi] for a in per_row), mult_mask,
                    *(a[lo:hi] for a in per_row_t), config, qs, draws, seed)
            parts.append((lo, hi, executor.submit(_advi_rows, *args)
                          if executor is not None else _advi_rows(*args)))
        for lo, hi, part in parts:
            out[lo:hi] = part if executor is None else part.result()
    else:
        det = _predict_rows(snap, backend, idx, hb, chunk=chunk)
        per_row = (np.asarray(det["trend"]), np.asarray(det["additive"]),
                   np.asarray(det["multiplicative"]), t, _host(sub.theta),
                   y_scale, floor)
        step_rows = len(idx) if executor is None else _PART_ROWS
        parts = []
        for lo in range(0, len(idx), max(step_rows, 1)):
            hi = min(lo + step_rows, len(idx))
            args = (idx[lo:hi], *(a[lo:hi] for a in per_row), config, qs,
                    draws, seed)
            parts.append((lo, hi, executor.submit(_map_rows, *args)
                          if executor is not None else _map_rows(*args)))
        for lo, hi, part in parts:
            out[lo:hi] = part if executor is None else part.result()
    return {permille(q): np.ascontiguousarray(out[:, j])
            for j, q in enumerate(qs)}


# ---------------------------------------------------------------------------
# publish
# ---------------------------------------------------------------------------


def write_qplane(vdir: str, snap, config, backend, *,
                 horizons: Sequence[int] = DEFAULT_HOT_HORIZONS,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 draws: int = DEFAULT_DRAWS,
                 seed: int = DEFAULT_SEED,
                 posterior=None,
                 fingerprint: Optional[str] = None,
                 numerics_rev: Optional[int] = None,
                 shard_rows: int = DEFAULT_SHARD_ROWS,
                 chunk: int = _PUBLISH_CHUNK,
                 processes: Optional[int] = None) -> Dict:
    """Land the full quantile plane for ``snap`` in ``vdir``: spec first,
    columns (each atomic), CRC sentinel LAST.  The ``qplane_publish``
    fault point is armed once per column, so a test can kill a publisher
    between any two columns and prove the sentinel refuses the tear.
    Either mode samples its rows on ``processes`` spawned worker
    processes (default: ``_publish_processes`` of the row count), the
    same bytes as one process.  Returns the spec."""
    n = int(snap.state.theta.shape[0])
    buckets = bucket_ladder(horizons)
    qs = tuple(float(q) for q in quantiles)
    cols: Dict[str, np.ndarray] = {}
    if processes is None:
        processes = _publish_processes(n)
    executor = None
    if processes > 1:
        # Spawned, never forked: the publisher may hold a CUDA context.
        executor = concurrent.futures.ProcessPoolExecutor(
            processes, mp_context=multiprocessing.get_context("spawn"))
    try:
        for hb in buckets:
            fresh = compute_rows(
                snap, config, backend, np.arange(n), hb, quantiles=qs,
                draws=draws, seed=seed, posterior=posterior, chunk=chunk,
                executor=executor,
            )
            for q in qs:
                cols[_col_name(hb, q)] = fresh[permille(q)]
    finally:
        if executor is not None:
            executor.shutdown()
    spec = {
        "format": QPLANE_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "buckets": [int(b) for b in buckets],
        "quantiles": [float(q) for q in qs],
        "draws": int(draws),
        "seed": int(seed),
        "mode": "advi" if posterior is not None else "map",
        "horizons": [int(h) for h in horizons],
        "fingerprint": fingerprint,
        "numerics_rev": numerics_rev,
        "columns": {k: {"dtype": a.dtype.str, "shape": list(a.shape)}
                    for k, a in cols.items()},
    }
    write_spec(os.path.join(vdir, QPLANE_SPEC), spec)
    for name, arr in cols.items():
        faults.inject("qplane_publish")
        write_column(_col_path(vdir, name), arr)
    sentinel = {
        "format": QPLANE_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "unix": round(time.time(), 3),
        "shards": [[lo, hi, shard_crcs(cols, lo, hi)]
                   for lo, hi in shard_ranges(n, shard_rows)],
    }
    write_sentinel(os.path.join(vdir, QPLANE_OK), sentinel)
    return spec


def write_qplane_delta(vdir: str, base_vdir: str, changed_rows,
                       snap, config, backend, *,
                       posterior=None,
                       fingerprint: Optional[str] = None,
                       numerics_rev: Optional[int] = None,
                       base_version: Optional[int] = None) -> Dict:
    """Copy-forward delta publish of the quantile plane, mirroring
    ``fplane.write_plane_delta``: unchanged rows' quantile cells are
    the base plane's bytes (their theta AND their ``(seed, row)`` draw
    key are unchanged, so a recompute would reproduce them exactly —
    the hardlink just skips the work); changed rows are re-sampled
    against the NEW snapshot.  Sampling identity (quantiles, draws,
    seed, mode) is inherited from the base spec — a delta can't
    silently flip the recipe mid-ladder."""
    base_spec = read_json(os.path.join(base_vdir, QPLANE_SPEC))
    base_ok = read_json(os.path.join(base_vdir, QPLANE_OK))
    if base_spec is None or base_ok is None:
        raise QuantilePlaneError(
            "absent", f"{base_vdir}: delta publish needs the base "
            "version's quantile plane (spec + sentinel)"
        )
    n = int(base_spec.get("n_series", -1))
    shard_rows = int(base_spec.get("shard_rows", DEFAULT_SHARD_ROWS))
    buckets = tuple(int(b) for b in base_spec.get("buckets") or ())
    qs = tuple(float(q) for q in base_spec.get("quantiles") or ())
    draws = int(base_spec.get("draws", DEFAULT_DRAWS))
    seed = int(base_spec.get("seed", DEFAULT_SEED))
    if base_spec.get("mode") == "map":
        posterior = None
    elif posterior is None:
        raise QuantilePlaneError(
            "absent", f"{base_vdir}: base plane is ADVI-mode but the "
            "delta version has no posterior — publish full instead"
        )
    changed = np.unique(np.asarray(changed_rows, np.int64))
    if len(changed) and (changed[0] < 0 or changed[-1] >= n):
        raise ValueError(f"changed rows outside [0, {n})")
    fresh: Dict[int, Dict[int, np.ndarray]] = {}
    if len(changed):
        for hb in buckets:
            fresh[hb] = compute_rows(
                snap, config, backend, changed, hb, quantiles=qs,
                draws=draws, seed=seed, posterior=posterior,
            )
    spec = dict(base_spec, fingerprint=fingerprint,
                numerics_rev=numerics_rev,
                delta_from=base_version, n_changed=int(len(changed)))
    write_spec(os.path.join(vdir, QPLANE_SPEC), spec)
    scattered: Dict[str, np.ndarray] = {}
    for name in base_spec["columns"]:
        src = _col_path(base_vdir, name)
        dst = _col_path(vdir, name)
        faults.inject("qplane_publish")
        if not len(changed):
            link_or_copy(src, dst)
            continue
        hb_tag, q_tag = name.split("_", 1)
        base_mm = attach_column(src)
        out = np.array(base_mm)        # copy-forward: one sequential read
        del base_mm
        out[changed] = np.asarray(
            fresh[int(hb_tag[1:])][int(q_tag[1:])], out.dtype
        )
        write_column(dst, out)
        scattered[name] = out
    touched = set(np.unique(changed // shard_rows).tolist())
    shards = []
    for entry in base_ok.get("shards") or ():
        lo, hi, crcs = int(entry[0]), int(entry[1]), dict(entry[2])
        if lo // shard_rows in touched:
            crcs.update(shard_crcs(scattered, lo, hi))
        shards.append([lo, hi, crcs])
    sentinel = dict(base_ok, unix=round(time.time(), 3), shards=shards)
    write_sentinel(os.path.join(vdir, QPLANE_OK), sentinel)
    return spec


# ---------------------------------------------------------------------------
# attach / verify
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QPlaneView:
    """One attached (memmap) quantile plane."""

    n_series: int
    buckets: Tuple[int, ...]
    quantiles: Tuple[float, ...]
    #: bucket -> permille -> (n_series, bucket) read-only memmap.
    columns: Dict[int, Dict[int, np.ndarray]]
    draws: int
    seed: int
    mode: str
    fingerprint: Optional[str]
    numerics_rev: Optional[int]

    def covers(self, hb: int, qs: Sequence[float]) -> bool:
        """Whether every requested quantile at this bucket can be
        gathered from the plane."""
        cols = self.columns.get(int(hb))
        if cols is None:
            return False
        return all(permille(q) in cols for q in qs)


def attach(vdir: str, *, verify: bool = True,
           expected_n: Optional[int] = None) -> QPlaneView:
    """Attach the quantile plane in ``vdir`` as memmap views.

    ``verify`` recomputes every shard CRC against the sentinel before
    any column is trusted.  Raises ``QuantilePlaneError("absent")``
    when no plane was published here, ``("corrupt")`` for anything
    torn, truncated, or mismatched."""
    sentinel = read_json(os.path.join(vdir, QPLANE_OK))
    spec = read_json(os.path.join(vdir, QPLANE_SPEC))
    if sentinel is None and spec is None:
        raise QuantilePlaneError(
            "absent", f"no quantile plane under {vdir}"
        )
    if spec is None or sentinel is None:
        raise QuantilePlaneError(
            "corrupt",
            f"{vdir}: quantile plane is half-published "
            f"(spec={'ok' if spec else 'missing'}, "
            f"sentinel={'ok' if sentinel else 'missing'})",
        )
    if spec.get("format") != QPLANE_FORMAT \
            or sentinel.get("format") != QPLANE_FORMAT:
        raise QuantilePlaneError(
            "corrupt",
            f"{vdir}: quantile plane format {spec.get('format')} != "
            f"{QPLANE_FORMAT}",
        )
    n = int(spec.get("n_series", -1))
    if expected_n is not None and n != int(expected_n):
        raise QuantilePlaneError(
            "corrupt",
            f"{vdir}: quantile plane carries {n} series, snapshot "
            f"says {expected_n}",
        )
    buckets = tuple(int(b) for b in spec.get("buckets") or ())
    qs = tuple(float(q) for q in spec.get("quantiles") or ())
    flat: Dict[str, np.ndarray] = {}
    for name, meta in (spec.get("columns") or {}).items():
        path = _col_path(vdir, name)
        try:
            mm = attach_column(path)
        except Exception as e:
            raise QuantilePlaneError("corrupt", f"{path}: {e}")
        if (mm.dtype.str != meta.get("dtype")
                or list(mm.shape) != meta.get("shape")):
            raise QuantilePlaneError(
                "corrupt",
                f"{path}: on-disk {mm.dtype.str}{list(mm.shape)} != "
                f"spec {meta.get('dtype')}{meta.get('shape')}",
            )
        flat[name] = mm
    for hb in buckets:
        for q in qs:
            if _col_name(hb, q) not in flat:
                raise QuantilePlaneError(
                    "corrupt",
                    f"{vdir}: quantile plane is missing column "
                    f"{_col_name(hb, q)!r}",
                )
    if verify:
        bad = verify_crcs(flat, sentinel.get("shards"))
        if bad is not None:
            name, lo, hi = bad
            raise QuantilePlaneError(
                "corrupt",
                f"{_col_path(vdir, name)}: shard [{lo}, {hi}) CRC "
                "mismatch (torn or silently corrupted quantile column)",
            )
    columns: Dict[int, Dict[int, np.ndarray]] = {
        hb: {permille(q): flat[_col_name(hb, q)] for q in qs}
        for hb in buckets
    }
    return QPlaneView(
        n_series=n, buckets=buckets, quantiles=qs, columns=columns,
        draws=int(spec.get("draws", DEFAULT_DRAWS)),
        seed=int(spec.get("seed", DEFAULT_SEED)),
        mode=str(spec.get("mode", "map")),
        fingerprint=spec.get("fingerprint"),
        numerics_rev=spec.get("numerics_rev"),
    )


def has_qplane(vdir: str) -> bool:
    """Cheap presence probe (no CRC sweep)."""
    return os.path.exists(os.path.join(vdir, QPLANE_OK))


def verify_qplane(vdir: str) -> bool:
    """Deep integrity check: True when the plane attaches AND every
    shard CRC matches (the chaos harness's torn-plane probe)."""
    try:
        attach(vdir, verify=True)
        return True
    except QuantilePlaneError:
        return False


def qplane_nbytes(vdir: str) -> Optional[int]:
    """Total column bytes of the quantile plane in ``vdir``; None when
    no plane is published."""
    spec = read_json(os.path.join(vdir, QPLANE_SPEC))
    if spec is None:
        return None
    total = 0
    for meta in (spec.get("columns") or {}).values():
        n = 1
        for d in meta.get("shape") or ():
            n *= int(d)
        total += n * int(np.dtype(meta["dtype"]).itemsize)
    return total


# ---------------------------------------------------------------------------
# the zero-dispatch read path
# ---------------------------------------------------------------------------


def quantile_batch(view: QPlaneView, snap, idx: np.ndarray,
                   hb: int) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """Serve snapshot rows ``idx`` at bucket ``hb`` straight from the
    quantile plane: one vectorized memmap gather per quantile plus the
    recomputed float64 ``ds`` grid.  Returns ``(grid, gathered)`` with
    ``gathered[permille]`` shaped ``(len(idx), hb)``.

    Page-cache reads and host numpy only: no device work, no durable
    write.  The grid is ``fplane.future_grid``'s math."""
    idx = np.asarray(idx, np.int64)
    meta = snap.state.meta
    last = (np.asarray(meta.ds_start, np.float64)[idx]
            + np.asarray(meta.ds_span, np.float64)[idx])
    step = np.asarray(snap.step, np.float64)[idx]
    grid = last[:, None] + step[:, None] * np.arange(1, int(hb) + 1)
    cols = view.columns[int(hb)]
    return grid, {pm: np.asarray(mm[idx]) for pm, mm in cols.items()}


def quantile_rows(view: QPlaneView, snap, idx: np.ndarray,
                  hb: int) -> List[Dict[str, np.ndarray]]:
    """Per-series form of :func:`quantile_batch`: one dict per index
    with ``"ds"`` and one ``"q<permille>"`` array per quantile."""
    grid, gathered = quantile_batch(view, snap, idx, hb)
    out: List[Dict[str, np.ndarray]] = []
    for i in range(len(grid)):
        row: Dict[str, np.ndarray] = {
            f"q{pm:03d}": v[i] for pm, v in gathered.items()
        }
        row["ds"] = grid[i]
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# publish orchestration
# ---------------------------------------------------------------------------


def maybe_publish(registry, version: int, backend=None, *,
                  horizons: Sequence[int] = DEFAULT_HOT_HORIZONS,
                  quantiles: Sequence[float] = DEFAULT_QUANTILES,
                  draws: int = DEFAULT_DRAWS,
                  seed: int = DEFAULT_SEED,
                  force: bool = False) -> Optional[Dict]:
    """Best-effort quantile-plane publish for ``version``: idempotent
    (``{"status": "present"}`` when a plane is there, unless ``force``),
    killable (``$TSSPARK_QPLANE=0`` returns None), speculative (None
    under the disk-pressure ladder's ``shed_spec`` state and on a storage
    refusal, ``DiskFullError`` or ``BackpressureError``), and None for
    logistic growth.

    Mode: ADVI when the version dir holds a compatible posterior
    artifact and the config is eligible, else MAP.  A delta version
    whose base has a plane of a recipe it can follow publishes a delta
    plane (``write_qplane_delta``).  ``backend=None`` is the ``cuda``
    backend on the card."""
    if os.environ.get("TSSPARK_QPLANE", "1") == "0":
        return None
    version = int(version)
    vdir = registry.version_dir(version)
    config = registry.config
    if config.growth == "logistic":
        return None
    if has_qplane(vdir) and not force:
        return {"status": "present", "version": version}
    lad = active_ladder(registry.root)
    if lad is not None and not lad.allows("speculate"):
        return None
    if backend is None:
        from tsspark_tpu_torch.backends.registry import get_backend
        from tsspark_tpu_torch.config import SolverConfig

        backend = get_backend("cuda", config, SolverConfig())
    t0 = time.time()
    try:
        snap = registry.load(version, fallback=False)
        n = int(snap.state.theta.shape[0])
        posterior = None
        if _advi_eligible(config):
            loaded = advi_mod.load_posterior(vdir)
            if loaded is not None and loaded[0].mu.shape[0] == n:
                posterior = loaded[0]
        info = None
        try:
            info = registry.delta_info(version)
        except Exception:
            info = None  # torn/racing manifest: publish full
        base_v = None if not info else info.get("base_version")
        base_ok = (base_v is not None
                   and has_qplane(registry.version_dir(int(base_v))))
        if base_ok:
            base_spec = read_json(os.path.join(
                registry.version_dir(int(base_v)), QPLANE_SPEC))
            if (base_spec or {}).get("mode") == "advi" \
                    and posterior is None:
                base_ok = False  # recipe changed: publish full
        if base_ok:
            spec = write_qplane_delta(
                vdir, registry.version_dir(int(base_v)),
                info.get("changed_rows") or (), snap, config, backend,
                posterior=posterior, base_version=int(base_v),
            )
            status = "published-delta"
        else:
            spec = write_qplane(
                vdir, snap, config, backend, horizons=horizons,
                quantiles=quantiles, draws=draws, seed=seed,
                posterior=posterior,
            )
            status = "published"
    except (DiskFullError, BackpressureError):
        return None
    return {"status": status, "version": version,
            "publish_s": round(time.time() - t0, 3),
            "mode": spec.get("mode"),
            "n_series": int(spec.get("n_series", 0)),
            "buckets": list(spec.get("buckets") or ()),
            "quantiles": list(spec.get("quantiles") or ()),
            "nbytes": qplane_nbytes(vdir)}
