"""Materialized forecast plane: point forecasts as shared mmap pages.

The port's copy of the JAX package's ``serve/fplane.py``, on the same
file layout, so a plane either package publishes attaches in the other.
At version-flip time the publisher computes the full (series x horizon
bucket) point-forecast table for the new version (``backend.predict`` at
``num_samples=0``: K1 on the card, in 256-row chunks padded up the
engine's width ladder) and lands it in the version dir under the
spec-first / atomic-columns / CRC-sentinel-last protocol
(``plane/protocol.py``):

* ``fplane_spec.json`` — identity record (bucket ladder, column
  dtypes/shapes, config fingerprint, NUMERICS_REV), written FIRST;
* ``fcol_h<bucket>_<key>.npy`` — one plain npy per (horizon bucket,
  output key): ``yhat`` / ``trend`` / ``additive`` / ``multiplicative``,
  each ``(n_series, bucket)`` in the exact dtype ``backend.predict``
  returns — a plane row IS the engine's dispatch output, bit for bit;
* ``fplaneok.json`` — the CRC sentinel, written LAST.  A torn publish
  fails it and is refused at attach; the engine then serves through its
  compute path.

A hot point-forecast read is a vectorized memmap gather
(:func:`plane_batch`): no parameter gather, no device work.  The ``ds``
grid is recomputed at read time with the engine's float64 formula over
the snapshot's cadence columns (the same bits).

Delta versions copy-forward unchanged series' columns: hardlink when
nothing changed, else one sequential base read and a scatter of the
refit rows' fresh forecasts, with CRCs recomputed only for the shards a
changed row lands in.

Publishing is speculative work: :func:`maybe_publish` refuses under the
disk-pressure ladder's ``shed_spec`` state and returns None on a
disk-budget refusal instead of failing the flip; ``$TSSPARK_FPLANE=0``
turns it off.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.io import (
    BackpressureError,
    DiskFullError,
    active_ladder,
    link_or_copy,
)
from tsspark_tpu_torch.parallel.sharding import compacted_width, next_pow2
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

__all__ = [
    "FPLANE_FORMAT", "FPLANE_SPEC", "FPLANE_OK", "FCOL_PREFIX",
    "POINT_KEYS", "DEFAULT_HOT_HORIZONS", "DEFAULT_SHARD_ROWS",
    "ForecastPlaneError", "FPlaneView", "bucket_ladder", "future_grid",
    "write_plane", "write_plane_delta", "attach", "has_plane",
    "verify_plane", "plane_batch", "plane_rows", "maybe_publish",
    "plane_nbytes",
]

#: Plane format revision (bump on incompatible layout change; the
#: reader refuses unknown revisions instead of misparsing them).
FPLANE_FORMAT = 1

FPLANE_SPEC = "fplane_spec.json"
FPLANE_OK = "fplaneok.json"
FCOL_PREFIX = "fcol_"

#: The deterministic (num_samples=0) predict output keys — the engine's
#: per-series row dict minus the recomputed ``ds`` grid.
POINT_KEYS = ("yhat", "trend", "additive", "multiplicative")

#: Horizons the plane covers by default — the pool's hot-horizon set;
#: the bucket ladder they induce is {8, 16, 32}.
DEFAULT_HOT_HORIZONS = (7, 14, 28)

#: CRC shard width (rows) — same bound as the snapshot plane's: what
#: one torn write can hide behind a stale CRC.
DEFAULT_SHARD_ROWS = 65536

#: Engine horizon floor (PredictionEngine.horizon_floor's default):
#: buckets below it never reach a dispatch, so the plane never needs
#: them either.
_HORIZON_FLOOR = 8

#: Publish-time batch width for the full-table compute.
_PUBLISH_CHUNK = 256


class ForecastPlaneError(RuntimeError):
    """Structured plane failure.  ``reason`` is ``"absent"`` (no plane
    was ever published here — serve through the compute path silently)
    or ``"corrupt"`` (a plane exists but fails its sentinel — torn
    publish; the reader must refuse it)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def bucket_ladder(horizons: Sequence[int],
                  floor: int = _HORIZON_FLOOR) -> Tuple[int, ...]:
    """The pow-2 horizon buckets ``horizons`` land in — the engine's
    grouping ladder (``max(floor, next_pow2(h))``), deduplicated."""
    return tuple(sorted({max(int(floor), next_pow2(int(h)))
                         for h in horizons}))


def _col_name(hb: int, key: str) -> str:
    return f"h{int(hb)}_{key}"


def _col_path(vdir: str, name: str) -> str:
    return os.path.join(vdir, f"{FCOL_PREFIX}{name}.npy")


def future_grid(state, step: np.ndarray, hb: int) -> np.ndarray:
    """The engine's future time grid, verbatim (``PredictionEngine.
    _dispatch``): each series continues its own calendar at its
    recorded cadence — float64 throughout, so a plane-time grid and a
    request-time grid over the same rows are bitwise identical."""
    last = np.asarray(state.meta.ds_start + state.meta.ds_span,
                      np.float64)
    return last[:, None] + np.asarray(step, np.float64)[:, None] \
        * np.arange(1, int(hb) + 1)


def _predict_rows(snap, backend, idx: np.ndarray, hb: int,
                  chunk: int = _PUBLISH_CHUNK) -> Dict[str, np.ndarray]:
    """Deterministic point forecasts for snapshot rows ``idx`` at
    bucket ``hb``: the engine's dispatch math (gather -> grid ->
    ``backend.predict`` at num_samples=0) in publish-width chunks.
    Every predict op is row-local, so the chunking is bitwise-invisible
    (the engine-parity contract)."""
    idx = np.asarray(idx, np.int64)
    outs: List[Dict[str, np.ndarray]] = []
    for lo in range(0, len(idx), int(chunk)):
        part = idx[lo:lo + int(chunk)]
        n_part = len(part)
        # Pad up the engine's pow-2 width ladder (width_floor=8,
        # repeat-first-row padding): publish-time launches share the
        # serve tier's shapes.
        width = compacted_width(n_part, floor=_HORIZON_FLOOR,
                                multiple=1)
        if width > n_part:
            part = np.concatenate(
                [part, np.repeat(part[:1], width - n_part)]
            )
        state, step = snap.take(part)
        grid = future_grid(state, step, hb)
        out = backend.predict(state, grid, num_samples=0, seed=0)
        outs.append({k: np.asarray(out[k])[:n_part]
                     for k in POINT_KEYS})
    if not outs:
        return {k: np.empty((0, int(hb)), np.float32)
                for k in POINT_KEYS}
    return {k: np.ascontiguousarray(
                np.concatenate([o[k] for o in outs], axis=0))
            for k in POINT_KEYS}


def write_plane(vdir: str, snap, backend, *,
                horizons: Sequence[int] = DEFAULT_HOT_HORIZONS,
                fingerprint: Optional[str] = None,
                numerics_rev: Optional[int] = None,
                shard_rows: int = DEFAULT_SHARD_ROWS,
                chunk: int = _PUBLISH_CHUNK) -> Dict:
    """Land the full forecast plane for ``snap`` in ``vdir``: spec
    first, columns (each itself atomic), CRC sentinel LAST.  The
    ``fplane_publish`` fault point is armed per column so the chaos
    harness can kill a publisher mid-plane and prove the sentinel
    rejects the tear.  Returns the spec."""
    n = int(snap.state.theta.shape[0])
    buckets = bucket_ladder(horizons)
    cols: Dict[str, np.ndarray] = {}
    for hb in buckets:
        fresh = _predict_rows(snap, backend, np.arange(n), hb,
                              chunk=chunk)
        for key in POINT_KEYS:
            cols[_col_name(hb, key)] = fresh[key]
    spec = {
        "format": FPLANE_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "buckets": [int(b) for b in buckets],
        "keys": list(POINT_KEYS),
        "horizons": [int(h) for h in horizons],
        "fingerprint": fingerprint,
        "numerics_rev": numerics_rev,
        "columns": {k: {"dtype": a.dtype.str, "shape": list(a.shape)}
                    for k, a in cols.items()},
    }
    write_spec(os.path.join(vdir, FPLANE_SPEC), spec)
    for name, arr in cols.items():
        faults.inject("fplane_publish")
        write_column(_col_path(vdir, name), arr)
    sentinel = {
        "format": FPLANE_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "unix": round(time.time(), 3),
        "shards": [[lo, hi, shard_crcs(cols, lo, hi)]
                   for lo, hi in shard_ranges(n, shard_rows)],
    }
    write_sentinel(os.path.join(vdir, FPLANE_OK), sentinel)
    return spec


def write_plane_delta(vdir: str, base_vdir: str, changed_rows,
                      snap, backend, *,
                      fingerprint: Optional[str] = None,
                      numerics_rev: Optional[int] = None,
                      base_version: Optional[int] = None) -> Dict:
    """Copy-forward delta publish: land the NEW version's forecast
    plane in ``vdir`` from the base version's in ``base_vdir`` plus a
    fresh compute over only ``changed_rows`` (``snap`` is the NEW
    version's snapshot — unchanged rows' parameters are bitwise the
    base's, so their base-plane forecasts are exactly what this
    version would compute).

    Per column: the zero-delta fast path HARDLINKS wholesale (zero new
    bytes, base CRCs reused verbatim); otherwise one sequential base
    read, a vectorized scatter of the recomputed changed rows, one
    atomic save — with CRCs recomputed only for the shards a changed
    row lands in.  Protocol order is ``write_plane``'s: spec first,
    columns, sentinel LAST; the ``fplane_publish`` fault point is
    armed per column."""
    base_spec = read_json(os.path.join(base_vdir, FPLANE_SPEC))
    base_ok = read_json(os.path.join(base_vdir, FPLANE_OK))
    if base_spec is None or base_ok is None:
        raise ForecastPlaneError(
            "absent", f"{base_vdir}: delta publish needs the base "
            "version's forecast plane (spec + sentinel)"
        )
    n = int(base_spec.get("n_series", -1))
    shard_rows = int(base_spec.get("shard_rows", DEFAULT_SHARD_ROWS))
    buckets = tuple(int(b) for b in base_spec.get("buckets") or ())
    changed = np.unique(np.asarray(changed_rows, np.int64))
    if len(changed) and (changed[0] < 0 or changed[-1] >= n):
        raise ValueError(f"changed rows outside [0, {n})")
    fresh: Dict[int, Dict[str, np.ndarray]] = {}
    if len(changed):
        for hb in buckets:
            fresh[hb] = _predict_rows(snap, backend, changed, hb)
    spec = dict(base_spec, fingerprint=fingerprint,
                numerics_rev=numerics_rev,
                delta_from=base_version, n_changed=int(len(changed)))
    write_spec(os.path.join(vdir, FPLANE_SPEC), spec)
    scattered: Dict[str, np.ndarray] = {}
    for name in base_spec["columns"]:
        src = _col_path(base_vdir, name)
        dst = _col_path(vdir, name)
        faults.inject("fplane_publish")
        if not len(changed):
            link_or_copy(src, dst)
            continue
        hb, key = name.split("_", 1)
        base_mm = attach_column(src)
        out = np.array(base_mm)        # copy-forward: one sequential read
        del base_mm
        out[changed] = np.asarray(fresh[int(hb[1:])][key], out.dtype)
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
    write_sentinel(os.path.join(vdir, FPLANE_OK), sentinel)
    return spec


@dataclasses.dataclass(frozen=True)
class FPlaneView:
    """One attached (memmap) forecast plane."""

    n_series: int
    buckets: Tuple[int, ...]
    keys: Tuple[str, ...]
    #: bucket -> key -> (n_series, bucket) read-only memmap.
    columns: Dict[int, Dict[str, np.ndarray]]
    fingerprint: Optional[str]
    numerics_rev: Optional[int]

    def covers(self, hb: int, num_samples: int) -> bool:
        """Whether a (horizon-bucket, num_samples) group can be served
        from this plane: deterministic requests only — sampled
        intervals stay on the compute path."""
        return num_samples == 0 and int(hb) in self.columns


def attach(vdir: str, *, verify: bool = True,
           expected_n: Optional[int] = None) -> FPlaneView:
    """Attach the forecast plane in ``vdir`` as memmap views.

    ``verify`` recomputes every shard CRC against the sentinel before
    any column is trusted — a sequential read of the shared pages that
    doubles as page warming for the first post-flip hot reads.  Raises
    ``ForecastPlaneError("absent")`` when no plane was published here,
    ``("corrupt")`` for anything torn, truncated, or mismatched."""
    sentinel = read_json(os.path.join(vdir, FPLANE_OK))
    spec = read_json(os.path.join(vdir, FPLANE_SPEC))
    if sentinel is None and spec is None:
        raise ForecastPlaneError(
            "absent", f"no forecast plane under {vdir}"
        )
    if spec is None or sentinel is None:
        raise ForecastPlaneError(
            "corrupt",
            f"{vdir}: forecast plane is half-published "
            f"(spec={'ok' if spec else 'missing'}, "
            f"sentinel={'ok' if sentinel else 'missing'})",
        )
    if spec.get("format") != FPLANE_FORMAT \
            or sentinel.get("format") != FPLANE_FORMAT:
        raise ForecastPlaneError(
            "corrupt",
            f"{vdir}: plane format {spec.get('format')} != "
            f"{FPLANE_FORMAT}",
        )
    n = int(spec.get("n_series", -1))
    if expected_n is not None and n != int(expected_n):
        raise ForecastPlaneError(
            "corrupt",
            f"{vdir}: plane carries {n} series, snapshot says "
            f"{expected_n}",
        )
    buckets = tuple(int(b) for b in spec.get("buckets") or ())
    keys = tuple(spec.get("keys") or POINT_KEYS)
    flat: Dict[str, np.ndarray] = {}
    for name, meta in (spec.get("columns") or {}).items():
        path = _col_path(vdir, name)
        try:
            mm = attach_column(path)
        except Exception as e:
            # Any unreadable column IS a corrupt plane (a header torn
            # mid-byte surfaces as SyntaxError out of numpy).
            raise ForecastPlaneError("corrupt", f"{path}: {e}")
        if (mm.dtype.str != meta.get("dtype")
                or list(mm.shape) != meta.get("shape")):
            raise ForecastPlaneError(
                "corrupt",
                f"{path}: on-disk {mm.dtype.str}{list(mm.shape)} != "
                f"spec {meta.get('dtype')}{meta.get('shape')}",
            )
        flat[name] = mm
    for hb in buckets:
        for key in keys:
            if _col_name(hb, key) not in flat:
                raise ForecastPlaneError(
                    "corrupt",
                    f"{vdir}: plane is missing column "
                    f"{_col_name(hb, key)!r}",
                )
    if verify:
        bad = verify_crcs(flat, sentinel.get("shards"))
        if bad is not None:
            name, lo, hi = bad
            raise ForecastPlaneError(
                "corrupt",
                f"{_col_path(vdir, name)}: shard [{lo}, {hi}) CRC "
                "mismatch (torn or silently corrupted forecast column)",
            )
    columns: Dict[int, Dict[str, np.ndarray]] = {
        hb: {key: flat[_col_name(hb, key)] for key in keys}
        for hb in buckets
    }
    return FPlaneView(
        n_series=n, buckets=buckets, keys=keys, columns=columns,
        fingerprint=spec.get("fingerprint"),
        numerics_rev=spec.get("numerics_rev"),
    )


def has_plane(vdir: str) -> bool:
    """Cheap presence probe (no CRC sweep)."""
    return os.path.exists(os.path.join(vdir, FPLANE_OK))


def verify_plane(vdir: str) -> bool:
    """Deep integrity check: True when the plane attaches AND every
    shard CRC matches (the chaos harness's torn-plane probe)."""
    try:
        attach(vdir, verify=True)
        return True
    except ForecastPlaneError:
        return False


def plane_nbytes(vdir: str) -> Optional[int]:
    """Total column bytes of the plane in ``vdir``; None when no plane
    is published."""
    spec = read_json(os.path.join(vdir, FPLANE_SPEC))
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


def plane_batch(view: FPlaneView, snap, idx: np.ndarray,
                hb: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Serve snapshot rows ``idx`` at bucket ``hb`` straight from the
    plane, batched: one vectorized memmap gather per output key plus
    the recomputed float64 ``ds`` grid.  Returns ``(grid, gathered)``
    with ``grid`` shaped ``(len(idx), hb)`` and each ``gathered[key]``
    the matching ``(len(idx), hb)`` column slice.

    Page-cache reads and host numpy only: no device work on this path.
    The grid math mirrors ``PredictionEngine._dispatch`` exactly, so a
    plane-served ``ds`` row equals a dispatch-computed one bit for
    bit."""
    idx = np.asarray(idx, np.int64)
    meta = snap.state.meta
    last = (np.asarray(meta.ds_start, np.float64)[idx]
            + np.asarray(meta.ds_span, np.float64)[idx])
    step = np.asarray(snap.step, np.float64)[idx]
    grid = last[:, None] + step[:, None] * np.arange(1, int(hb) + 1)
    cols = view.columns[int(hb)]
    return grid, {key: np.asarray(mm[idx]) for key, mm in cols.items()}


def plane_rows(view: FPlaneView, snap, idx: np.ndarray,
               hb: int) -> List[Dict[str, np.ndarray]]:
    """Per-series form of :func:`plane_batch`: one row dict per index,
    the engine's cache-scatter unit — used when a group mixes plane
    rows with LRU hits and the batch arrays can't serve it whole."""
    grid, gathered = plane_batch(view, snap, idx, hb)
    out: List[Dict[str, np.ndarray]] = []
    for i in range(len(grid)):
        row = {key: v[i] for key, v in gathered.items()}
        row["ds"] = grid[i]
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# publish orchestration
# ---------------------------------------------------------------------------


def maybe_publish(registry, version: int, backend=None, *,
                  horizons: Sequence[int] = DEFAULT_HOT_HORIZONS,
                  force: bool = False) -> Optional[Dict]:
    """Best-effort forecast-plane publish for ``version``, the flip
    hook.  Idempotent: a version that already has a plane returns
    ``{"status": "present"}`` (unless ``force``).  A delta version whose
    base has a plane publishes a delta plane (``write_plane_delta``).

    Publishing is speculative precompute, so it bows to the disk-pressure
    ladder: at ``shed_spec`` or worse it refuses outright, and a
    ``DiskFullError`` / ``BackpressureError`` mid-write returns None
    (no plane; the compute path serves) instead of failing the flip.
    ``$TSSPARK_FPLANE=0`` turns publishing off.  ``backend=None`` is the
    ``cuda`` backend on the card.

    Returns ``{"status", "version", "publish_s", ...}`` or None when
    publishing was shed or refused."""
    if os.environ.get("TSSPARK_FPLANE", "1") == "0":
        return None
    version = int(version)
    vdir = registry.version_dir(version)
    if has_plane(vdir) and not force:
        return {"status": "present", "version": version}
    lad = active_ladder(registry.root)
    if lad is not None and not lad.allows("speculate"):
        return None
    if backend is None:
        from tsspark_tpu_torch.backends.registry import get_backend
        from tsspark_tpu_torch.config import SolverConfig

        backend = get_backend("cuda", registry.config, SolverConfig())
    t0 = time.time()
    try:
        snap = registry.load(version, fallback=False)
        info = None
        try:
            info = registry.delta_info(version)
        except Exception:
            info = None  # torn/racing manifest: publish full
        base_v = None if not info else info.get("base_version")
        if base_v is not None \
                and has_plane(registry.version_dir(int(base_v))):
            spec = write_plane_delta(
                vdir, registry.version_dir(int(base_v)),
                info.get("changed_rows") or (), snap, backend,
                base_version=int(base_v),
            )
            status = "published-delta"
        else:
            spec = write_plane(vdir, snap, backend, horizons=horizons)
            status = "published"
    except (DiskFullError, BackpressureError):
        return None
    publish_s = round(time.time() - t0, 3)
    return {"status": status, "version": version,
            "publish_s": publish_s,
            "n_series": int(spec.get("n_series", 0)),
            "buckets": list(spec.get("buckets") or ()),
            "nbytes": plane_nbytes(vdir)}
