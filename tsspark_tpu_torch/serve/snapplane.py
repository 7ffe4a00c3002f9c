"""Memmap snapshot column plane: registry versions as shared pages.

The port's copy of the JAX package's ``serve/snapplane.py``, on the same
file layout, so a plane either package publishes attaches in the other.
Each registry version lands as one ``.npy`` column file per FitState
leaf plus the id->row index, under the spec-first / sentinel-last
protocol (``plane/protocol.py``):

* ``snap_spec.json``  — identity record (column dtypes/shapes, n_series,
  config fingerprint, NUMERICS_REV), written FIRST;
* ``snapcol_<name>.npy`` — one plain npy per column: ``theta``, the
  solver diagnostics, every ``meta_*`` ScalingMeta leaf (host float64),
  ``extra_*`` side arrays (per-series cadence), plus the id index triple
  ``ids`` / ``ids_sorted`` / ``id_order``;
* ``snapok.json``     — the CRC sentinel, written LAST: per-shard CRC32
  of every column's rows.  A torn or silently corrupted column is
  refused at attach instead of being assembled into forecasts.

Readers attach with ``np.load(..., mmap_mode="r")``: every process maps
one page-cache copy of the active version, and the attach-time CRC sweep
doubles as page warming.  Row lookup is one vectorized
``np.searchsorted`` against the publish-time sorted id column (no
per-series dict).

The npz (``utils.checkpoint.save_state``) stays the archival format:
``ParamRegistry._load_version`` prefers the plane, degrades to the same
version's npz when the plane is torn, and only then walks the
active->previous fallback chain.  ``write_plane_delta`` lands a new
version as a copy-forward of a base version's plane with only the refit
rows replaced: untouched columns hardlink, unchanged rows keep the base
version's bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np

import torch

from tsspark_tpu_torch.io import atomic_write, link_or_copy
from tsspark_tpu_torch.models.prophet.design import ScalingMeta
from tsspark_tpu_torch.models.prophet.model import FitState
from tsspark_tpu_torch.plane.protocol import (
    attach_column,
    publish_plane,
    read_json,
    shard_crcs,
    shard_ranges,
    verify_crcs,
    write_column,
    write_sentinel,
    write_spec,
)

__all__ = [
    "SNAP_FORMAT", "SNAP_SPEC", "SNAP_OK", "COL_PREFIX",
    "DELTA_MANIFEST", "DEFAULT_SHARD_ROWS", "SnapshotPlaneError",
    "PlaneView", "shard_ranges", "state_columns", "write_plane",
    "write_plane_delta", "read_delta_manifest", "attach", "has_plane",
    "verify_plane", "snapshot_nbytes",
]

#: Plane format revision (bump on incompatible layout change; the
#: reader refuses unknown revisions instead of misparsing them).
SNAP_FORMAT = 1

SNAP_SPEC = "snap_spec.json"
SNAP_OK = "snapok.json"
COL_PREFIX = "snapcol_"

#: Delta-publish metadata (``write_plane_delta``): base version, the
#: changed-row/id set, and the data-plane coverage stamp — what the
#: serving side reads to carry unchanged series' cache entries forward
#: across a delta flip instead of dropping the whole version's cache.
DELTA_MANIFEST = "delta_manifest.json"

#: CRC shard width (rows).  Shards bound what one torn write can hide
#: behind a stale CRC and give the chaos harness a named unit to tear;
#: 64k rows keeps the sentinel a few entries even at 1M series.
DEFAULT_SHARD_ROWS = 65536


class SnapshotPlaneError(RuntimeError):
    """Structured plane failure.  ``reason`` is ``"absent"`` (no plane
    was ever published in this version dir — fall back to the npz
    silently) or ``"corrupt"`` (a plane exists but fails its sentinel —
    the caller must treat the version as torn)."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def _col_path(vdir: str, name: str) -> str:
    return os.path.join(vdir, f"{COL_PREFIX}{name}.npy")


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as host numpy, dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_columns(state: FitState,
                  extras: Optional[Dict[str, np.ndarray]] = None
                  ) -> Dict[str, np.ndarray]:
    """FitState -> host-numpy column dict, the exact key set
    ``utils.checkpoint.save_state`` puts in the npz (minus the
    integrity stamp) — one leaf naming scheme for both formats, so the
    bitwise-parity contract is checkable key by key."""
    cols = {
        "theta": _host(state.theta),
        "loss": np.asarray(state.loss),
        "grad_norm": np.asarray(state.grad_norm),
        "converged": np.asarray(state.converged),
        "n_iters": np.asarray(state.n_iters),
    }
    if state.status is not None:
        cols["status"] = np.asarray(state.status)
    cols.update(
        {f"meta_{k}": np.asarray(v)
         for k, v in state.meta._asdict().items()}
    )
    cols.update(
        {f"extra_{k}": np.asarray(v)
         for k, v in (extras or {}).items()}
    )
    return cols


def write_plane(vdir: str, state: FitState, ids: np.ndarray,
                extras: Optional[Dict[str, np.ndarray]] = None, *,
                fingerprint: Optional[str] = None,
                numerics_rev: Optional[int] = None,
                shard_rows: int = DEFAULT_SHARD_ROWS) -> None:
    """Land one version's column plane in ``vdir``: spec first, columns
    (each itself atomic), CRC sentinel last.  The version dir is
    publisher-private until the registry manifest references it, so a
    publisher killed mid-plane leaves an orphan dir the version
    allocator skips — never a half-visible snapshot."""
    ids = np.asarray(ids)
    if ids.dtype.kind not in ("U", "S"):
        ids = ids.astype(np.str_)
    cols = state_columns(state, extras)
    n = int(cols["theta"].shape[0])
    if len(ids) != n:
        raise ValueError(f"{len(ids)} ids for {n} state rows")
    # The searchsorted row index, PRECOMPUTED at publish: readers mmap
    # the sorted view directly instead of paying an O(n log n) sort (or
    # an O(n) dict build) on every snapshot load.
    order = np.argsort(ids, kind="stable").astype(np.int64)
    cols["ids"] = ids
    cols["ids_sorted"] = ids[order]
    cols["id_order"] = order
    spec = {
        "format": SNAP_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "fingerprint": fingerprint,
        "numerics_rev": numerics_rev,
        "columns": {k: {"dtype": a.dtype.str, "shape": list(a.shape)}
                    for k, a in cols.items()},
    }
    sentinel = {
        "format": SNAP_FORMAT,
        "n_series": n,
        "shard_rows": int(shard_rows),
        "unix": round(time.time(), 3),
        "shards": [[lo, hi, shard_crcs(cols, lo, hi)]
                   for lo, hi in shard_ranges(n, shard_rows)],
    }
    publish_plane(vdir, SNAP_SPEC, spec, cols, _col_path,
                  SNAP_OK, sentinel)


def write_plane_delta(vdir: str, base_vdir: str, changed_rows,
                      sub_state: Optional[FitState], *,
                      extras_sub: Optional[Dict[str, np.ndarray]] = None,
                      base_version: Optional[int] = None,
                      data_stamp: Optional[int] = None,
                      fingerprint: Optional[str] = None,
                      numerics_rev: Optional[int] = None) -> Dict:
    """Copy-forward delta publish: land a NEW version's plane in
    ``vdir`` from the base version's plane in ``base_vdir`` plus a
    refit over only ``changed_rows`` (``sub_state`` has one row per
    changed series, base row order).

    Per column:

    * a column whose rows cannot have changed (the id index triple, an
      extra the caller did not refit) — or ANY column when the changed
      set is empty (the zero-delta fast path) — is HARDLINKED
      wholesale: zero new snapshot bytes, and the base sentinel's CRCs
      are reused verbatim;
    * a refit column is copy-forwarded: one sequential read of the base
      memmap into a fresh buffer, a vectorized scatter of the changed
      rows, one atomic save.  Unchanged rows are therefore BITWISE the
      base version's — the delta-publish parity contract the refit-kill
      chaos invariant checks — and CRCs are recomputed only for shards
      a changed row actually lands in (untouched shards reuse the base
      CRC: copy-forward preserved their bytes).

    Protocol order is ``write_plane``'s: spec first, columns, sentinel
    LAST, then the delta manifest (pure metadata — the registry
    manifest referencing ``vdir`` is the real visibility gate).  The
    ``delta_publish`` fault point is armed per column so the chaos
    harness can kill a publisher mid-plane.  Returns the delta
    manifest record."""
    from tsspark_tpu_torch.resilience import faults

    base_spec = read_json(os.path.join(base_vdir, SNAP_SPEC))
    base_ok = read_json(os.path.join(base_vdir, SNAP_OK))
    if base_spec is None or base_ok is None:
        raise SnapshotPlaneError(
            "absent", f"{base_vdir}: delta publish needs the base "
            "version's snapshot plane (spec + sentinel)"
        )
    n = int(base_spec.get("n_series", -1))
    shard_rows = int(base_spec.get("shard_rows", DEFAULT_SHARD_ROWS))
    changed = np.unique(np.asarray(changed_rows, np.int64))
    if len(changed) and (changed[0] < 0 or changed[-1] >= n):
        raise ValueError(f"changed rows outside [0, {n})")
    sub_cols: Dict[str, np.ndarray] = {}
    if len(changed):
        if sub_state is None:
            raise ValueError("sub_state required for a non-empty delta")
        sub_cols = state_columns(sub_state, extras_sub)
        for name in ("ids", "ids_sorted", "id_order"):
            sub_cols.pop(name, None)
        unknown = sorted(set(sub_cols) - set(base_spec["columns"]))
        if unknown:
            raise ValueError(
                f"refit columns {unknown} not in the base plane — the "
                "two versions' FitState layouts drifted; publish a full "
                "snapshot instead"
            )
        for name, sub in sub_cols.items():
            if sub.shape[0] != len(changed):
                raise ValueError(
                    f"column {name}: {sub.shape[0]} refit rows for "
                    f"{len(changed)} changed series"
                )
    spec = dict(base_spec, fingerprint=fingerprint,
                numerics_rev=numerics_rev,
                delta_from=base_version, n_changed=int(len(changed)))
    write_spec(os.path.join(vdir, SNAP_SPEC), spec)
    scattered: Dict[str, np.ndarray] = {}
    for name in base_spec["columns"]:
        src = _col_path(base_vdir, name)
        dst = _col_path(vdir, name)
        faults.inject("delta_publish")
        if name not in sub_cols:
            link_or_copy(src, dst)
            continue
        base_mm = attach_column(src)
        out = np.array(base_mm)        # copy-forward: one sequential read
        del base_mm
        out[changed] = np.asarray(sub_cols[name], out.dtype)
        write_column(dst, out)
        scattered[name] = out
    # Sentinel: recompute only (scattered column x touched shard) CRCs.
    touched = set(np.unique(changed // shard_rows).tolist())
    shards = []
    for entry in base_ok.get("shards") or ():
        lo, hi, crcs = int(entry[0]), int(entry[1]), dict(entry[2])
        if lo // shard_rows in touched:
            crcs.update(shard_crcs(scattered, lo, hi))
        shards.append([lo, hi, crcs])
    sentinel = dict(base_ok, unix=round(time.time(), 3), shards=shards)
    write_sentinel(os.path.join(vdir, SNAP_OK), sentinel)
    ids_mm = attach_column(_col_path(base_vdir, "ids"))
    manifest = {
        "base_version": base_version,
        "n_changed": int(len(changed)),
        "changed_rows": [int(r) for r in changed.tolist()],
        "changed_ids": [str(s) for s in ids_mm[changed]],
        "data_stamp": data_stamp,
        "unix": round(time.time(), 3),
    }
    del ids_mm
    atomic_write(os.path.join(vdir, DELTA_MANIFEST),
                 lambda fh: json.dump(manifest, fh), mode="w")
    return manifest


def read_delta_manifest(vdir: str) -> Optional[Dict]:
    """The version's delta-publish metadata, or None for a full
    (non-delta) version."""
    return read_json(os.path.join(vdir, DELTA_MANIFEST))


@dataclasses.dataclass(frozen=True)
class PlaneView:
    """One attached (memmap) snapshot plane."""

    n_series: int
    state: FitState                # read-only memmaps; theta a CPU tensor
                                   # over its memmap
    ids: np.ndarray                # (n,) memmap, original row order
    ids_sorted: np.ndarray         # (n,) memmap, lexicographic
    id_order: np.ndarray           # (n,) int64 memmap, sorted pos -> row
    extras: Dict[str, np.ndarray]
    fingerprint: Optional[str]
    numerics_rev: Optional[int]


def attach(vdir: str, *, verify: bool = True,
           expected_n: Optional[int] = None) -> PlaneView:
    """Attach the plane in ``vdir`` as memmap views.

    ``verify`` recomputes every shard CRC against the sentinel before
    any column is trusted — a sequential read of the shared pages that
    doubles as the activation prefetch's page warming (the pages stay
    in cache for every other process mapping this version).  Raises
    ``SnapshotPlaneError("absent")`` when no plane was published here,
    ``("corrupt")`` for anything torn, truncated, or mismatched.
    """
    sentinel = read_json(os.path.join(vdir, SNAP_OK))
    spec = read_json(os.path.join(vdir, SNAP_SPEC))
    if sentinel is None and spec is None:
        raise SnapshotPlaneError(
            "absent", f"no snapshot plane under {vdir}"
        )
    if spec is None or sentinel is None:
        raise SnapshotPlaneError(
            "corrupt",
            f"{vdir}: plane is half-published "
            f"(spec={'ok' if spec else 'missing'}, "
            f"sentinel={'ok' if sentinel else 'missing'})",
        )
    if spec.get("format") != SNAP_FORMAT \
            or sentinel.get("format") != SNAP_FORMAT:
        raise SnapshotPlaneError(
            "corrupt",
            f"{vdir}: plane format {spec.get('format')} != {SNAP_FORMAT}",
        )
    n = int(spec.get("n_series", -1))
    if expected_n is not None and n != int(expected_n):
        raise SnapshotPlaneError(
            "corrupt",
            f"{vdir}: plane carries {n} series, manifest says "
            f"{expected_n}",
        )
    cols: Dict[str, np.ndarray] = {}
    for name, meta in (spec.get("columns") or {}).items():
        path = _col_path(vdir, name)
        try:
            mm = attach_column(path)
        except Exception as e:
            # Not just OSError/ValueError: a header torn mid-byte
            # surfaces as SyntaxError out of numpy's literal_eval — any
            # unreadable column IS a corrupt plane.
            raise SnapshotPlaneError("corrupt", f"{path}: {e}")
        if (mm.dtype.str != meta.get("dtype")
                or list(mm.shape) != meta.get("shape")):
            raise SnapshotPlaneError(
                "corrupt",
                f"{path}: on-disk {mm.dtype.str}{list(mm.shape)} != "
                f"spec {meta.get('dtype')}{meta.get('shape')}",
            )
        cols[name] = mm
    for req in ("theta", "ids", "ids_sorted", "id_order"):
        if req not in cols:
            raise SnapshotPlaneError(
                "corrupt", f"{vdir}: plane is missing column {req!r}"
            )
    if verify:
        bad = verify_crcs(cols, sentinel.get("shards"))
        if bad is not None:
            name, lo, hi = bad
            raise SnapshotPlaneError(
                "corrupt",
                f"{_col_path(vdir, name)}: shard [{lo}, {hi}) "
                "CRC mismatch (torn or silently corrupted "
                "snapshot column)",
            )
    meta_fields = {
        k[len("meta_"):]: np.asarray(cols[k], np.float64)
        for k in cols if k.startswith("meta_")
    }
    with warnings.catch_warnings():
        # A read-only memmap: the tensor shares its pages (nothing in
        # the port writes a loaded snapshot's theta in place).
        warnings.simplefilter("ignore", UserWarning)
        theta = torch.from_numpy(cols["theta"])
    state = FitState(
        theta=theta,
        meta=ScalingMeta(**meta_fields),
        loss=cols["loss"],
        grad_norm=cols["grad_norm"],
        converged=cols["converged"],
        n_iters=cols["n_iters"],
        status=cols.get("status"),
    )
    return PlaneView(
        n_series=n,
        state=state,
        ids=cols["ids"],
        ids_sorted=cols["ids_sorted"],
        id_order=cols["id_order"],
        extras={k[len("extra_"):]: v for k, v in cols.items()
                if k.startswith("extra_")},
        fingerprint=spec.get("fingerprint"),
        numerics_rev=spec.get("numerics_rev"),
    )


def has_plane(vdir: str) -> bool:
    """Cheap presence probe (no CRC sweep)."""
    return os.path.exists(os.path.join(vdir, SNAP_OK))


def verify_plane(vdir: str) -> bool:
    """Deep integrity check: True when the plane attaches AND every
    shard CRC matches (the chaos harness's torn-shard probe)."""
    try:
        attach(vdir, verify=True)
        return True
    except SnapshotPlaneError:
        return False


def snapshot_nbytes(vdir: str) -> Optional[int]:
    """Total column bytes of the plane in ``vdir`` (the denominator of
    the scale ladder's one-physical-copy RSS accounting); None when no
    plane is published."""
    spec = read_json(os.path.join(vdir, SNAP_SPEC))
    if spec is None:
        return None
    total = 0
    for meta in (spec.get("columns") or {}).values():
        n = 1
        for d in meta.get("shape") or ():
            n *= int(d)
        total += n * int(np.dtype(meta["dtype"]).itemsize)
    return total
