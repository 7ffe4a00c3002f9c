"""Columnar on-disk dataset cache: the port's data plane.

The port's copy of the JAX package's ``data/plane.py``, byte for byte in
what it writes, so either package opens a dataset the other wrote: one
cache of memmap column shards shared by every consumer that needs
generated or imported series (the plane-fed fit, the streaming replay
source, the calibration smoke, the gold audit).

* **Layout** -- one directory per dataset under :func:`default_root`,
  keyed by (generator, shape, seed, shard width, datagen fingerprint).
  Inside: ``spec.json`` (identity, written first), ``ds.npy`` (shared
  calendar, float64), preallocated float32 column files ``y.npy`` /
  ``mask.npy`` / ``reg.npy`` / ``cap.npy``, one
  ``shardok_<lo>_<hi>.json`` sentinel per landed shard and a final
  ``plane_manifest.json``.

* **Lifecycle** -- column files are preallocated memmaps filled shard by
  shard; a shard's rows become visible ONLY once its sentinel (written
  atomically, payload CRCs inside) lands, and the manifest (atomic,
  written last after sentinel coverage is complete) marks the dataset
  warm.  Readers never trust bytes a sentinel doesn't cover, so a torn
  shard can never be consumed; concurrent producers are safe because
  generation is deterministic -- racers write identical bytes and the
  last identical sentinel wins whole.

* **Determinism** -- generation is block-seeded
  (:data:`~tsspark_tpu_torch.data.datasets.SEED_BLOCK`): rows [lo, hi)
  of a dataset are bitwise-identical whether produced by one process, a
  shard pool, or a consumer self-healing a stalled ingest.

* **Overlap** -- :mod:`tsspark_tpu_torch.data.ingest` produces shards in
  a background process pool while consumers read already-landed
  coverage (:func:`ready_coverage`), so a cold run starts work before
  ingestion finishes and a warm run is pure memmap reads.

Scenario packs (irregular cadence, missing windows, cold start, M5
store->dept->item hierarchy) are named datasets behind the same
manifest -- see :data:`GENERATORS`.  Like the JAX package's module this
one is numpy-only: it imports neither torch nor anything of the JAX
package, so the ingest's child processes start lean.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import tempfile
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.data import datasets
from tsspark_tpu_torch.data.datasets import SeriesBatch
from tsspark_tpu_torch.io import (
    atomic_write,
    attach_array,
    gate_ingest,
    hardlink,
    is_missing,
    open_memmap,
    reraise_classified,
)
from tsspark_tpu_torch.plane.protocol import (
    read_json,
    shard_crcs,
    write_sentinel,
)
from tsspark_tpu_torch.plane.protocol import shard_ranges as _plane_shard_ranges
from tsspark_tpu_torch.resilience import integrity

#: Cache-format revision: bump when the on-disk layout (NOT the data)
#: changes incompatibly; part of every spec record.
PLANE_VERSION = 1

#: Default I/O shard width — a multiple of every pow-2 claim width the
#: orchestrator's autotuner dispatches (floor 128, historical cap 1024),
#: so fit claims always nest inside whole shards.
DEFAULT_SHARD_ROWS = 1024

#: Column files, in the fit workers' naming (float32 on disk;
#: ``ds.npy`` rides separately and stays float64).
COLUMN_FIELDS = ("y", "mask", "reg", "cap")

_SPEC_FILE = "spec.json"
_MANIFEST_FILE = "plane_manifest.json"

#: name -> row generator ``fn(lo, hi, n_timesteps, seed) -> SeriesBatch``.
#: Every generator is block-seeded: rows are independent of the total
#: series count, so datasets extend without regeneration.
GENERATORS: Dict[str, Callable[..., SeriesBatch]] = {
    "m5": lambda lo, hi, t, seed: datasets.m5_rows(
        lo, hi, n_days=t, seed=seed, scenario="base"),
    "m5_irregular": lambda lo, hi, t, seed: datasets.m5_rows(
        lo, hi, n_days=t, seed=seed, scenario="irregular"),
    "m5_missing_windows": lambda lo, hi, t, seed: datasets.m5_rows(
        lo, hi, n_days=t, seed=seed, scenario="missing_windows"),
    "m5_cold_start": lambda lo, hi, t, seed: datasets.m5_rows(
        lo, hi, n_days=t, seed=seed, scenario="cold_start"),
    "m5_hier": lambda lo, hi, t, seed: datasets.m5_rows(
        lo, hi, n_days=t, seed=seed, scenario="hier"),
    "demo_weekly": lambda lo, hi, t, seed: datasets.demo_weekly_rows(
        lo, hi, n_steps=t, seed=seed),
}


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Identity of one cached dataset (the manifest key)."""

    generator: str
    n_series: int
    n_timesteps: int
    seed: int = 2
    shard_rows: int = DEFAULT_SHARD_ROWS

    def __post_init__(self):
        if self.generator not in GENERATORS \
                and not self.generator.startswith("import:"):
            raise ValueError(
                f"unknown generator {self.generator!r}; known: "
                f"{sorted(GENERATORS)} (or 'import:<name>')"
            )
        if self.n_series <= 0 or self.n_timesteps <= 0:
            raise ValueError("n_series and n_timesteps must be positive")
        if self.shard_rows <= 0:
            raise ValueError("shard_rows must be positive")

    def cache_key(self) -> str:
        return (
            f"{self.generator}_{self.n_series}x{self.n_timesteps}"
            f"_s{self.seed}_r{self.shard_rows}_{dataset_fingerprint()}"
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DatasetSpec":
        return cls(**{
            k: d[k] for k in
            ("generator", "n_series", "n_timesteps", "seed", "shard_rows")
        })


_FP_CACHE: Dict[str, str] = {}


def dataset_fingerprint() -> str:
    """Hash of the WHOLE data package (datasets + loaders + plane +
    ingest): a change to any of them rotates every cache key, so a
    loader/plane change can never serve stale cached arrays.  It hashes
    this package's own files, so the port's keys differ from the JAX
    package's in the fingerprint alone (the bytes inside are equal)."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    if pkg in _FP_CACHE:
        return _FP_CACHE[pkg]
    h = hashlib.md5()
    h.update(str(PLANE_VERSION).encode())
    for path in sorted(glob.glob(os.path.join(pkg, "*.py"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    _FP_CACHE[pkg] = h.hexdigest()[:8]
    return _FP_CACHE[pkg]


def default_root() -> str:
    """The shared cache root: ``$TSSPARK_DATA_ROOT`` or a stable temp
    location (every consumer -- the plane-fed fit, streaming replay --
    default here, which is what makes the plane SHARED)."""
    return os.environ.get("TSSPARK_DATA_ROOT") or os.path.join(
        tempfile.gettempdir(), "tsspark_plane"
    )


def dataset_dir(spec: DatasetSpec, root: Optional[str] = None) -> str:
    return os.path.join(root or default_root(), spec.cache_key())


def shard_ranges(spec: DatasetSpec) -> List[Tuple[int, int]]:
    return _plane_shard_ranges(spec.n_series, spec.shard_rows)


def generate_rows(spec: DatasetSpec, lo: int, hi: int) -> SeriesBatch:
    """Canonical in-memory generation of rows [lo, hi) — what the cache
    must match bitwise (after the float32/nan_to_num disk conversion)."""
    if spec.generator.startswith("import:"):
        raise ValueError(
            "imported datasets have no generator; read the cache"
        )
    return GENERATORS[spec.generator](
        lo, hi, spec.n_timesteps, spec.seed
    )


def series_ids(spec: DatasetSpec, lo: int = 0,
               hi: Optional[int] = None) -> np.ndarray:
    return datasets.dataset_ids(
        spec.generator, lo, spec.n_series if hi is None else hi
    )


# ---------------------------------------------------------------------------
# disk conversion
# ---------------------------------------------------------------------------


def batch_columns(batch: SeriesBatch) -> Dict[str, np.ndarray]:
    """SeriesBatch -> the float32 column dict the cache stores (NaN
    holes become zeros; the mask carries observedness — the exact
    conversion the JAX package's plane applies)."""
    cols = {
        "y": np.nan_to_num(np.asarray(batch.y)).astype(np.float32),
        "mask": np.asarray(batch.mask, np.float32),
    }
    if batch.regressors is not None:
        cols["reg"] = np.asarray(batch.regressors, np.float32)
    if batch.cap is not None:
        cols["cap"] = np.asarray(batch.cap, np.float32)
    return cols


def _sentinel_path(dset_dir: str, lo: int, hi: int) -> str:
    return os.path.join(dset_dir, f"shardok_{lo:09d}_{hi:09d}.json")


def _land_shard_sentinel(dset_dir: str, lo: int, hi: int,
                         cols: Dict[str, np.ndarray]) -> None:
    """Publish (or re-publish) one shard's visibility sentinel: atomic,
    payload CRCs inside.  ONE writer for the base-ingest path AND the
    delta path — a delta that mutates landed rows must re-land the
    sentinel with fresh CRCs or ``verify_shard``/``repair`` would treat
    the advanced rows as corruption and roll them back to base."""
    sentinel = {
        "lo": lo, "hi": hi, "unix": round(time.time(), 3),
        "crc": shard_crcs(cols), "pid": os.getpid(),
    }
    write_sentinel(_sentinel_path(dset_dir, lo, hi), sentinel)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _column_shapes(spec: DatasetSpec,
                   fields: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
    n, t = spec.n_series, spec.n_timesteps
    shapes: Dict[str, Tuple[int, ...]] = {}
    for f in fields:
        if f == "reg":
            # Regressor count comes from a 1-row probe at create time
            # and is recorded in spec.json; see create_columns.
            continue
        shapes[f] = (n, t)
    return shapes


def _prealloc_column(path: str, shape: Tuple[int, ...]) -> None:
    """Preallocate one column file WITHOUT ever clobbering an existing
    one: the memmap is built under a dot-temp name and published with
    ``os.link`` (atomic create-if-absent — it FAILS when the path
    exists, unlike rename).  Two cold producers racing the same spec
    then cannot truncate rows — or orphan sentinels — the other has
    already landed; the loser simply adopts the winner's file."""
    if os.path.exists(path):
        return
    d, base = os.path.split(os.path.abspath(path))
    tmp = os.path.join(d, f".{base}.tmp.{os.getpid()}")
    mm = open_memmap(tmp, mode="w+", dtype=np.float32, shape=shape)
    del mm
    try:
        hardlink(tmp, path)
    except FileExistsError:
        pass  # a racer published first; keep theirs (rows may be landed)
    finally:
        try:
            os.remove(tmp)
        except OSError as e:
            # A temp that is already gone is fine; a disk that refuses
            # the unlink (EIO, EROFS) is not — surface it typed.
            if not is_missing(e):
                reraise_classified(e)


def read_spec(dset_dir: str) -> Optional[Dict]:
    """The dataset's identity record, or None when ``dset_dir`` is not
    a plane dataset (e.g. a plain spill dir of column files).
    Absence and torn JSON read as None; a real disk failure raises its
    typed storage error (``tsspark_tpu_torch.io.errors``)."""
    return read_json(os.path.join(dset_dir, _SPEC_FILE))


def create_columns(spec: DatasetSpec, root: Optional[str] = None) -> str:
    """Create (or adopt) the dataset dir: write ``spec.json`` + the
    shared calendar atomically and preallocate the column memmaps.

    Idempotent and race-safe: the column bytes are deterministic, so two
    creators racing the same spec produce identical files; preallocation
    itself is NOT atomic but no reader ever touches column rows before
    their shard sentinel exists (the sentinel, not the column file, is
    the unit of visibility)."""
    dset_dir = dataset_dir(spec, root)
    os.makedirs(dset_dir, exist_ok=True)
    record = read_spec(dset_dir)
    if record is not None:
        return dset_dir
    if spec.generator.startswith("import:"):
        raise ValueError("import_batch owns imported dataset creation")
    # Field/regressor discovery probes a TINY grid (fields and reg count
    # are per-generator constants, independent of T); the real calendar
    # comes from the closed-form grid so creation never generates a
    # full seed block on a consumer's blocked path.
    probe = generate_rows(
        dataclasses.replace(spec, n_timesteps=min(spec.n_timesteps, 8)),
        0, 1,
    )
    cols = batch_columns(probe)
    fields = sorted(cols)
    atomic_write(
        os.path.join(dset_dir, "ds.npy"),
        lambda fh: np.save(fh, datasets.dataset_calendar(
            spec.generator, spec.n_timesteps)),
    )
    for f in fields:
        shape = ((spec.n_series, spec.n_timesteps)
                 + cols[f].shape[2:])
        _prealloc_column(os.path.join(dset_dir, f"{f}.npy"), shape)
    record = dict(spec.to_dict(), fields=fields,
                  fingerprint=dataset_fingerprint(),
                  plane_version=PLANE_VERSION,
                  reg_names=list(probe.regressor_names))
    atomic_write(
        os.path.join(dset_dir, _SPEC_FILE),
        lambda fh: json.dump(record, fh, indent=1), mode="w",
    )
    return dset_dir


def write_shard(spec: DatasetSpec, shard_index: int,
                root: Optional[str] = None) -> Tuple[int, int]:
    """Generate and land one shard: fill the column memmap rows, flush,
    then publish the sentinel (atomic, CRCs inside) that makes the rows
    visible.  Emits a ``datagen.shard`` span + shard counters when a
    trace is bound.  Returns the (lo, hi) landed."""
    from tsspark_tpu_torch.obs import context as obs
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

    t0 = time.time()
    dset_dir = create_columns(spec, root)
    lo, hi = shard_ranges(spec)[shard_index]
    batch = generate_rows(spec, lo, hi)
    cols = batch_columns(batch)
    for f, rows in cols.items():
        mm = open_memmap(
            os.path.join(dset_dir, f"{f}.npy"), mode="r+", lo=lo, hi=hi
        )
        mm[lo:hi] = rows
        mm.flush()
        del mm
    _land_shard_sentinel(dset_dir, lo, hi, cols)
    # Regenerating a shard that LANDED deltas (repair of a torn shard,
    # a re-produced range) must replay them: base bytes + the landed
    # patch stream IS the shard's committed state, and the sentinel
    # above only certifies the base.
    if _replay_deltas(dset_dir, lo, hi):
        _reland_sentinel_from_disk(dset_dir, lo, hi)
    dur = time.time() - t0
    if obs.active():
        obs.record("datagen.shard", t0, dur, lo=lo, hi=hi,
                   generator=spec.generator, rows=hi - lo)
        METRICS.counter("tsspark_datagen_shards_total").inc()
        METRICS.counter("tsspark_datagen_rows_total").inc(hi - lo)
        METRICS.histogram("tsspark_datagen_shard_seconds").observe(dur)
    return lo, hi


def finalize(spec: DatasetSpec, root: Optional[str] = None) -> str:
    """Write the manifest once sentinel coverage is complete (atomic,
    LAST — the manifest is the warm-cache hit marker, so it must never
    exist before every shard it certifies)."""
    dset_dir = dataset_dir(spec, root)
    missing = missing_shards(spec, root)
    if missing:
        raise RuntimeError(
            f"cannot finalize {dset_dir}: shards {missing} not landed"
        )
    record = dict(read_spec(dset_dir) or spec.to_dict(),
                  complete=True, unix=round(time.time(), 3),
                  shards=[list(r) for r in shard_ranges(spec)])
    atomic_write(
        os.path.join(dset_dir, _MANIFEST_FILE),
        lambda fh: json.dump(record, fh, indent=1), mode="w",
    )
    return dset_dir


def import_batch(batch: SeriesBatch, name: str,
                 root: Optional[str] = None,
                 shard_rows: int = DEFAULT_SHARD_ROWS) -> str:
    """Bring an externally-loaded batch (e.g. the real M5 CSVs via
    ``data.loaders``) under the same manifest: columns + sentinels +
    manifest, keyed ``import:<name>`` with a content hash so a changed
    file set never aliases a stale cache."""
    cols = batch_columns(batch)
    content = hashlib.md5()
    for f in sorted(cols):
        content.update(np.ascontiguousarray(cols[f]).tobytes())
    n, t = cols["y"].shape
    spec = DatasetSpec(
        generator=f"import:{name}_{content.hexdigest()[:8]}",
        n_series=n, n_timesteps=t, seed=0, shard_rows=shard_rows,
    )
    dset_dir = dataset_dir(spec, root)
    if is_complete(dset_dir):
        return dset_dir
    os.makedirs(dset_dir, exist_ok=True)
    atomic_write(
        os.path.join(dset_dir, "ds.npy"),
        lambda fh: np.save(fh, np.asarray(batch.ds, np.float64)),
    )
    fields = sorted(cols)
    for f in fields:
        path = os.path.join(dset_dir, f"{f}.npy")
        _prealloc_column(path, cols[f].shape)
        mm = open_memmap(path, mode="r+")
        mm[:] = cols[f]
        mm.flush()
        del mm
    record = dict(spec.to_dict(), fields=fields,
                  fingerprint=dataset_fingerprint(),
                  plane_version=PLANE_VERSION,
                  reg_names=list(batch.regressor_names),
                  series_ids=[str(s) for s in batch.series_ids])
    atomic_write(
        os.path.join(dset_dir, _SPEC_FILE),
        lambda fh: json.dump(record, fh, indent=1), mode="w",
    )
    for lo, hi in shard_ranges(spec):
        _land_shard_sentinel(dset_dir, lo, hi,
                             {f: cols[f][lo:hi] for f in fields})
    return finalize(spec, root)


# ---------------------------------------------------------------------------
# readers / coverage
# ---------------------------------------------------------------------------


def is_complete(dset_dir: str) -> bool:
    """Warm-cache hit test: a readable manifest marked complete."""
    try:
        with open(os.path.join(dset_dir, _MANIFEST_FILE)) as fh:
            return bool(json.load(fh).get("complete"))
    except (OSError, ValueError):
        return False


def landed_ranges(dset_dir: str) -> List[Tuple[int, int]]:
    """Merged row coverage of all landed shard sentinels (a torn
    sentinel — its writer died inside atomic_write, which cannot happen,
    but a hand-corrupted one can — reads as absent)."""
    spans = []
    for p in glob.glob(os.path.join(dset_dir, "shardok_*.json")):
        stem = os.path.basename(p)[len("shardok_"):-len(".json")]
        try:
            lo, hi = (int(x) for x in stem.split("_"))
        except ValueError:
            continue
        spans.append((lo, hi))
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def covers(ranges: Sequence[Tuple[int, int]], lo: int, hi: int) -> bool:
    """True when [lo, hi) lies inside the merged coverage."""
    for r_lo, r_hi in ranges:
        if r_lo <= lo and hi <= r_hi:
            return True
    return False


def ready_coverage(data_dir: str,
                   n_series: Optional[int] = None
                   ) -> Optional[List[Tuple[int, int]]]:
    """The row ranges a consumer may read RIGHT NOW, or None when no
    gating applies (a plain spill dir, or a complete dataset): the fit
    worker's claim filter during overlapped ingestion."""
    if read_spec(data_dir) is None:
        return None  # not a plane dataset: everything is ready
    if is_complete(data_dir):
        return None
    ranges = landed_ranges(data_dir)
    if n_series is not None:
        ranges = [(lo, min(hi, n_series)) for lo, hi in ranges
                  if lo < n_series]
    return ranges


def ingest_pending(data_dir: str, n_series: Optional[int] = None) -> bool:
    """True while a plane dataset's sentinel coverage is still
    incomplete (the consumer should wait — or self-produce — rather
    than give up)."""
    spec_rec = read_spec(data_dir)
    if spec_rec is None or is_complete(data_dir):
        return False
    total = spec_rec.get("n_series", 0)
    if n_series is not None:
        total = min(total, n_series)
    merged = landed_ranges(data_dir)
    covered = sum(min(hi, total) - lo for lo, hi in merged if lo < total)
    return covered < total


def missing_shards(spec: DatasetSpec,
                   root: Optional[str] = None) -> List[int]:
    dset_dir = dataset_dir(spec, root)
    landed = landed_ranges(dset_dir)
    return [
        i for i, (lo, hi) in enumerate(shard_ranges(spec))
        if not covers(landed, lo, hi)
    ]


def produce_next_missing(data_dir: str) -> bool:
    """Self-healing consumer path: generate + land the first missing
    shard inline (deterministic — identical bytes to whatever the dead
    ingest driver would have written).  Returns False when nothing is
    missing or the dir is not a generated plane dataset."""
    rec = read_spec(data_dir)
    if rec is None or str(rec.get("generator", "")).startswith("import:"):
        return False
    spec = DatasetSpec.from_dict(rec)
    root = os.path.dirname(os.path.abspath(data_dir))
    if os.path.abspath(dataset_dir(spec, root)) \
            != os.path.abspath(data_dir):
        # The dir was keyed under a different fingerprint (source edited
        # since creation): self-producing would land shards in a NEW dir
        # this consumer never reads — decline instead.
        return False
    missing = missing_shards(spec, root=root)
    if not missing:
        return False
    write_shard(spec, missing[0], root=root)
    return True


def verify_shard(dset_dir: str, lo: int, hi: int) -> bool:
    """Deep integrity check of one landed shard: recompute the column
    CRCs over the memmap rows and compare with the sentinel's.  False
    means the shard is torn/corrupt (reject it; :func:`repair` re-lands
    it)."""
    try:
        with open(_sentinel_path(dset_dir, lo, hi)) as fh:
            sentinel = json.load(fh)
    except (OSError, ValueError):
        return False
    crcs = sentinel.get("crc") or {}
    for f, want in crcs.items():
        path = os.path.join(dset_dir, f"{f}.npy")
        try:
            mm = attach_array(path)
        except (OSError, ValueError):
            return False
        got = zlib.crc32(np.ascontiguousarray(mm[lo:hi]).tobytes())
        del mm
        if got != int(want):
            return False
    return True


# ---------------------------------------------------------------------------
# row-advance deltas (the always-on ingest half of the delta-refit loop)
# ---------------------------------------------------------------------------
#
# Production data never stops arriving: after a dataset's base shards
# land, later observations arrive for a SUBSET of series.  A delta lands
# those advances under the same spec-first / sentinel-last discipline as
# base shards:
#
#   1. ``deltapatch_<seq>.npz``  — the patch payload (changed rows, the
#      new trailing-window values), atomic + CRC-stamped FIRST: the
#      patch file, not the memmap mutation, is the replayable record;
#   2. the column memmaps are mutated IN PLACE for the changed rows'
#      trailing window (unchanged rows' bytes never move — the
#      block-seeded layout stays bitwise-stable for everything that did
#      not advance);
#   3. every touched shard's ``shardok_*`` sentinel is RE-LANDED with
#      fresh CRCs (``verify_shard`` stays truthful over advanced rows);
#   4. ``deltaok_<seq>.json`` lands atomically LAST — the unit of
#      visibility.  ``advanced_since(stamp)`` unions the changed rows of
#      every delta with seq > stamp, which is exactly the claim set the
#      delta-refit engine plans over.
#
# Crash story: a writer killed before step 4 leaves either (a) a patch
# with untouched memmaps — invisible, the re-land with the same seq
# overwrites it whole — or (b) mutated memmaps whose sentinels were not
# all re-landed — ``verify_shard`` rejects those shards and ``repair``
# regenerates base bytes THEN replays the landed (visible) patch stream
# (``write_shard`` replays deltas after base regeneration), so a torn
# delta can never half-appear.  Replays read the patch files, so
# re-application is bitwise idempotent.

#: Trailing timesteps one synthetic delta revises per advanced series.
DELTA_WINDOW = 8

_DELTA_OK_PREFIX = "deltaok_"
_DELTA_PATCH_PREFIX = "deltapatch_"


def _delta_ok_path(dset_dir: str, seq: int) -> str:
    return os.path.join(dset_dir, f"{_DELTA_OK_PREFIX}{seq:06d}.json")


def _delta_patch_path(dset_dir: str, seq: int) -> str:
    return os.path.join(dset_dir, f"{_DELTA_PATCH_PREFIX}{seq:06d}.npz")


def delta_records(dset_dir: str) -> List[Dict]:
    """Landed delta records, ascending by seq (a torn/corrupt record
    reads as absent — its delta never became visible)."""
    out = []
    for p in glob.glob(os.path.join(dset_dir, f"{_DELTA_OK_PREFIX}*.json")):
        try:
            with open(p) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and isinstance(rec.get("seq"), int):
            out.append(rec)
    return sorted(out, key=lambda r: r["seq"])


def delta_seq(dset_dir: str) -> int:
    """The dataset's delta coverage stamp: highest landed delta seq
    (0 = base data only).  Snapshots publish the stamp they were fitted
    at; ``advanced_since`` turns two stamps into a claim set."""
    recs = delta_records(dset_dir)
    return recs[-1]["seq"] if recs else 0


def delta_seq_since(dset_dir: str, after: int) -> int:
    """The coverage stamp by INCREMENTAL probe: walk the visibility
    records upward from a stamp already known landed.  Seqs are
    contiguous (allocation is serialized under the delta flock), so an
    always-on poller pays O(new deltas) per poll instead of the full
    glob+parse of every historical record ``delta_seq`` does — the
    difference between an idle daemon stat-ing one missing file per
    tick and re-reading a 10k-record history 20 times a second."""
    seq = max(0, int(after))
    while os.path.exists(_delta_ok_path(dset_dir, seq + 1)):
        seq += 1
    return seq


def _load_patch(dset_dir: str, seq: int) -> Optional[Dict]:
    """One delta's patch payload (CRC-verified), or None when absent or
    corrupt — a visible delta whose patch cannot be read is treated as
    corruption by ``repair`` (the shard CRCs catch the bytes)."""
    path = _delta_patch_path(dset_dir, seq)
    try:
        z = np.load(path)
    except Exception:
        # Not just OSError/ValueError: a torn zip surfaces as
        # BadZipFile.
        return None
    try:
        if not integrity.verify_arrays(z):
            return None
        return {
            "rows": np.asarray(z["rows"], np.int64),
            "window": int(z["window"]),
            "y": np.asarray(z["y"], np.float32),
            "mask": np.asarray(z["mask"], np.float32),
        }
    except Exception:
        return None  # truncated member mid-read: same as corrupt
    finally:
        z.close()


def delta_patch(dset_dir: str, seq: int) -> Optional[Dict]:
    """Public read of ONE visible delta's full patch payload
    (CRC-verified ``{"rows", "window", "y", "mask"}``), or None when
    absent/corrupt -- the anomaly scorer's feed,
    which needs the landed values themselves, not just the row set."""
    return _load_patch(dset_dir, int(seq))


def delta_rows(dset_dir: str, seq: int) -> Optional[np.ndarray]:
    """The changed-row set of ONE visible delta (the arrival-model feed
    for the always-on scheduler's speculation), or None when the patch
    is unreadable — callers wanting claim-set semantics must use
    :func:`advanced_since`, which widens unreadable patches instead of
    dropping them."""
    patch = _load_patch(dset_dir, int(seq))
    return None if patch is None else patch["rows"]


def advanced_since(dset_dir: str, coverage_stamp: int) -> np.ndarray:
    """Sorted unique series rows that advanced after ``coverage_stamp``
    — the delta-refit engine's changed set.  A snapshot fitted at stamp
    S is stale exactly for ``advanced_since(dir, S)``; refit cost scales
    with this set, not with the fleet.

    A VISIBLE delta whose patch file is unreadable must not silently
    shrink the set: the memmaps already carry its bytes (sentinels were
    re-landed over them), so dropping the record would leave those
    series stale FOREVER once a later refit advances the stamp.  The
    record's touched shards widen to their full row ranges instead —
    over-refit is correct, under-refit is permanent staleness."""
    import warnings

    rec0 = read_spec(dset_dir) or {}
    n = int(rec0.get("n_series", 0))
    shard_rows_n = int(rec0.get("shard_rows", DEFAULT_SHARD_ROWS))
    rows: List[np.ndarray] = []
    for rec in delta_records(dset_dir):
        if rec["seq"] <= int(coverage_stamp):
            continue
        patch = _load_patch(dset_dir, rec["seq"])
        if patch is not None:
            rows.append(patch["rows"])
            continue
        warnings.warn(
            f"{dset_dir}: delta {rec['seq']} is visible but its patch "
            "file is unreadable; widening its touched shards to whole "
            "row ranges so the advanced series are refit rather than "
            "left permanently stale",
            RuntimeWarning,
        )
        for si in rec.get("shards") or ():
            lo = int(si) * shard_rows_n
            hi = min(lo + shard_rows_n, n)
            rows.append(np.arange(lo, hi, dtype=np.int64))
    if not rows:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(rows))


def _apply_patch(dset_dir: str, n_timesteps: int, patch: Dict,
                 lo: Optional[int] = None,
                 hi: Optional[int] = None) -> int:
    """Scatter one patch into the column memmaps (optionally restricted
    to rows in [lo, hi) — the repair replay path).  Returns the number
    of rows written.  Absolute values, so re-application is bitwise
    idempotent."""
    rows, w = patch["rows"], patch["window"]
    if lo is not None:
        keep = (rows >= lo) & (rows < hi)
        rows = rows[keep]
        y_vals, m_vals = patch["y"][keep], patch["mask"][keep]
    else:
        y_vals, m_vals = patch["y"], patch["mask"]
    if not len(rows):
        return 0
    t0 = n_timesteps - w
    for f, vals in (("y", y_vals), ("mask", m_vals)):
        mm = open_memmap(os.path.join(dset_dir, f"{f}.npy"), mode="r+")
        mm[rows, t0:] = vals
        mm.flush()
        del mm
    return int(len(rows))


def _replay_deltas(dset_dir: str, lo: int, hi: int) -> int:
    """Re-apply every VISIBLE delta's rows inside [lo, hi) in seq order
    (base regeneration just rolled them back).  Returns rows replayed."""
    rec0 = read_spec(dset_dir)
    if rec0 is None:
        return 0
    n = 0
    for rec in delta_records(dset_dir):
        patch = _load_patch(dset_dir, rec["seq"])
        if patch is not None:
            n += _apply_patch(dset_dir, int(rec0["n_timesteps"]), patch,
                              lo=lo, hi=hi)
    return n


def _reland_sentinel_from_disk(dset_dir: str, lo: int, hi: int) -> None:
    """Re-land one shard's sentinel with CRCs recomputed from the
    memmaps' CURRENT bytes (the post-delta state)."""
    rec = read_spec(dset_dir) or {}
    cols = {}
    for f in rec.get("fields") or ("mask", "y"):
        mm = attach_array(os.path.join(dset_dir, f"{f}.npy"))
        cols[f] = np.ascontiguousarray(mm[lo:hi])
        del mm
    _land_shard_sentinel(dset_dir, lo, hi, cols)


def _rows_covered(ranges: Sequence[Tuple[int, int]],
                  rows: np.ndarray) -> np.ndarray:
    """Vectorized membership of each row in the merged coverage: one
    searchsorted over the range starts instead of a per-row Python
    ``covers`` scan (a 30% churn at 1M series is 300k rows on the
    latency-measured land path)."""
    if not len(ranges):
        return np.zeros(len(rows), bool)
    starts = np.asarray([r[0] for r in ranges], np.int64)
    ends = np.asarray([r[1] for r in ranges], np.int64)
    idx = np.searchsorted(starts, rows, side="right") - 1
    ok = idx >= 0
    ok[ok] = rows[ok] < ends[idx[ok]]
    return ok


@contextlib.contextmanager
def delta_lock(data_dir: str, shared: bool = False):
    """The landers' advisory lock on ``.delta.lock`` (the JAX package's
    file): a lander holds it exclusively from its seq allocation to its
    visibility record.  A reader that must see the plane exactly as of
    one ``delta_seq`` (a refit plan's detect and its spill: a lander
    scatters its rows into the memmaps before its record) holds it
    shared, which holds every lander off meanwhile."""
    import fcntl

    lock = open(os.path.join(data_dir, ".delta.lock"), "a")
    try:
        fcntl.flock(lock, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()


def land_delta(data_dir: str, rows, y_tail,
               mask_tail=None) -> Dict:
    """Land one row-advance delta: new trailing-window observations for
    the series in ``rows`` (absolute row indices; ``y_tail`` is
    ``(len(rows), window)``).  Patch first, memmap scatter, touched
    sentinels re-landed, visibility record LAST — see the section
    comment for the crash story.  Returns the landed delta record.

    Landers serialize on an advisory flock for the whole
    seq-allocation -> visibility-record window: deltas are NOT
    deterministic racers like base shards (two landers allocating the
    same seq would have the last ``deltaok`` rename swallow the
    loser's record whole — its rows scattered into the memmaps but
    never claimable, the permanent-staleness failure mode)."""
    # Degradation-ladder backpressure: below the pause-ingest headroom
    # threshold a lander fails fast (BackpressureError) instead of
    # racing the reaper for the last bytes on the device.
    gate_ingest(data_dir)
    rec = read_spec(data_dir)
    if rec is None:
        raise ValueError(f"{data_dir} is not a plane dataset")
    n, t_len = int(rec["n_series"]), int(rec["n_timesteps"])
    rows = np.unique(np.asarray(rows, np.int64))
    y_tail = np.asarray(y_tail, np.float32)
    if y_tail.ndim != 2 or y_tail.shape[0] != len(rows):
        raise ValueError(
            f"y_tail {y_tail.shape} does not match {len(rows)} rows"
        )
    w = int(y_tail.shape[1])
    if w > t_len or len(rows) and (rows[0] < 0 or rows[-1] >= n):
        raise ValueError("delta rows/window outside the dataset grid")
    covered = _rows_covered(landed_ranges(data_dir), rows)
    if not covered.all():
        bad = rows[~covered][:5].tolist()
        raise ValueError(
            f"rows {bad} have not landed; deltas only advance landed "
            "rows"
        )
    if mask_tail is None:
        mask_tail = np.ones_like(y_tail)
    with delta_lock(data_dir):
        seq = delta_seq(data_dir) + 1
        patch = {
            "rows": rows, "window": np.asarray(w),
            "y": y_tail, "mask": np.asarray(mask_tail, np.float32),
        }
        atomic_write(
            _delta_patch_path(data_dir, seq),
            lambda fh: np.savez(fh, **integrity.stamp(patch)),
        )
        _apply_patch(data_dir, t_len, {
            "rows": rows, "window": w, "y": y_tail,
            "mask": np.asarray(mask_tail, np.float32),
        })
        shard_rows_n = int(rec.get("shard_rows", DEFAULT_SHARD_ROWS))
        touched = np.unique(rows // shard_rows_n).tolist()
        for si in touched:
            lo, hi = si * shard_rows_n, min((si + 1) * shard_rows_n, n)
            _reland_sentinel_from_disk(data_dir, lo, hi)
        record = {
            "seq": seq, "n_changed": int(len(rows)), "window": w,
            "shards": touched, "unix": round(time.time(), 3),
            "pid": os.getpid(),
        }
        atomic_write(
            _delta_ok_path(data_dir, seq),
            lambda fh: json.dump(record, fh), mode="w",
        )
    from tsspark_tpu_torch.obs import context as obs
    if obs.active():
        obs.record("datagen.delta", time.time(), 0.0, seq=seq,
                   n_changed=int(len(rows)), window=w)
    return record


def land_synthetic_delta(data_dir: str, frac: float,
                         window: int = DELTA_WINDOW,
                         seed: int = 0,
                         rows=None) -> Dict:
    """Synthesize one advance event: a seeded ``frac`` of the fleet
    gains a revised trailing window (current values + a small seeded
    drift — the warm-start-friendly shape of real late-arriving data).
    The changed-row choice and the perturbation are deterministic in
    (dataset key, next seq, seed); the landed patch file is the
    replayable record either way.  ``rows`` pins the advancing series
    explicitly (``frac`` is then ignored) -- a freshness bench uses a
    hot-biased row stream so the scheduler's arrival model has a real
    per-series cadence to learn."""
    rec = read_spec(data_dir)
    if rec is None:
        raise ValueError(f"{data_dir} is not a plane dataset")
    n, t_len = int(rec["n_series"]), int(rec["n_timesteps"])
    w = min(int(window), t_len)
    seq = delta_seq(data_dir) + 1
    key = zlib.crc32(
        f"{rec.get('generator')}:{rec.get('seed')}:{seq}:{seed}".encode()
    )
    rng = np.random.default_rng([int(rec.get("seed", 0)), seq, seed, key])
    if rows is not None:
        rows = np.unique(np.asarray(rows, np.int64))
        if not len(rows):
            raise ValueError("explicit rows must be non-empty")
    else:
        k = max(1, int(round(float(frac) * n))) if frac > 0 else 0
        if k == 0:
            raise ValueError("frac too small: no series would advance")
        rows = np.sort(rng.choice(n, size=min(k, n), replace=False))
    y_mm = attach_array(os.path.join(data_dir, "y.npy"))
    cur = np.asarray(y_mm[rows, t_len - w:], np.float32)
    del y_mm
    drift = rng.normal(0.0, 0.05, cur.shape).astype(np.float32)
    scale = np.maximum(np.abs(cur), 1.0)
    y_tail = cur + drift * scale
    return land_delta(data_dir, rows, y_tail)


def repair(spec: DatasetSpec, root: Optional[str] = None,
           deep: bool = True) -> List[Tuple[int, int]]:
    """Re-land every missing or (with ``deep``) CRC-failing shard and
    drop a stale manifest first so a corrupt dataset can never keep its
    warm-hit marker.  Returns the ranges rewritten."""
    dset_dir = dataset_dir(spec, root)
    bad: List[Tuple[int, int]] = []
    ranges = shard_ranges(spec)
    for i, (lo, hi) in enumerate(ranges):
        landed = covers(landed_ranges(dset_dir), lo, hi)
        if landed and (not deep or verify_shard(dset_dir, lo, hi)):
            continue
        bad.append((lo, hi))
        try:
            os.remove(os.path.join(dset_dir, _MANIFEST_FILE))
        except OSError as e:
            # No manifest to drop is the common case; a disk refusing
            # the unlink must not let a corrupt dataset keep its
            # warm-hit marker silently.
            if not is_missing(e):
                reraise_classified(e)
        write_shard(spec, i, root)
    if bad and not missing_shards(spec, root):
        finalize(spec, root)
    return bad


def open_batch(dset_dir: str, mmap: bool = True) -> SeriesBatch:
    """Read a COMPLETE dataset as a SeriesBatch of memmap columns (the
    warm path: zero generation, zero copies until a consumer slices)."""
    if not is_complete(dset_dir):
        raise FileNotFoundError(
            f"{dset_dir} has no complete plane manifest (cold cache? "
            "run ensure()/ingest first)"
        )
    rec = read_spec(dset_dir) or {}
    mode = "r" if mmap else None
    load = lambda f: attach_array(os.path.join(dset_dir, f"{f}.npy"),
                                  mmap_mode=mode)
    fields = rec.get("fields") or ["mask", "y"]
    ids = rec.get("series_ids")
    if ids is None:
        ids = datasets.dataset_ids(
            rec.get("generator", "m5"), 0, int(rec.get("n_series", 0))
        )
    else:
        ids = np.asarray(ids)
    return SeriesBatch(
        ds=np.load(os.path.join(dset_dir, "ds.npy")),
        y=load("y"), mask=load("mask"), series_ids=ids,
        regressors=load("reg") if "reg" in fields else None,
        cap=load("cap") if "cap" in fields else None,
        regressor_names=tuple(rec.get("reg_names") or ()),
    )


#: A dataset untouched this long is reaped by the cold-path sweep: the
#: datagen fingerprint is part of every key, so each data-package edit
#: strands the previous keys' full-size dirs forever otherwise.
STALE_DATASET_S = 7 * 24 * 3600.0


def sweep_stale_datasets(root: Optional[str] = None,
                         max_age_s: float = STALE_DATASET_S) -> int:
    """Remove dataset dirs whose NEWEST file mtime is older than
    ``max_age_s`` (an age-gated reaper: a
    dir any producer or landing shard touched recently is live).  Runs
    on the cold ingest path only — warm hits never pay the scan.
    Unlinking under a concurrent reader is safe: its mmap keeps the
    bytes until unmapped.  Returns the count removed."""
    import shutil

    root = root or default_root()
    removed = 0
    try:
        entries = [os.path.join(root, n) for n in os.listdir(root)]
    except OSError as e:
        if is_missing(e):
            return 0  # no cache root yet: nothing to sweep
        reraise_classified(e)
    now = time.time()
    for d in entries:
        if not os.path.isdir(d):
            continue
        try:
            newest = max(
                (os.path.getmtime(p) for p in
                 glob.glob(os.path.join(d, "**"), recursive=True)),
                default=os.path.getmtime(d),
            )
        except OSError as e:
            if is_missing(e):
                continue  # a racer removed the dir mid-scan
            reraise_classified(e)
        if now - newest > max_age_s:
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
    return removed


def ensure(spec: DatasetSpec, root: Optional[str] = None,
           processes: int = 0) -> str:
    """The front door: return the dataset dir, ingesting first when the
    cache misses (``processes`` > 1 fans shard generation out to a
    process pool via :mod:`tsspark_tpu_torch.data.ingest`).  Emits cache
    hit/miss counters into the obs registry."""
    from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS

    dset_dir = dataset_dir(spec, root)
    if is_complete(dset_dir):
        METRICS.counter("tsspark_datagen_cache_hits_total").inc()
        return dset_dir
    METRICS.counter("tsspark_datagen_cache_misses_total").inc()
    from tsspark_tpu_torch.data import ingest

    return ingest.run_ingest(spec, root=root, processes=processes)
