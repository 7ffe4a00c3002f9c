"""Versioned, atomic parameter registry: the serving side's source of truth.

The port's copy of the JAX package's registry, on the same on-disk
format, so each package serves versions the other published.  A fit
PUBLISHES a ``FitState`` snapshot; the serving engine READS whichever
version is ACTIVE.  Activation is one atomic manifest rename, so a
reader sees the old version or the new one, never a mix, and a bad
deploy rolls back with one more rename.

Layout under the registry root::

    manifest.json            # atomic index: active/previous + catalog
    v000001/state.npz|.json  # the archival utils.checkpoint snapshot
    v000001/snap_spec.json, snapcol_*.npy, snapok.json
                             # the memmap column plane (serve/snapplane)

Snapshot files land first, the manifest that names them last.  The
manifest pins the config fingerprint and ``NUMERICS_REV``, so a reader
refuses snapshots fitted under another parameter layout or numerics
regime.

``snapshot_format`` ("both" by default, or ``$TSSPARK_SNAPSHOT_FORMAT``)
says what ``publish`` lands: the column plane and the npz ("both"), the
plane alone ("mmap") or the npz alone ("npz"); ``load`` prefers the
plane and attaches it lazily (memmap leaves, searchsorted lookup), falls
back to the same version's npz when the plane is torn, and only then to
the previous version.  ``publish_delta`` lands a plane-only version as a
copy-forward of a base version with only the refit rows replaced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import NUMERICS_REV, ProphetConfig
from tsspark_tpu_torch.models.prophet.model import FitState
from tsspark_tpu_torch.orchestrate import normalize_series_ids
from tsspark_tpu_torch.io import atomic_write, sweep_stale_temps
from tsspark_tpu_torch.resilience import integrity
from tsspark_tpu_torch.serve import snapplane
from tsspark_tpu_torch.utils import checkpoint as ckpt

_MANIFEST = "manifest.json"
_FORMAT = 1

#: Snapshot formats a registry publishes/reads.  "both" (default) lands
#: the memmap column plane AND the archival npz per version; "mmap"
#: skips the npz (bulk publishes); "npz" pins the private-heap format.
SNAPSHOT_FORMATS = ("both", "mmap", "npz")


class RegistryError(RuntimeError):
    """Structured registry failure: corrupt manifest, incompatible
    snapshot, unknown version.  ``reason`` is a stable machine-readable
    tag; the message carries the human detail."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


class SnapshotAbsent(Exception):
    """Internal control flow: the version dir has no snapshot plane
    (pre-plane publish) — fall through to the npz, no warning."""


def take_fitstate(state: FitState, idx: np.ndarray) -> FitState:
    """Row-gather of a FitState: a tensor ``theta`` on its own device, a
    numpy one (a memmap plane's) with numpy, the host float64 meta leaves
    and the diagnostics with numpy (a device gather would quantize
    ``ds_start``).  On a memmap snapshot the gather reads only the
    touched pages."""
    idx = np.asarray(idx, np.int64)
    take = lambda a: None if a is None else np.take(a, idx, axis=0)  # noqa: E731
    theta = state.theta
    return FitState(
        theta=(theta.index_select(
            0, torch.as_tensor(idx, device=theta.device)
        ) if isinstance(theta, torch.Tensor) else take(theta)),
        meta=type(state.meta)(*(take(a) for a in state.meta)),
        loss=take(state.loss),
        grad_norm=take(state.grad_norm),
        converged=take(state.converged),
        n_iters=take(state.n_iters),
        status=take(state.status),
    )


def _normalize_step(step: Optional[np.ndarray], n: int) -> np.ndarray:
    if step is None:
        step = np.ones(n)
    return np.where(np.asarray(step, np.float64) > 0, step, 1.0)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One loaded registry version: the batch FitState plus the id->row
    index and per-series cadence the read path needs.

    Two sources, one read API: ``source="npz"``, the archival checkpoint
    in this process's heap with an eager id->row dict; ``source="mmap"``,
    a lazy view over the version's snapshot plane (``serve.snapplane``):
    every FitState leaf and the id index are read-only memmaps, and
    ``rows`` is a vectorized ``np.searchsorted`` against the publish-time
    sorted index (``row_of`` is None).

    ``fallback_from``: set when this snapshot was served because the
    ACTIVE version failed its integrity/load check (see
    ``ParamRegistry.load``) — the version that could not be loaded."""

    version: int
    state: FitState
    series_ids: Tuple[str, ...]           # or (n,) unicode memmap
    step: np.ndarray                      # (B,) median cadence, days
    row_of: Optional[Dict[str, int]] = None
    fallback_from: Optional[int] = None
    source: str = "npz"
    ids_sorted: Optional[np.ndarray] = None   # mmap: lexicographic ids
    id_order: Optional[np.ndarray] = None     # mmap: sorted pos -> row

    @classmethod
    def build(cls, version: int, state: FitState, series_ids,
              step: Optional[np.ndarray]) -> "Snapshot":
        ids = tuple(normalize_series_ids(series_ids).tolist())
        n = len(ids)
        return cls(version=version, state=state, series_ids=ids,
                   step=_normalize_step(step, n),
                   row_of=dict(zip(ids, range(n))))

    @classmethod
    def attach(cls, version: int, view: "snapplane.PlaneView"
               ) -> "Snapshot":
        """Lazy mmap snapshot over an attached plane view."""
        return cls(
            version=version, state=view.state, series_ids=view.ids,
            step=_normalize_step(view.extras.get("step"), view.n_series),
            row_of=None, source="mmap",
            ids_sorted=view.ids_sorted, id_order=view.id_order,
        )

    def rows(self, series_ids) -> Tuple[np.ndarray, List[str]]:
        """Row indices for ``series_ids`` + the ids this version lacks."""
        if self.row_of is not None:
            idx, missing = [], []
            for s in series_ids:
                i = self.row_of.get(str(s))
                (missing.append(str(s)) if i is None else idx.append(i))
            return np.asarray(idx, np.int64), missing
        q = normalize_series_ids(series_ids)
        n = len(self.ids_sorted)
        if len(q) == 0 or n == 0:
            return np.empty(0, np.int64), [str(s) for s in q]
        pos = np.minimum(np.searchsorted(self.ids_sorted, q), n - 1)
        found = self.ids_sorted[pos] == q
        idx = np.asarray(self.id_order[pos[found]], np.int64)
        missing = [str(s) for s in q[~found]]
        return idx, missing

    def take(self, idx: np.ndarray) -> Tuple[FitState, np.ndarray]:
        """(gathered FitState, gathered cadence) for row indices."""
        return take_fitstate(self.state, idx), np.take(self.step, idx)


class ParamRegistry:
    """Publish / activate / rollback fitted-parameter versions."""

    def __init__(self, root: str, config: ProphetConfig,
                 numerics_rev: int = NUMERICS_REV, strict: bool = True,
                 snapshot_format: Optional[str] = None):
        """``snapshot_format``: "both" (default) / "mmap" / "npz", what
        ``publish`` lands and ``load`` prefers (``SNAPSHOT_FORMATS``);
        defaults from ``$TSSPARK_SNAPSHOT_FORMAT``."""
        self.root = root
        self.config = config
        self.numerics_rev = int(numerics_rev)
        self.strict = strict
        fmt = (snapshot_format
               or os.environ.get("TSSPARK_SNAPSHOT_FORMAT") or "both")
        if fmt not in SNAPSHOT_FORMATS:
            raise ValueError(
                f"snapshot_format {fmt!r} not in {SNAPSHOT_FORMATS}"
            )
        self.snapshot_format = fmt
        self._listeners: List[Callable[[Optional[int]], None]] = []
        os.makedirs(root, exist_ok=True)
        # A publisher killed mid-snapshot orphans a pid-suffixed temp
        # inside its version dir; reap dead writers' orphans here.
        sweep_stale_temps(root, recursive=True)
        self._read_manifest()  # validate eagerly: fail at attach time

    @classmethod
    def open(cls, root: str, **kwargs) -> "ParamRegistry":
        """Attach to an existing registry, rebuilding the model config
        from the manifest."""
        path = os.path.join(root, _MANIFEST)
        try:
            with open(path) as fh:
                m = json.load(fh)
        except OSError:
            raise RegistryError("missing-manifest",
                                f"no registry at {root!r}")
        except ValueError as e:
            raise RegistryError("corrupt-manifest", f"{path}: {e}")
        if not isinstance(m, dict) or "config" not in m:
            raise RegistryError(
                "corrupt-manifest", f"{path}: no embedded model config"
            )
        config = ckpt._config_from_dict(m["config"])
        return cls(root, config, **kwargs)

    # -- manifest I/O ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, _MANIFEST)

    def _fresh_manifest(self) -> Dict:
        return {
            "format": _FORMAT,
            "fingerprint": ckpt.config_fingerprint(self.config),
            "numerics_rev": self.numerics_rev,
            "config": dataclasses.asdict(self.config),
            "active_version": None,
            "previous_version": None,
            "versions": {},
        }

    def _read_manifest(self) -> Dict:
        path = self._manifest_path()
        if not os.path.exists(path):
            return self._fresh_manifest()
        try:
            with open(path) as fh:
                m = json.load(fh)
        except ValueError as e:
            raise RegistryError("corrupt-manifest", f"{path}: {e}")
        if not isinstance(m, dict) or m.get("format") != _FORMAT:
            got = m.get("format") if isinstance(m, dict) else "?"
            raise RegistryError(
                "corrupt-manifest", f"{path}: format {got} != {_FORMAT}"
            )
        if self.strict:
            fp = ckpt.config_fingerprint(self.config)
            if m.get("fingerprint") != fp:
                raise RegistryError(
                    "fingerprint-mismatch",
                    f"registry was published under config fingerprint "
                    f"{m.get('fingerprint')}, reader has {fp}; pass "
                    "strict=False to force-attach",
                )
            if m.get("numerics_rev") != self.numerics_rev:
                raise RegistryError(
                    "numerics-rev-mismatch",
                    f"registry numerics_rev {m.get('numerics_rev')} != "
                    f"reader {self.numerics_rev}: parameters fitted under "
                    "a different numerics regime must be republished",
                )
        active = m.get("active_version")
        if active is not None and str(active) not in m.get("versions", {}):
            raise RegistryError(
                "corrupt-manifest",
                f"active_version {active} is not in the version catalog",
            )
        return m

    def _write_manifest(self, m: Dict) -> None:
        atomic_write(
            self._manifest_path(),
            lambda fh: json.dump(m, fh, indent=1),
            mode="w",
        )

    @contextlib.contextmanager
    def _locked(self):
        """Advisory exclusive lock serializing manifest read-modify-writes
        (two publishers must not allocate one version number); readers
        stay lock-free — the atomic replace gives them old-or-new."""
        fh = open(os.path.join(self.root, ".manifest.lock"), "a")
        try:
            fcntl.flock(fh, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
            fh.close()

    # -- queries ---------------------------------------------------------------

    def manifest_key(self) -> Optional[Tuple[int, int, int]]:
        """Cheap change detector for the manifest ((ino, mtime_ns, size),
        or None when no manifest exists yet): every manifest replace is an
        ``os.replace`` of a fresh temp file, so the inode changes on every
        flip.  Hot read paths stat this instead of re-parsing the JSON."""
        try:
            st = os.stat(self._manifest_path())
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted(
            int(v) for v in self._read_manifest()["versions"]
        ))

    def version_dir(self, version: int) -> str:
        """Absolute directory of a published version's snapshot files."""
        entry = self._read_manifest()["versions"].get(str(int(version)))
        if entry is None:
            raise RegistryError(
                "unknown-version",
                f"version {version} was never published",
            )
        return os.path.join(self.root, entry["path"])

    def active_version(self) -> Optional[int]:
        return self._read_manifest()["active_version"]

    # -- writes ----------------------------------------------------------------

    def _claim_version(self, m: Dict) -> Tuple[int, str]:
        """Allocate the next version number and claim its directory
        (under the manifest lock): a publisher that dies mid-write leaves
        an orphan dir the existence check skips, never a reused
        number."""
        version = max((int(v) for v in m["versions"]), default=0) + 1
        while os.path.exists(os.path.join(self.root, f"v{version:06d}")):
            version += 1
        vdir = f"v{version:06d}"
        os.makedirs(os.path.join(self.root, vdir))
        return version, vdir

    def _commit(self, version: int, entry: Dict, activate: bool) -> None:
        """Land ``version``'s catalog entry (and the active pointer) in
        the manifest, then notify the listeners."""
        with self._locked():
            m = self._read_manifest()
            m["versions"][str(version)] = entry
            if activate:
                m["previous_version"] = m["active_version"]
                m["active_version"] = version
            self._write_manifest(m)
        if activate:
            self._notify(version)

    def publish(self, state: FitState, series_ids,
                step: Optional[np.ndarray] = None,
                activate: bool = True,
                snapshot_format: Optional[str] = None,
                data_stamp: Optional[int] = None) -> int:
        """Persist one snapshot as the next version (snapshot files
        first, manifest last); optionally activate it.  Returns the new
        version number.

        The snapshot lands as the memmap column plane and/or the
        archival npz per ``snapshot_format`` (default: the registry's).
        ``data_stamp``: the data plane's delta coverage stamp this
        snapshot was fitted at, recorded in the manifest entry."""
        fmt = snapshot_format or self.snapshot_format
        if fmt not in SNAPSHOT_FORMATS:
            raise ValueError(
                f"snapshot_format {fmt!r} not in {SNAPSHOT_FORMATS}"
            )
        ids = normalize_series_ids(series_ids)
        if len(ids) != int(state.theta.shape[0]):
            raise ValueError(
                f"{len(ids)} series ids for {state.theta.shape[0]} "
                "state rows"
            )
        extras = {}
        if step is not None:
            extras["step"] = np.asarray(step, np.float64)
        # Lock only the version allocation and the manifest update, not
        # the snapshot serialization between them.
        with self._locked():
            version, vdir = self._claim_version(self._read_manifest())
        if fmt != "mmap":
            ckpt.save_state(
                os.path.join(self.root, vdir, "state"), state, self.config,
                series_ids=ids, extras=extras,
            )
        if fmt != "npz":
            snapplane.write_plane(
                os.path.join(self.root, vdir), state, ids, extras=extras,
                fingerprint=ckpt.config_fingerprint(self.config),
                numerics_rev=self.numerics_rev,
            )
        self._commit(version, {
            "path": vdir,
            "n_series": int(len(ids)),
            "published_unix": round(time.time(), 3),
            "formats": sorted({"both": ("mmap", "npz")}.get(fmt, (fmt,))),
            **({"data_stamp": int(data_stamp)}
               if data_stamp is not None else {}),
        }, activate)
        return version

    def publish_delta(self, sub_state: Optional[FitState], changed_rows,
                      *, base_version: Optional[int] = None,
                      step_sub: Optional[np.ndarray] = None,
                      data_stamp: Optional[int] = None,
                      activate: bool = True) -> int:
        """Delta publish: the next version as a copy-forward of
        ``base_version`` (default: the active one) with only
        ``changed_rows`` replaced by ``sub_state``'s refit rows
        (``snapplane.write_plane_delta``: unchanged rows are the base
        plane's bytes, untouched columns hardlink).  Delta versions are
        plane-only; a torn delta plane degrades down the active->previous
        chain like any plane-only version.  Returns the new version."""
        with self._locked():
            m = self._read_manifest()
            if base_version is None:
                base_version = m["active_version"]
            if base_version is None:
                raise RegistryError(
                    "no-active-version",
                    "delta publish needs a base version",
                )
            base_entry = m["versions"].get(str(int(base_version)))
            if base_entry is None:
                raise RegistryError(
                    "unknown-version",
                    f"delta base {base_version} was never published",
                )
            version, vdir = self._claim_version(m)
        base_vdir = os.path.join(self.root, base_entry["path"])
        if not snapplane.has_plane(base_vdir):
            raise RegistryError(
                "delta-base-missing-plane",
                f"version {base_version} has no snapshot plane; delta "
                "publish copy-forwards plane columns — republish the "
                "base with snapshot_format 'both' or 'mmap' first",
            )
        changed = np.unique(np.asarray(changed_rows, np.int64))
        extras_sub = None
        if step_sub is not None and len(changed):
            extras_sub = {"step": np.asarray(step_sub, np.float64)}
        snapplane.write_plane_delta(
            os.path.join(self.root, vdir), base_vdir, changed,
            sub_state, extras_sub=extras_sub,
            base_version=int(base_version), data_stamp=data_stamp,
            fingerprint=ckpt.config_fingerprint(self.config),
            numerics_rev=self.numerics_rev,
        )
        self._commit(version, {
            "path": vdir,
            "n_series": int(base_entry["n_series"]),
            "published_unix": round(time.time(), 3),
            "formats": ["mmap"],
            "delta_from": int(base_version),
            "n_changed": int(len(changed)),
            **({"data_stamp": int(data_stamp)}
               if data_stamp is not None else {}),
        }, activate)
        return version

    def delta_info(self, version: int) -> Optional[Dict]:
        """Delta-publish metadata of ``version`` (base version + the
        changed-row and changed-id sets), or None for a full publish."""
        m = self._read_manifest()
        entry = m["versions"].get(str(int(version)))
        if entry is None or entry.get("delta_from") is None:
            return None
        manifest = snapplane.read_delta_manifest(
            os.path.join(self.root, entry["path"])
        )
        if manifest is None:
            return None
        return dict(manifest, version=int(version))

    def version_stamp(self, version: int) -> int:
        """The data-plane delta coverage stamp ``version`` was fitted at
        (0 for versions published without one)."""
        entry = self._read_manifest()["versions"].get(str(int(version)))
        if entry is None:
            raise RegistryError(
                "unknown-version",
                f"version {version} was never published",
            )
        return int(entry.get("data_stamp") or 0)

    def activate(self, version: int) -> None:
        """Flip the active pointer to an already-published version."""
        with self._locked():
            m = self._read_manifest()
            if str(int(version)) not in m["versions"]:
                raise RegistryError(
                    "unknown-version",
                    f"version {version} was never published",
                )
            flipped = m["active_version"] != int(version)
            if flipped:
                m["previous_version"] = m["active_version"]
                m["active_version"] = int(version)
                self._write_manifest(m)
        if flipped:
            self._notify(int(version))

    def rollback(self) -> int:
        """Re-activate the previously active version (one level deep —
        the bad-deploy escape hatch).  Returns the version restored."""
        m = self._read_manifest()
        prev = m["previous_version"]
        if prev is None:
            raise RegistryError("no-rollback-target",
                                "no previously active version recorded")
        self.activate(prev)
        return prev

    # -- reads -----------------------------------------------------------------

    def load(self, version: Optional[int] = None,
             fallback: bool = True) -> Snapshot:
        """Load a version (default: the active one) as a Snapshot.

        The snapshot npz must pass its payload-CRC check before it is
        parsed.  When the ACTIVE version (``version=None``) fails that
        check and ``fallback`` is on, the previously active version — then
        the rest of the catalog, newest first — is served instead, with a
        warning and ``Snapshot.fallback_from`` set.  An explicitly
        requested version always raises."""
        m = self._read_manifest()
        requested = version
        if version is None:
            version = m["active_version"]
            if version is None:
                raise RegistryError("no-active-version",
                                    "nothing has been activated yet")
        try:
            return self._load_version(m, int(version))
        except RegistryError as e:
            if (requested is not None or not fallback
                    or e.reason != "corrupt-snapshot"):
                raise
            for v in self._fallback_candidates(m, int(version)):
                try:
                    snap = self._load_version(m, v)
                except RegistryError:
                    continue
                warnings.warn(
                    f"active registry version {version} failed its "
                    f"integrity/load check ({e}); serving last good "
                    f"version {v} — republish or rollback to clear",
                    RuntimeWarning,
                )
                return dataclasses.replace(snap,
                                           fallback_from=int(version))
            raise

    def _fallback_candidates(self, m: Dict, bad: int) -> List[int]:
        """The previously active version first, then the remaining catalog
        newest-first."""
        out: List[int] = []
        prev = m.get("previous_version")
        if prev is not None and int(prev) != bad:
            out.append(int(prev))
        for v in sorted((int(x) for x in m["versions"]), reverse=True):
            if v != bad and v not in out:
                out.append(v)
        return out

    def _load_version(self, m: Dict, version: int) -> Snapshot:
        entry = m["versions"].get(str(int(version)))
        if entry is None:
            raise RegistryError("unknown-version",
                                f"version {version} was never published")
        vdir = os.path.join(self.root, entry["path"])
        if self.snapshot_format != "npz":
            try:
                return self._load_plane(vdir, int(version), entry)
            except SnapshotAbsent:
                pass  # version predates the plane: npz is the format
            except RegistryError as e:
                # Plane torn: the same version's npz is the first
                # fallback, before the active->previous chain; when it is
                # missing or corrupt too, the plane's error is raised.
                try:
                    snap = self._load_npz(vdir, int(version), entry)
                except RegistryError:
                    raise e
                warnings.warn(
                    f"registry version {version}: snapshot plane failed "
                    f"its CRC sentinel ({e}); serving the archival npz "
                    "for this version — republish to restore the "
                    "one-copy mmap path",
                    RuntimeWarning,
                )
                return snap
        return self._load_npz(vdir, int(version), entry)

    def _load_plane(self, vdir: str, version: int,
                    entry: Dict) -> Snapshot:
        """Attach the version's memmap column plane as a lazy Snapshot
        (the CRC sweep inside ``snapplane.attach`` is the torn-shard
        gate)."""
        try:
            view = snapplane.attach(
                vdir, verify=True, expected_n=int(entry["n_series"])
            )
        except snapplane.SnapshotPlaneError as e:
            if e.reason == "absent":
                raise SnapshotAbsent(str(e))
            raise RegistryError(
                "corrupt-snapshot", f"version {version}: {e}"
            )
        fp = ckpt.config_fingerprint(self.config)
        if self.strict and view.fingerprint is not None \
                and view.fingerprint != fp:
            raise RegistryError(
                "corrupt-snapshot",
                f"version {version}: plane was published under config "
                f"fingerprint {view.fingerprint}, reader has {fp}",
            )
        return Snapshot.attach(version, view)

    def _load_npz(self, vdir: str, version: int,
                  entry: Dict) -> Snapshot:
        base = os.path.join(vdir, "state")
        if not integrity.verify_file(base + ".npz"):
            raise RegistryError(
                "corrupt-snapshot",
                f"version {version} at {base}.npz: payload CRC mismatch "
                "(torn or silently corrupted snapshot)",
            )
        try:
            state, ids, extras = ckpt.load_state(
                base, self.config, strict=self.strict, return_extras=True,
            )
        except (OSError, ValueError, KeyError) as e:
            raise RegistryError(
                "corrupt-snapshot", f"version {version} at {base}: {e}"
            )
        if ids is None or len(ids) != int(entry["n_series"]):
            raise RegistryError(
                "corrupt-snapshot",
                f"version {version}: snapshot carries "
                f"{0 if ids is None else len(ids)} series ids, manifest "
                f"says {entry['n_series']}",
            )
        return Snapshot.build(int(version), state, ids, extras.get("step"))

    # -- invalidation fan-out --------------------------------------------------

    def subscribe(self, fn: Callable[[Optional[int]], None]) -> None:
        """Call ``fn(new_active_version)`` after every in-process
        activation (engines invalidate their caches through this)."""
        self._listeners.append(fn)

    def _notify(self, version: Optional[int]) -> None:
        for fn in self._listeners:
            fn(version)
