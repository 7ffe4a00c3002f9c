"""Kernel bank: the serve tier's cold-start cost paid at publish.

The port's counterpart of the JAX package's AOT program bank.  There, a
cold replica's first request paid the ``forecast_jit`` compile ladder,
and the bank moved those compiles to publish time through JAX's
persistent compilation cache.  In the port the cold cost is the kernel
library: its ``nvcc`` build (a minute or more, every ``csrc/*.cu`` for
``sm_90a``) and its load.  So the bank is a directory that holds the
built library of the current source digest:

* :func:`build_bank` (called at publish, ``ReplicaPool.activate``)
  makes sure the library of the current digest is in the bank
  directory (``$TSSPARK_AOT_CACHE_DIR``): present, copied from this
  process's own build, or compiled there.  It writes ``aot_bank.json``
  (atomic) keyed by config fingerprint, shape ladder and library digest,
  and is idempotent across flips of the same shape.
* :func:`arm` / :func:`arm_from_env` point this process's kernel
  library at the bank (``kernels.build.use_dir``) when the manifest
  matches the current digest and the library file is there, so a cold
  replica loads a built library instead of building one.
* :func:`warm_ladder` launches each (width, horizon-bucket) shape of the
  ladder once, inside a replica, when the pool sends ``warm``: the
  library's load and each shape's first launch happen before traffic.

A CUDA graph (the closest analogue of a compiled program) lives in one
process and cannot be handed to another, so the bank holds the library,
not graphs.  The bank is an ACCELERATOR, never a correctness
dependency: a missing or stale bank leaves the library where it was (the
replica builds or loads it as before) and says so in an event.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.parallel.sharding import next_pow2
from tsspark_tpu_torch.utils.atomic import atomic_write

__all__ = [
    "AOT_CACHE_ENV", "AOT_MANIFEST", "DEFAULT_WIDTHS",
    "cache_dir_from_env", "arm", "arm_from_env", "shape_ladder",
    "build_bank", "read_manifest", "warm_ladder",
]

#: The shared bank directory contract: set it and every process
#: (publisher, front, replicas: children inherit the env) builds into /
#: loads from the same directory.
AOT_CACHE_ENV = "TSSPARK_AOT_CACHE_DIR"

#: Bank manifest (written into the bank dir, atomically).
AOT_MANIFEST = "aot_bank.json"

#: Dispatch widths the engine's compaction ladder produces for hot
#: traffic (``compacted_width`` floor .. a typical materialize chunk).
#: Widths above the snapshot's row count are skipped.
DEFAULT_WIDTHS = (8, 16, 32, 64, 128, 256)


def cache_dir_from_env() -> Optional[str]:
    """The configured bank directory, or None when unset."""
    return os.environ.get(AOT_CACHE_ENV) or None


def read_manifest(dirpath: str) -> Optional[Dict]:
    """The bank manifest in ``dirpath``, or None (absent/torn)."""
    try:
        with open(os.path.join(dirpath, AOT_MANIFEST)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _bank_state(dirpath: str) -> Tuple[Optional[Dict], Optional[str]]:
    """``(manifest, None)`` for a usable bank, else ``(manifest, why)``."""
    from tsspark_tpu_torch.kernels import build

    have = read_manifest(dirpath)
    if have is None:
        return None, "no manifest"
    if have.get("digest") != build.digest():
        return have, (f"stale: bank digest {have.get('digest')} != "
                      f"sources {build.digest()}")
    if not os.path.exists(os.path.join(dirpath, str(have.get("library")))):
        return have, "library file missing"
    return have, None


def arm(dirpath: str) -> Dict:
    """Point this process's kernel library at the bank in ``dirpath``
    when it holds the current digest's library; otherwise leave the
    library where it was and record why (``aotbank.stale`` event).
    Returns ``{"armed": bool, "dir", "reason"}``."""
    from tsspark_tpu_torch.kernels import build

    dirpath = os.path.abspath(dirpath)
    _, why = _bank_state(dirpath)
    if why is not None:
        obs.event("aotbank.stale", dir=dirpath, reason=why)
        return {"armed": False, "dir": dirpath, "reason": why}
    try:
        build.use_dir(dirpath)
    except RuntimeError as e:  # the library was loaded before arming
        obs.event("aotbank.stale", dir=dirpath, reason=str(e))
        return {"armed": False, "dir": dirpath, "reason": str(e)}
    obs.event("aotbank.armed", dir=dirpath)
    return {"armed": True, "dir": dirpath, "reason": None}


def arm_from_env() -> Optional[Dict]:
    """Arm the bank from ``$TSSPARK_AOT_CACHE_DIR`` when set (the
    replica's and the daemon's entry hook).  None when unset."""
    d = cache_dir_from_env()
    return arm(d) if d else None


def shape_ladder(n_series: int,
                 horizons: Sequence[int],
                 widths: Sequence[int] = DEFAULT_WIDTHS
                 ) -> List[Tuple[int, int]]:
    """The (width, horizon-bucket) pairs of the serve tier's hot
    dispatches: the engine pads widths up ``compacted_width``'s pow-2
    ladder and horizons up ``max(8, next_pow2(h))``."""
    from tsspark_tpu_torch.serve.fplane import bucket_ladder

    cap = next_pow2(max(int(n_series), 1))
    ws = sorted({int(w) for w in widths if int(w) <= cap} or {cap})
    return [(w, hb) for w in ws for hb in bucket_ladder(horizons)]


def build_bank(snap, backend, *, dirpath: Optional[str] = None,
               horizons: Sequence[int] = (7, 14, 28),
               widths: Sequence[int] = DEFAULT_WIDTHS,
               fingerprint: Optional[str] = None) -> Optional[Dict]:
    """Make sure the bank in ``dirpath`` (default: the env contract; no
    dir configured -> no-op, returns None) holds the library of the
    current source digest, and record the manifest: config fingerprint
    (default: ``backend.config``'s), the shape ladder of ``snap``'s row
    count, the library digest.  Idempotent: an up-to-date manifest whose
    library is present returns ``status="present"``."""
    from tsspark_tpu_torch.kernels import build
    from tsspark_tpu_torch.utils.checkpoint import config_fingerprint

    dirpath = dirpath or cache_dir_from_env()
    if not dirpath:
        return None
    if fingerprint is None and getattr(backend, "config", None) is not None:
        fingerprint = config_fingerprint(backend.config)
    ladder = shape_ladder(len(np.asarray(snap.step)), horizons, widths)
    want = {"fingerprint": fingerprint,
            "ladder": [[w, hb] for w, hb in ladder],
            "digest": build.digest()}
    have, why = _bank_state(dirpath)
    if why is None and {k: have.get(k) for k in want} == want:
        return dict(have, status="present")
    t0 = time.time()
    lib = build.ensure_built(dirpath)
    manifest = dict(
        want,
        library=os.path.basename(lib["path"]),
        how=lib["how"],
        built_s=round(time.time() - t0, 3),
        unix=round(time.time(), 3),
    )
    atomic_write(os.path.join(dirpath, AOT_MANIFEST),
                 lambda fh: json.dump(manifest, fh, indent=1), mode="w")
    obs.event("aotbank.built", dir=dirpath, how=lib["how"],
              built_s=manifest["built_s"])
    return dict(manifest, status="built")


def warm_ladder(snap, backend, ladder: Sequence[Tuple[int, int]]) -> Dict:
    """Launch each (width, horizon-bucket) shape of ``ladder`` once: a
    ``width``-row gather of ``snap`` and the deterministic
    ``backend.predict`` over its future grid, exactly the engine's
    dispatch.  The outputs are discarded.  Returns the shapes launched
    and the seconds they took."""
    from tsspark_tpu_torch.serve.fplane import future_grid

    n_rows = len(np.asarray(snap.step))
    t0 = time.perf_counter()
    done = []
    for width, hb in ladder:
        idx = np.arange(min(int(width), n_rows))
        if width > len(idx):
            idx = np.concatenate(
                [idx, np.repeat(idx[:1], int(width) - len(idx))])
        state, step = snap.take(idx)
        backend.predict(state, future_grid(state, step, hb), num_samples=0)
        done.append([int(width), int(hb)])
    return {"shapes": done, "seconds": round(time.perf_counter() - t0, 4)}
