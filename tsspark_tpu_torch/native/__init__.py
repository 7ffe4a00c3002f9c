"""ctypes bindings for the native ingest/pivot engine (src/ingest.cpp).

A copy of the JAX package's ``native`` module, with the same C source,
the same results and the same numpy fallbacks.  The shared library is
compiled on first use with ``g++`` (the C ABI + ctypes keeps the binding
dependency-free) into the package's ignored build directory
``tsspark_tpu_torch/_build/``, keyed by a hash of the source, never next
to the source.  Everything degrades to numpy fallbacks when no compiler
is available, so the port never hard-requires the native path: it is
host ingest, a speedup, not a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "ingest.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so_path = os.path.join(BUILD_DIR, f"_ingest_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    # Compile to a private temp path, then atomically rename: a concurrent
    # process must never dlopen a partially written .so.
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", tmp_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, so_path)
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.bulk_pivot.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _f64p, _f64p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.bulk_pivot.restype = None
        lib.store_new.argtypes = [ctypes.c_int64]
        lib.store_new.restype = ctypes.c_void_p
        lib.store_free.argtypes = [ctypes.c_void_p]
        lib.store_series_count.argtypes = [ctypes.c_void_p]
        lib.store_series_count.restype = ctypes.c_int64
        lib.store_series_length.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.store_series_length.restype = ctypes.c_int64
        lib.store_append.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _i64p, _f64p, _f64p,
        ]
        lib.store_union_grid.argtypes = [
            ctypes.c_void_p, _i64p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.store_union_grid.restype = ctypes.c_int64
        lib.store_materialize.argtypes = [
            ctypes.c_void_p, _i64p, ctypes.c_int64, _f64p,
            ctypes.c_int64, _f64p,
        ]
        lib.pstore_new.argtypes = [ctypes.c_int64]
        lib.pstore_new.restype = ctypes.c_void_p
        lib.pstore_free.argtypes = [ctypes.c_void_p]
        lib.pstore_size.argtypes = [ctypes.c_void_p]
        lib.pstore_size.restype = ctypes.c_int64
        lib.pstore_row_dim.argtypes = [ctypes.c_void_p]
        lib.pstore_row_dim.restype = ctypes.c_int64
        lib.pstore_update.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _i64p, _f64p,
        ]
        lib.pstore_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _i64p, _f64p, _u8p,
        ]
        lib.pstore_lookup.restype = ctypes.c_int64
        lib.pstore_export.argtypes = [ctypes.c_void_p, _i64p, _f64p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def bulk_pivot(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               b: int, t: int) -> np.ndarray:
    """Scatter long-format rows into a NaN-padded (b, t) float64 matrix.

    Last write wins on duplicate (row, col) — matching pandas
    drop_duplicates(keep="last") semantics in the frame layer.
    """
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    lib = _load()
    out = np.empty((b, t), np.float64)
    if lib is None:
        out.fill(np.nan)
        out[rows, cols] = vals
        return out
    lib.bulk_pivot(len(vals), rows, cols, vals, out.reshape(-1), b, t)
    return out


class HistoryStore:
    """Bounded per-series observation history (streaming 'absorb' path)."""

    def __init__(self, max_history: int = 4096):
        self.max_history = max_history
        self._lib = _load()
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.store_new(max_history))
        else:  # numpy fallback: dict of (days, values) arrays
            self._py: dict = {}

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.store_free(self._handle)
            self._handle = None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.store_series_count(self._handle))
        return len(self._py)

    def series_length(self, sid: int) -> int:
        if self._lib is not None:
            return int(self._lib.store_series_length(self._handle, int(sid)))
        d = self._py.get(int(sid))
        return 0 if d is None else len(d[0])

    def append(self, sids: np.ndarray, days: np.ndarray, vals: np.ndarray
               ) -> None:
        sids = np.ascontiguousarray(sids, np.int64)
        days = np.ascontiguousarray(days, np.float64)
        vals = np.ascontiguousarray(vals, np.float64)
        if self._lib is not None:
            self._lib.store_append(self._handle, len(sids), sids, days, vals)
            return
        for sid in np.unique(sids):
            m = sids == sid
            d_new, v_new = days[m], vals[m]
            old = self._py.get(int(sid))
            if old is not None:
                d_new = np.concatenate([old[0], d_new])
                v_new = np.concatenate([old[1], v_new])
            # stable sort + keep last duplicate
            order = np.argsort(d_new, kind="stable")
            d_s, v_s = d_new[order], v_new[order]
            keep = np.ones(len(d_s), bool)
            keep[:-1] = d_s[1:] != d_s[:-1]
            d_s, v_s = d_s[keep], v_s[keep]
            self._py[int(sid)] = (d_s[-self.max_history:],
                                  v_s[-self.max_history:])

    def union_grid(self, sids: np.ndarray) -> np.ndarray:
        sids = np.ascontiguousarray(sids, np.int64)
        if self._lib is not None:
            n = self._lib.store_union_grid(self._handle, sids, len(sids), None)
            grid = np.empty(n, np.float64)
            if n:
                self._lib.store_union_grid(
                    self._handle, sids, len(sids),
                    grid.ctypes.data_as(ctypes.c_void_p),
                )
            return grid
        parts = [self._py[int(s)][0] for s in sids if int(s) in self._py]
        if not parts:
            return np.empty(0, np.float64)
        return np.unique(np.concatenate(parts))

    def materialize(self, sids: np.ndarray, grid: np.ndarray) -> np.ndarray:
        """(B, T) float64 with NaN where a series has no observation."""
        sids = np.ascontiguousarray(sids, np.int64)
        grid = np.ascontiguousarray(grid, np.float64)
        b, t = len(sids), len(grid)
        if self._lib is not None:
            out = np.empty((b, t), np.float64)
            self._lib.store_materialize(
                self._handle, sids, b, grid, t, out.reshape(-1)
            )
            return out
        out = np.full((b, t), np.nan)
        for i, sid in enumerate(sids):
            rec = self._py.get(int(sid))
            if rec is None:
                continue
            idx = np.searchsorted(grid, rec[0])
            ok = (idx < t) & (grid[np.minimum(idx, t - 1)] == rec[0])
            out[i, idx[ok]] = rec[1][ok]
        return out


class ParamTable:
    """Fixed-width float64 rows keyed by int64 id (bulk upsert/gather).

    Double precision because rows carry absolute-time scaling meta
    (``ds_start`` in epoch days ~2e4): float32 quantizes hourly/minute
    warm-start alignment to ~5-minute granularity.

    The native backing store for the streaming warm-start ParamStore: one
    micro-batch update/lookup is two memcpy-bound C calls instead of a
    Python loop over series.  Falls back to a vectorized numpy/dict
    implementation when no compiler is available.
    """

    def __init__(self, row_dim: int):
        self.row_dim = int(row_dim)
        self._lib = _load()
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.pstore_new(self.row_dim))
        else:
            self._idx: dict = {}          # id -> row number
            self._rows: list = []         # list of np.float64 rows

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.pstore_free(self._handle)
            self._handle = None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.pstore_size(self._handle))
        return len(self._idx)

    def update(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.ascontiguousarray(ids, np.int64)
        rows = np.ascontiguousarray(rows, np.float64)
        if rows.shape != (len(ids), self.row_dim):
            raise ValueError(
                f"rows shape {rows.shape} != ({len(ids)}, {self.row_dim})"
            )
        if self._lib is not None:
            self._lib.pstore_update(self._handle, len(ids), ids,
                                    rows.reshape(-1))
            return
        for i, sid in enumerate(ids):
            k = int(sid)
            if k in self._idx:
                self._rows[self._idx[k]] = rows[i].copy()
            else:
                self._idx[k] = len(self._rows)
                self._rows.append(rows[i].copy())

    def lookup(self, ids: np.ndarray):
        """Returns (rows (n, row_dim) float64 zero-filled on miss, found (n,) bool)."""
        ids = np.ascontiguousarray(ids, np.int64)
        n = len(ids)
        out = np.empty((n, self.row_dim), np.float64)
        found = np.empty(n, np.uint8)
        if self._lib is not None:
            self._lib.pstore_lookup(self._handle, n, ids, out.reshape(-1),
                                    found)
            return out, found.astype(bool)
        for i, sid in enumerate(ids):
            row = self._idx.get(int(sid))
            found[i] = row is not None
            out[i] = self._rows[row] if row is not None else 0.0
        return out, found.astype(bool)

    def export(self):
        """All (ids (N,), rows (N, row_dim)) pairs, insertion-ordered."""
        n = len(self)
        ids = np.empty(n, np.int64)
        rows = np.empty((n, self.row_dim), np.float64)
        if self._lib is not None:
            if n:
                self._lib.pstore_export(self._handle, ids, rows.reshape(-1))
            return ids, rows
        for sid, row in self._idx.items():
            ids[row] = sid
            rows[row] = self._rows[row]
        return ids, rows
