"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into ONE
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, from the sources in the package, into
``tsspark_tpu_torch/_build/`` under a file lock; the library's name
carries a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged
tree loads what is there.  A failed build raises with
``nvcc``'s stderr.  Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_ull = ctypes.c_ulonglong
_f = ctypes.c_float

#: C signatures of the library's entry points (each returns the
#: ``cudaError_t`` of its launch as an int).
SIGNATURES = {
    "tsspark_forward": [
        _c, _c, _c, _c, _c, _ll, _c, _c, _c, _c,   # inputs
        _c, _c, _c, _c,                            # outputs
        _i, _i, _i, _i, _i, _i, _i,                # B T P ncp Fs R growth
        _c,                                        # stream
    ],
    "tsspark_loss": [
        _c, _c, _c, _c, _c, _c, _ll, _c, _c, _c,  # theta t y mask s xs xs_bstride xr ps mm
        _c, _c,                                    # f_out, g_out (or null)
        _i, _i, _i, _i, _i, _i, _i, _i,            # N B T P ncp Fs R growth
        _f, _f, _f, _f,                            # k m sigma cp prior scales
        _c,                                        # stream
    ],
    "tsspark_fan": [
        _c, _c, _c, _c, _c, _c, _c, _c, _ll, _c, _c, _c,  # theta dir ladder t y mask s xs bstride xr ps mm
        _c,                                        # out (K, B)
        _i, _i, _i, _i, _i, _i, _i,                # B T P ncp Fs R K
        _f, _f, _f, _f,                            # k m sigma cp prior scales
        _c,                                        # stream
    ],
    "tsspark_bands": [
        _c, _c, _c, _c, _c, _c, _c,                # t det add mult theta scale floor
        _c, _c, _c,                                # given draws (or null)
        _c,                                        # Philox row ids (or null)
        _ull, _f, _f,                              # seed q_lo q_hi
        _c, _c, _c, _c, _c,                        # outputs
        _c, _ll,                                   # scratch, its floats
        _i, _i, _i, _i, _i, _i,                    # B T P ncp S growth
        _c,                                        # stream
    ],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Wall seconds the last build (or load) took, and the ptxas report of
#: each source (registers, shared memory, spills).
build_seconds: Optional[float] = None
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME and os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "cannot be built"
    )


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(sources: List[str]) -> str:
    """Hash of the flags, the sources and every shared header: an edit to
    a header alone must rebuild the kernels that include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: List[str], lib_path: str) -> None:
    tag = os.path.basename(lib_path)[:-3]
    objs, procs = [], []
    for src in sources:
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)[:-3]}_{tag}.o"
        )
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    errors = []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        ptxas_log[os.path.basename(src)] = out + err
        if proc.returncode != 0:
            errors.append(f"{src}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path + f".tmp.{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode=arch=compute_90a,code=sm_90a",
         *objs, "-o", tmp],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        sources = _sources()
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(
            BUILD_DIR, f"libtsspark_kernels_{_digest(sources)}.so"
        )
        with open(os.path.join(BUILD_DIR, ".lock"), "a") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            try:
                if not os.path.exists(lib_path):
                    _compile(_nvcc(), sources, lib_path)
            finally:
                fcntl.flock(lock_fh, fcntl.LOCK_UN)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tsspark_forward_smem.argtypes = [_i, _i, _i, _i, _i, _i]
        lib.tsspark_forward_smem.restype = ctypes.c_longlong
        lib.tsspark_error_string.argtypes = [ctypes.c_int]
        lib.tsspark_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        what = library().tsspark_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {what} ({err})")
