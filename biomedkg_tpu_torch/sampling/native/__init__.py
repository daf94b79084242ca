"""ctypes bindings for the native sampling functions (sampler.cpp).

Counterpart of biomedkg_tpu/sampling/native/__init__.py. The library is
built with g++ at first use into ``native/build/`` (gitignored), under a
name that carries a hash of the source, so an edited source is rebuilt.
This is host code: every caller has a vectorised numpy fallback, taken when
the build fails (memoised, so a missing toolchain costs one attempt) or
when ``BIOMEDKG_NO_NATIVE`` is set, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sampler.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")
_CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
              "-pthread"]

_lib = None
_build_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsampler-{sys.platform}-{digest}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: concurrent builds race safely
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("BIOMEDKG_NO_NATIVE"):
        return None
    so = _library_path()
    if not os.path.exists(so) and not _build(so):
        _build_failed = True
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _build_failed = True
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.build_csr.argtypes = [i64p, i64p, i32p, ctypes.c_int64,
                              ctypes.c_int64, i64p, i64p, i32p, i64p]
    lib.build_csr.restype = None
    lib.random_walk.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_uint64, i64p]
    lib.random_walk.restype = None
    lib.induced_subgraph.restype = ctypes.c_int64
    lib.induced_subgraph.argtypes = [i64p, i64p, i32p, i64p, ctypes.c_int64,
                                     i64p, i64p, i64p, i32p, ctypes.c_int64]
    lib.sample_neighbors.restype = ctypes.c_int64
    lib.sample_neighbors.argtypes = [i64p, i64p, i32p, i64p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_uint64, i64p,
                                     i64p, i32p]
    _lib = lib
    return _lib


def i64(arr: np.ndarray):
    """Pointer to an int64 C-contiguous array. The caller holds a
    reference to ``arr`` for the duration of the native call."""
    if arr.dtype != np.int64 or not arr.flags["C_CONTIGUOUS"]:
        raise TypeError(f"want a C-contiguous int64 array, got {arr.dtype}")
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def i32(arr: np.ndarray):
    if arr.dtype != np.int32 or not arr.flags["C_CONTIGUOUS"]:
        raise TypeError(f"want a C-contiguous int32 array, got {arr.dtype}")
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
