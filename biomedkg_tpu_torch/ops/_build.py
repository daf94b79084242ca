"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``csrc/build/``
(gitignored). The file name carries a hash of the source, of the headers
it includes from ``csrc/`` (``#include "name"``) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded. The
library is bound through ``ctypes``. Every failure raises: no nvcc, a
compile error, a library that does not load. Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_text(path: str, seen=None) -> bytes:
    """The bytes of ``path`` and of every header it includes by a quoted
    name, found beside it, each once, in the order of first inclusion."""
    seen = set() if seen is None else seen
    path = os.path.abspath(path)
    if path in seen:
        return b""
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    parts = [text]
    for name in _LOCAL_INCLUDE.findall(text):
        parts.append(source_text(
            os.path.join(os.path.dirname(path), name.decode()), seen))
    return b"".join(parts)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "cannot build the CUDA kernels")


class CudaLibrary:
    """One ``csrc/`` source as a loaded ctypes library.

    ``signatures`` maps each exported C function to its ``argtypes``; every
    function returns the ``cudaError_t`` of its launch as an int.
    ``build_seconds`` and ``build_log`` (nvcc's ptxas report) describe this
    process's build, or stay None / "" when the library was already built.
    """

    def __init__(self, source: str, signatures: Dict[str, List]):
        self.source = os.path.join(CSRC, source)
        self.signatures = signatures
        self._lib = None
        self.build_seconds = None
        self.build_log = ""
        self.library_path = None

    def lib(self):
        if self._lib is None:
            self._lib = self._load()
        return self._lib

    def built_path(self) -> str:
        """Where the library of the source as it stands now is built."""
        digest = hashlib.sha256(
            source_text(self.source)
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")

    def _load(self):
        so = self.built_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                    capture_output=True, text=True, timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building "
                        f"{self.source}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(so)
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.library_path = so
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def stream_of(t) -> int:
    """The handle of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
