"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``_build/`` beside the package, named by a
hash of the source and the flags, and loaded with ``ctypes``. Every entry
point is a plain C function that launches on the stream it is given and
returns ``cudaGetLastError()`` (0 = launched). Nothing is built while a module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """One ``csrc/`` source, its build and its ctypes binding.

    ``functions`` maps each exported C function to its argument types
    (``ctypes.c_void_p`` for pointers and the stream, ``ctypes.c_int`` for
    ints); every function returns an int error code."""

    def __init__(self, source: str, functions: dict):
        self.source = os.path.join(_PKG, "csrc", source)
        self.functions = functions
        self.build_seconds = None  # nvcc wall time in this process (None: cached)
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            with open(self.source, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            stem = os.path.splitext(os.path.basename(self.source))[0]
            path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
                os.replace(tmp, path)
                self.build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(path)
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            self._lib = lib
            return lib

    def launch(self, name: str, *args) -> None:
        """Call one entry point; raise if the launch was refused."""
        err = getattr(self.load(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: cudaError_t {err}")
