"""Build and bind the hand-written sources of ``csrc/``.

Each CUDA source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``_build/`` beside the package, named by a
hash of the source and the flags, and loaded with ``ctypes``. Every entry
point is a plain C function that launches on the stream it is given and
returns ``cudaGetLastError()`` (0 = launched). Host C++ sources (``*.cpp``)
take the same road with ``g++``; their entry points return 0 on success.
Nothing is built while a module is imported, and a failed build raises.

Each kernel wrapper counts its launches with :func:`count_launch`: in total
(``fn.launches``) and per thread (``fn.launches_by_thread``, by thread name),
exact when the tracker and the worker threads launch at once.
"""
from __future__ import annotations

import ctypes
import contextlib
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
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")


_COUNT_LOCK = threading.Lock()


def count_launch(fn) -> None:
    """Add one launch to a wrapper's counters (see the module docstring)."""
    name = threading.current_thread().name
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_thread[name] = fn.launches_by_thread.get(name, 0) + 1


def reset_launches(fn) -> None:
    """Set a wrapper's counters to 0."""
    with _COUNT_LOCK:
        fn.launches = 0
        fn.launches_by_thread = {}


@contextlib.contextmanager
def launches_apart(fns):
    """Count the launches made inside the block apart: on exit the dict it
    yields holds each wrapper's launches by name, and the wrappers' own
    counters are set back to what they were before the block."""
    with _COUNT_LOCK:
        saved = [(fn, fn.launches, dict(fn.launches_by_thread)) for fn in fns]
    inside = {}
    try:
        yield inside
    finally:
        with _COUNT_LOCK:
            for fn, n, by_thread in saved:
                inside[fn.__name__] = fn.launches - n
                fn.launches, fn.launches_by_thread = n, by_thread


def load_libraries(cuda: bool = True) -> dict:
    """Build (if needed) and load every ``csrc/`` library the pipeline uses,
    the compilers side by side: the host libraries, and with ``cuda`` the
    CUDA kernels. Returns {source: build seconds, or None if it was already
    built}."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..vocab import native as bow_native
    from . import pallas_hamming, patches

    libs = [bow_native.LIBRARY, native.LIBRARY]
    if cuda:
        libs += [pallas_hamming.LIBRARY, patches.LIBRARY]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))
    return {os.path.basename(lib.source): lib.build_seconds for lib in libs}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    return cand


class KernelLibrary:
    """One ``csrc/`` source, its build and its ctypes binding.

    ``functions`` maps each exported C function to its argument types
    (``ctypes.c_void_p`` for pointers and the stream, ``ctypes.c_int`` for
    ints); every function returns an int error code. ``compiler`` returns the
    compiler's path (nvcc by default, g++ for host sources)."""

    def __init__(self, source: str, functions: dict, compiler=_nvcc, flags=NVCC_FLAGS):
        self.source = os.path.join(_PKG, "csrc", source)
        self.functions = functions
        self.compiler = compiler
        self.flags = flags
        self.build_seconds = None  # nvcc wall time in this process (None: cached)
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            with open(self.source, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(self.flags).encode()).hexdigest()[:16]
            stem = os.path.splitext(os.path.basename(self.source))[0]
            path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                compiler = self.compiler()
                proc = subprocess.run([compiler, *self.flags, "-o", tmp, self.source],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                                       f"{self.source}:\n{proc.stderr}")
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
            raise RuntimeError(f"{name} failed: error code {err}")
