"""The Hamming table kernel for Hopper: ``csrc/hamming.cu``, bound by ctypes.

Counterpart of ``os1_tpu/ops/pallas_hamming.py::hamming_matrix_pallas`` (the
one TPU kernel of the reference). The CUDA source is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/`` beside
the package, named by a hash of the source, and loaded with ``ctypes``.
Nothing is built or imported from CUDA while this module is imported.

:func:`hamming_matrix_cuda` launches the kernel for CUDA tensors and raises on
anything it does not take; the plain version is ``ops.hamming.hamming_matrix``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "hamming.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: cached)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hamming kernel cannot be built")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libhamming_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        lib.hamming_table_launch.restype = ctypes.c_int
        lib.hamming_table_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def _check(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"hamming_matrix_cuda: {name} must be a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"hamming_matrix_cuda: {name} must be int32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 8:
        raise ValueError(f"hamming_matrix_cuda: {name} must be [*, 8], got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"hamming_matrix_cuda: {name} must be contiguous")


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed [N, 8] x [M, 8] int32 (CUDA) -> [N, M] int32 Hamming distances.

    Launches on the current stream without synchronising. Any N, M >= 0."""
    _check(a, "a")
    _check(b, "b")
    if a.device != b.device:
        raise ValueError("hamming_matrix_cuda: a and b are on different devices")
    n, m = a.shape[0], b.shape[0]
    if n >= 32 * 65535:
        raise ValueError(f"hamming_matrix_cuda: N={n} exceeds the grid limit")
    lib = load_library()
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.hamming_table_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                       n, m, stream)
    if err != 0:
        raise RuntimeError(f"hamming_table_kernel launch failed: cudaError_t {err}")
    hamming_matrix_cuda.launches += 1
    return out


hamming_matrix_cuda.launches = 0
