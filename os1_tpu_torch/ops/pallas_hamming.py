"""The Hamming table kernel for Hopper: ``csrc/hamming.cu``, bound by ctypes.

Counterpart of ``os1_tpu/ops/pallas_hamming.py::hamming_matrix_pallas``. The
CUDA source is built at first use by :mod:`.cuda_build`; nothing is built or
imported from CUDA while this module is imported.

:func:`hamming_matrix_cuda` launches the kernel for CUDA tensors and raises on
anything it does not take; the plain version is ``ops.hamming.hamming_matrix``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary

LIBRARY = KernelLibrary("hamming.cu", {"hamming_table_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]})


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
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        LIBRARY.launch("hamming_table_launch", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                       n, m, stream)
    hamming_matrix_cuda.launches += 1
    return out


hamming_matrix_cuda.launches = 0
