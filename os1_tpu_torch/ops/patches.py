"""Keypoint patch gather (P1) and BRIEF sample gather (P2) of the extractor.

Counterparts of the TPU kernels in ``profile_patch.py``:
``make_pallas_patches`` (P1, a DMA gather of 32x32 keypoint windows from the
level stack) and ``pallas_take`` (P2, the row-wise gather of BRIEF samples
from the flattened patches). Each has a plain PyTorch version
(:func:`extract_patches`, :func:`sample_patches`) and a wrapper of its
hand-written kernel in ``csrc/patches.cu`` (:func:`extract_patches_cuda`,
:func:`sample_patches_cuda`), which counts its launches and raises on a
tensor it does not take. :func:`keypoint_patches` and :func:`brief_samples`
are what the extractor calls: the kernel for a CUDA tensor, the plain version
for a CPU one. Both are gathers, so kernel and plain version agree exactly.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary

PS = 32  # window side
HALF = 15  # window start = center - 15

LIBRARY = KernelLibrary("patches.cu", {
    "patch_gather_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "sample_gather_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})


def extract_patches(stack: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """Plain P1: [L, H, W] float32 stack, [N, 3] int32 keypoints (level, y, x)
    -> [N, 32, 32] float32 windows. Starts clamp into the stack as
    ``lax.dynamic_slice`` clamps them, so any keypoint reads in bounds."""
    L, H, W = stack.shape
    k = kps.long()
    lvl = torch.clamp(k[:, 0], 0, L - 1)
    y0 = torch.clamp(k[:, 1] - HALF, 0, H - PS)
    x0 = torch.clamp(k[:, 2] - HALF, 0, W - PS)
    r = torch.arange(PS, device=stack.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return stack[lvl[:, None, None], rows, cols]


def sample_patches(patches: torch.Tensor, abin: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain P2: [N, 1024] float32 patches, [N] int32 orientation bins,
    [T, S] int32 patch offsets -> [N, S] float32 samples
    ``patches[n, table[abin[n]]]``, each rounded to bf16 (the extractor's
    rounding of the sampled intensities)."""
    idx = table[abin.long()].long()
    return torch.gather(patches, 1, idx).to(torch.bfloat16).to(torch.float32)


def _check(x: torch.Tensor, fn: str, name: str, dtype, ndim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{fn}: {name} must have {ndim} dimensions, got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def extract_patches_cuda(stack: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """P1 kernel: as :func:`extract_patches`, on CUDA tensors only. Launches
    on the current stream without synchronising."""
    fn = "extract_patches_cuda"
    _check(stack, fn, "stack", torch.float32, 3)
    _check(kps, fn, "kps", torch.int32, 2)
    L, H, W = stack.shape
    if kps.shape[1] != 3 or kps.device != stack.device:
        raise ValueError(f"{fn}: kps must be [N, 3] on the stack's device")
    if H < PS or W < PS:
        raise ValueError(f"{fn}: the stack must be at least {PS}x{PS}")
    n = kps.shape[0]
    out = torch.empty((n, PS, PS), dtype=torch.float32, device=stack.device)
    if n == 0:
        return out
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        LIBRARY.launch("patch_gather_launch", stack.data_ptr(), kps.data_ptr(), out.data_ptr(),
                       n, L, H, W, stream)
    extract_patches_cuda.launches += 1
    return out


extract_patches_cuda.launches = 0


def sample_patches_cuda(patches: torch.Tensor, abin: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """P2 kernel: as :func:`sample_patches`, on CUDA tensors only. Every
    ``abin`` must index a row of ``table`` and every table entry a patch
    element (the extractor's bins and rotated offsets always do). Launches on
    the current stream without synchronising."""
    fn = "sample_patches_cuda"
    _check(patches, fn, "patches", torch.float32, 2)
    _check(abin, fn, "abin", torch.int32, 1)
    _check(table, fn, "table", torch.int32, 2)
    n, S = patches.shape[0], table.shape[1]
    if patches.shape[1] != PS * PS or abin.shape[0] != n:
        raise ValueError(f"{fn}: patches must be [N, {PS * PS}] and abin [N]")
    if not (abin.device == table.device == patches.device):
        raise ValueError(f"{fn}: patches, abin and table are on different devices")
    out = torch.empty((n, S), dtype=torch.float32, device=patches.device)
    if n == 0 or S == 0:
        return out
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream(patches.device).cuda_stream
        LIBRARY.launch("sample_gather_launch", patches.data_ptr(), abin.data_ptr(),
                       table.data_ptr(), out.data_ptr(), n, S, stream)
    sample_patches_cuda.launches += 1
    return out


sample_patches_cuda.launches = 0


def keypoint_patches(stack: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """P1 for the extractor: the kernel for a CUDA stack, the plain version
    for a CPU one."""
    if stack.is_cuda:
        return extract_patches_cuda(stack.contiguous(), kps.to(torch.int32).contiguous())
    return extract_patches(stack, kps)


def brief_samples(patches: torch.Tensor, abin: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P2 for the extractor: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    if patches.is_cuda:
        return sample_patches_cuda(patches.contiguous(), abin.to(torch.int32).contiguous(),
                                   table.to(torch.int32).contiguous())
    return sample_patches(patches, abin, table)
