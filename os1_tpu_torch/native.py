"""Host helpers in C++ (``csrc/native.cpp``): the distinctive descriptor of
each map point (``MapStore.update_point_derived`` calls it on every keyframe
and after every correction), the RGB -> grey conversion and a frame ring
buffer. Port of ``os1_tpu/native/`` (its BoW loader, descent and trainer are
``vocab/native.py``).

The library is built with g++ at first use into ``_build/`` and bound with
ctypes through ``ops/cuda_build.KernelLibrary``. There is no fallback: if it
cannot be built or a call fails, the call raises. :func:`distinctive_plain`
is the numpy form of :func:`point_distinctive_desc`, kept for the tests.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .ops.cuda_build import GXX_FLAGS, KernelLibrary, _gxx

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64

LIBRARY = KernelLibrary("native.cpp", {
    "ring_create": [_I64, _I64, ctypes.c_int, _P],
    "ring_destroy": [_P],
    "ring_close": [_P],
    "ring_push": [_P, _P, _I64, _P],
    "ring_pop": [_P, _P, _I64, _P],
    "ring_size": [_P, _P],
    "rgb_u8_to_gray_f32": [_P, _P, _I64],
    "point_distinctive_desc": [_P, _P, _I64, _I32, _P],
}, compiler=_gxx, flags=GXX_FLAGS)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def point_distinctive_desc(descs: np.ndarray, live: np.ndarray) -> np.ndarray:
    """The distinctive descriptor's slot of each point
    (MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:227-293): among the
    live observations, the one with the least median Hamming distance to the
    others, the first on a tie. ``descs`` [n, M, 8] uint32, ``live`` [n, M]
    bool. Returns [n] int32: the slot, the only live one when there is one,
    -1 when there is none."""
    descs = np.ascontiguousarray(descs, np.uint32)
    live = np.ascontiguousarray(live, np.uint8)
    n, M = live.shape
    best = np.empty(n, np.int32)
    if n:
        LIBRARY.launch("point_distinctive_desc", _ptr(descs), _ptr(live), n, M, _ptr(best))
    return best


def distinctive_plain(descs: np.ndarray, live: np.ndarray) -> np.ndarray:
    """The numpy form of :func:`point_distinctive_desc` (the same slots).
    Pairwise Hamming by the popcount identity
    |a ^ b| = |a| + |b| - 2 a.b on unpacked bits, a [M, 256] product a point,
    and numpy's median over the live pairs."""
    n, M = live.shape
    bits = np.unpackbits(np.ascontiguousarray(descs, np.uint32).view(np.uint8)
                         .reshape(n, M, 32), axis=-1).astype(np.float32)  # [n, M, 256]
    ones = bits.sum(-1)  # [n, M]
    dot = np.einsum("nmb,nkb->nmk", bits, bits)
    d = (ones[:, :, None] + ones[:, None, :] - 2.0 * dot).astype(np.float64)
    d = np.where(live[:, :, None] & live[:, None, :], d, np.nan)
    # The diagonal is 0 on every row, so no row is all NaN (the rows of dead
    # slots are masked below).
    d[:, np.arange(M), np.arange(M)] = 0.0
    with np.errstate(all="ignore"):
        med = np.nanmedian(d, axis=2)  # [n, M]
    best = np.argmin(np.where(live, med, np.inf), axis=1)
    return np.where(live.any(axis=1), best, -1).astype(np.int32)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] float32 BT.601 luminance
    (0.299 R + 0.587 G + 0.114 B in float32)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), np.float32)
    LIBRARY.launch("rgb_u8_to_gray_f32", _ptr(rgb), _ptr(out), h * w)
    return out


class NativeRingBuffer:
    """Single-producer single-consumer frame ring buffer (the video thread's
    frame mailbox) of ``capacity`` frames of one shape and dtype. Lossless by
    default: ``push`` waits while it is full; ``realtime=True`` drops the
    oldest frame instead. ``close`` fails a waiting push and lets ``pop``
    drain what is left."""

    def __init__(self, capacity: int, frame_shape, dtype=np.uint8, realtime: bool = False):
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.slot_bytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
        h = _P()
        LIBRARY.launch("ring_create", capacity, self.slot_bytes, int(realtime), ctypes.byref(h))
        self._h = h

    def push(self, frame: np.ndarray, timeout_ms: int = 1000) -> bool:
        """Queue a copy of ``frame``; False if it timed out or was closed."""
        frame = np.ascontiguousarray(frame, dtype=self.dtype)
        if frame.nbytes != self.slot_bytes:
            raise ValueError(f"a frame of {frame.nbytes} bytes in slots of {self.slot_bytes}")
        ok = _I32()
        LIBRARY.launch("ring_push", self._h, _ptr(frame), timeout_ms, ctypes.byref(ok))
        return bool(ok.value)

    def pop(self, timeout_ms: int = 1000):
        """The oldest frame, or None if none came within ``timeout_ms`` (or
        the buffer is closed and empty)."""
        out = np.empty(self.frame_shape, self.dtype)
        ok = _I32()
        LIBRARY.launch("ring_pop", self._h, _ptr(out), timeout_ms, ctypes.byref(ok))
        return out if ok.value else None

    def __len__(self) -> int:
        n = _I64()
        LIBRARY.launch("ring_size", self._h, ctypes.byref(n))
        return int(n.value)

    def close(self) -> None:
        LIBRARY.launch("ring_close", self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None and h.value:
            LIBRARY.launch("ring_destroy", h)
            self._h = None
