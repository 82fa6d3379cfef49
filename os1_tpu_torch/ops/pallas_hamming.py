"""The Hamming kernels for Hopper: ``csrc/hamming.cu``, bound by ctypes.

Counterparts of ``os1_tpu/ops/pallas_hamming.py::hamming_matrix_pallas`` and
of what the JAX matchers do with its table. One tensor-core distance core
feeds two epilogues:

- :func:`hamming_matrix_cuda`, the distance table (plain version
  ``ops.hamming.hamming_matrix``);
- :func:`gated_match_cuda`, the gated best and second-best match of every row
  with the ratio test, which never writes the table (plain version
  :func:`gated_match`, the gate, argmin and ratio chain the matchers ran).

The CUDA source is built at first use by :mod:`.cuda_build`; nothing is built
while this module is imported. A wrapper launches its kernel for CUDA tensors
and raises on anything it does not take. Descriptors are packed int32
``[..., 8]`` (``ops.hamming``); batched arguments carry one leading batch
dimension B, and A's may be 1 (one A shared by every entry).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import hamming
from .cuda_build import KernelLibrary, count_launch, reset_launches

BIG = 1 << 20  # distance of a gated-out pair
MAX_COLUMNS = 1 << 22  # the fused kernel packs a column into 22 bits of its keys


class _MatchArgs(ctypes.Structure):
    """``MatchArgs`` of csrc/hamming.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "a", "b", "gate", "uv", "radius", "valid_a", "octave_a", "xy", "valid_b", "octave_b",
        "idx", "dist", "ok", "second")] + [("a_bstride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "batch", "n", "m", "lo", "hi", "dense", "use_window", "use_octave", "max_dist")] + [
        ("ratio", ctypes.c_float)]


LIBRARY = KernelLibrary("hamming.cu", {
    "hamming_table_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    "gated_match_launch": [ctypes.POINTER(_MatchArgs), ctypes.c_void_p],
})


class Top2(NamedTuple):
    """Per-row outcome of a gated match, each [B, N]."""

    idx: torch.Tensor  # int64 best column (lowest among equal minima; 0 if none passes)
    dist: torch.Tensor  # int32 best distance (BIG if no pair passes the gate)
    ok: torch.Tensor  # bool: dist <= max_dist and dist <= ratio * second (float32)
    second: torch.Tensor  # int32 minimum over every other column


# ------------------------------------------------------------------ plain --

def window_gate(xy_a, xy_b, radius, valid_a, valid_b) -> torch.Tensor:
    """[..., N, M] gate: B within ``radius`` (scalar or per-row [..., N]) of A
    (L_inf)."""
    r = torch.as_tensor(radius, dtype=xy_a.dtype, device=xy_a.device)
    if r.ndim >= 1:
        r = r[..., None]
    diff = torch.abs(xy_a[..., :, None, :] - xy_b[..., None, :, :])
    near = (diff[..., 0] <= r) & (diff[..., 1] <= r)
    return near & valid_a[..., :, None] & valid_b[..., None, :]


def octave_gate(octave_a, octave_b, lo: int = -1, hi: int = 1) -> torch.Tensor:
    """[..., N, M] gate: octave of B within [octave_a + lo, octave_a + hi]."""
    d = octave_b[..., None, :] - octave_a[..., :, None]
    return (d >= lo) & (d <= hi)


def gated_match(desc_a, desc_b, max_dist: int, ratio: float, gate=None, *, valid_a=None,
                valid_b=None, uv=None, radius=None, xy=None, octave_a=None, octave_b=None,
                lo: int = -1, hi: int = 1) -> Top2:
    """Plain version of :func:`gated_match_cuda`: the distance table, the gate
    (dense, or ``window_gate & octave_gate`` from its factors), the row argmin,
    the second minimum and the ratio test."""
    if gate is None:
        if uv is None:
            gate = valid_a[..., :, None] & valid_b[..., None, :]
        else:
            gate = window_gate(uv, xy, radius, valid_a, valid_b)
        if octave_a is not None:
            gate = gate & octave_gate(octave_a, octave_b, lo, hi)
    d = hamming.hamming_matrix(desc_a, desc_b)
    d = torch.where(gate, d, torch.full_like(d, BIG))
    if d.shape[-1] == 0:  # no candidate: every row is the all-gated-out row
        shape = d.shape[:-1]
        big = torch.full(shape, BIG, dtype=torch.int32, device=d.device)
        return Top2(torch.zeros(shape, dtype=torch.int64, device=d.device), big,
                    torch.zeros(shape, dtype=torch.bool, device=d.device), big.clone())
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    second = torch.min(d.scatter(-1, best_idx[..., None], BIG), dim=-1).values
    ok = (best <= max_dist) & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    return Top2(best_idx, best.to(torch.int32), ok, second.to(torch.int32))


# ---------------------------------------------------------------- kernels --

def _check(x: torch.Tensor, fn: str, name: str, dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {list(shape)}, got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_desc(x: torch.Tensor, fn: str, name: str) -> None:
    _check(x, fn, name, torch.int32, x.shape[:-1] + (hamming.WORDS,))
    if x.ndim not in (2, 3):
        raise ValueError(f"{fn}: {name} must be [N, 8] or [B, N, 8], got {list(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed [N, 8] x [M, 8] int32 (CUDA) -> [N, M] int32 Hamming distances;
    batched, [B or 1, N, 8] x [B, M, 8] -> [B, N, M], and an [N, 8] A is
    shared by every entry of a batched B.

    Launches on the current stream without synchronising. Any N, M >= 0."""
    fn = "hamming_matrix_cuda"
    _check_desc(a, fn, "a")
    _check_desc(b, fn, "b")
    if a.device != b.device:
        raise ValueError(f"{fn}: a and b are on different devices")
    batched = b.ndim == 3
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if batched else b[None]
    nb, n, m = b3.shape[0], a3.shape[1], b3.shape[1]
    if a3.shape[0] not in (1, nb) or (a.ndim == 3 and not batched):
        raise ValueError(f"{fn}: a must be [N, 8], [1, N, 8] or [B, N, 8] for b [B, M, 8]")
    if nb > 65535:
        raise ValueError(f"{fn}: B={nb} exceeds the grid limit")
    out = torch.empty((nb, n, m), dtype=torch.int32, device=a.device)
    if nb and n and m:
        a_bstride = n * hamming.WORDS if a3.shape[0] > 1 else 0
        with torch.cuda.device(a.device):
            LIBRARY.launch("hamming_table_launch", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           nb, n, m, a_bstride, _stream(a.device))
        count_launch(hamming_matrix_cuda)
    return out if batched else out[0]


reset_launches(hamming_matrix_cuda)


def gated_match_cuda(desc_a, desc_b, max_dist: int, ratio: float, gate=None, *, valid_a=None,
                     valid_b=None, uv=None, radius=None, xy=None, octave_a=None, octave_b=None,
                     lo: int = -1, hi: int = 1) -> Top2:
    """The fused kernel: as :func:`gated_match`, on CUDA tensors only.

    ``desc_a`` [B or 1, N, 8] and ``desc_b`` [B, M, 8] int32. The gate is
    either dense, ``gate`` [B, N, M] bool, or factored: ``valid_a`` [B, N] and
    ``valid_b`` [B, M] bool always; the window with ``uv`` [B, N, 2],
    ``radius`` [B, N] and ``xy`` [B, M, 2] float32 (all or none); the octave
    band ``lo <= octave_b - octave_a <= hi`` with ``octave_a`` [B, N] and
    ``octave_b`` [B, M] int32 (both or none, and only with the window).
    Launches once on the current
    stream without synchronising; the table never reaches device memory."""
    fn = "gated_match_cuda"
    _check_desc(desc_a, fn, "desc_a")
    _check_desc(desc_b, fn, "desc_b")
    if desc_a.ndim != 3 or desc_b.ndim != 3:
        raise ValueError(f"{fn}: desc_a and desc_b must be batched [B, N, 8]")
    nb, m = desc_b.shape[:2]
    n = desc_a.shape[1]
    if desc_a.shape[0] not in (1, nb):
        raise ValueError(f"{fn}: desc_a must have batch 1 or {nb}, got {desc_a.shape[0]}")
    if nb > 65535 or m > MAX_COLUMNS:
        raise ValueError(f"{fn}: B={nb} or M={m} exceeds the kernel's limits "
                         f"(65535, {MAX_COLUMNS})")
    window = (uv, radius, xy)
    octave = (octave_a, octave_b)
    factored = (valid_a, valid_b) + window + octave
    if gate is not None:
        if any(x is not None for x in factored):
            raise ValueError(f"{fn}: pass a dense gate or the factored one, not both")
        _check(gate, fn, "gate", torch.bool, (nb, n, m))
    else:
        if valid_a is None or valid_b is None:
            raise ValueError(f"{fn}: the factored gate needs valid_a and valid_b")
        if any(x is None for x in window) and any(x is not None for x in window):
            raise ValueError(f"{fn}: uv, radius and xy come together")
        if any(x is None for x in octave) and any(x is not None for x in octave):
            raise ValueError(f"{fn}: octave_a and octave_b come together")
        if octave_a is not None and uv is None:
            raise ValueError(f"{fn}: the octave band comes only with the window")
        _check(valid_a, fn, "valid_a", torch.bool, (nb, n))
        _check(valid_b, fn, "valid_b", torch.bool, (nb, m))
        if uv is not None:
            _check(uv, fn, "uv", torch.float32, (nb, n, 2))
            _check(radius, fn, "radius", torch.float32, (nb, n))
            _check(xy, fn, "xy", torch.float32, (nb, m, 2))
            if xy.data_ptr() % 8:
                raise ValueError(f"{fn}: xy must be 8-byte aligned")
        if octave_a is not None:
            _check(octave_a, fn, "octave_a", torch.int32, (nb, n))
            _check(octave_b, fn, "octave_b", torch.int32, (nb, m))
            if not -(1 << 20) <= lo <= hi <= 1 << 20:
                raise ValueError(f"{fn}: the octave band needs -2^20 <= lo <= hi <= 2^20")
    dev = desc_a.device
    inputs = [x for x in (desc_b, gate) + factored if x is not None]
    if any(x.device != dev for x in inputs):
        raise ValueError(f"{fn}: every input must be on {dev}")
    out = Top2(torch.empty((nb, n), dtype=torch.int64, device=dev),
               torch.empty((nb, n), dtype=torch.int32, device=dev),
               torch.empty((nb, n), dtype=torch.bool, device=dev),
               torch.empty((nb, n), dtype=torch.int32, device=dev))
    if nb == 0 or n == 0:
        return out
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    args = _MatchArgs(
        ptr(desc_a), ptr(desc_b), ptr(gate), ptr(uv), ptr(radius), ptr(valid_a), ptr(octave_a),
        ptr(xy), ptr(valid_b), ptr(octave_b), *(x.data_ptr() for x in out),
        n * hamming.WORDS if desc_a.shape[0] > 1 else 0,
        nb, n, m, int(lo), int(hi), int(gate is not None), int(uv is not None),
        int(octave_a is not None),
        int(max_dist), float(ratio))
    with torch.cuda.device(dev):
        LIBRARY.launch("gated_match_launch", ctypes.byref(args), _stream(dev))
    count_launch(gated_match_cuda)
    return out


reset_launches(gated_match_cuda)
