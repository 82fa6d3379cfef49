"""The yardstick for the hand-written kernels: the card's published peaks and
each kernel's least work, counted from the shapes of one launch. Each input
byte is counted read once and each output byte written once; a kernel's
lower-bound time is the larger of its bytes at the memory rate and its
operations at the compute rate.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
3.35 TB/s of HBM3, 1,979 TOP/s int8 on the tensor cores. K1's distance core
runs 1-bit MMAs, whose H100 rate NVIDIA does not publish; the int8 rate
stands in for it, as in ``PERF.md`` §6.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BITS = 256  # a descriptor
DESC_BYTES = 32

# metric stem -> the kernel's name in the device trace
TRACE_NAMES = {
    "gated_match": "gated_match_kernel",
    "patch_gather": "patch_gather_kernel",
    "sample_gather": "sample_gather_kernel",
}


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)


def gated_match(batch_a: int, n: int, batch: int, m: int, dense: bool, window: bool,
                octave: bool) -> float:
    """K1's fused gated top-2 (``csrc/hamming.cu``): A [batch_a, n] and B
    [batch, m] descriptors read, the gate read (dense [batch, n, m] bool, or
    the factored masks, window and octaves), 17 bytes a row of A written
    (index int64, distance, second distance int32, valid bool); an XOR and a
    popcount for each bit of each pair."""
    nbytes = (batch_a * n + batch * m) * DESC_BYTES + batch * n * 17
    if dense:
        nbytes += batch * n * m
    else:
        nbytes += batch * (n + m)  # valid_a, valid_b
        if window:
            nbytes += batch * (n * 8 + n * 4 + m * 8)  # uv, radius, xy
        if octave:
            nbytes += batch * (n + m) * 4
    return bound_s(nbytes, 2.0 * batch * n * m * BITS)


def patch_gather(n: int, ps: int = 32) -> float:
    """P1 (``csrc/patches.cu``): n float32 windows of ps x ps read from the
    level stack and written, the [n, 3] int32 keypoints read."""
    return bound_s(2 * n * ps * ps * 4 + n * 12)


def sample_gather(n: int, samples: int, table_entries: int, ps: int = 32) -> float:
    """P2: the [n, ps*ps] patches, the n bins and the offset table read, the
    [n, samples] float32 samples written."""
    return bound_s(n * ps * ps * 4 + n * 4 + table_entries * 4 + n * samples * 4)
