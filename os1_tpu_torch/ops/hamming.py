"""Hamming distance between 256-bit binary descriptors (the matching
primitive; reference ORBmatcher::DescriptorDistance, ORBmatcher.cc:1605-1621).

Descriptors are held packed as ``torch.int32 [N, 8]``: the same 32 bits per
word as the JAX package's ``uint32`` (bit i of word w = pattern test w*32+i).
XOR and popcount do not care about the sign bit, and torch's ``uint32``
support is partial. Convert at the numpy edge with ``.view(np.int32)`` /
``.view(np.uint32)``.

:func:`hamming_matrix` is the plain version of the table kernel in
``ops/pallas_hamming.py``: the +-1 product form, ``d = (256 - s_a . s_b) / 2``
with ``s = 1 - 2 * bit`` in float32, one matrix product (exact: every partial
sum is an integer of magnitude <= 256).
"""
from __future__ import annotations

import torch

WORDS = 8
BITS = WORDS * 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 (little-endian bit order per word).

    Shifts and bitwise OR in int64, not a sum in int32: bit 31 would
    overflow a signed sum."""
    b = bits.reshape(bits.shape[:-1] + (WORDS, 32)).to(torch.int64)
    x = b << torch.arange(32, dtype=torch.int64, device=bits.device)
    while x.shape[-1] > 1:  # OR-reduce the 32 shifted bits pairwise
        x = x[..., 0::2] | x[..., 1::2]
    return _to_i32(x[..., 0])


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (BITS,)).to(torch.bool)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values holding 32-bit words (masked first)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of aligned descriptor arrays [..., 8] -> [...]."""
    x = torch.bitwise_xor(a.to(torch.int64), b.to(torch.int64))
    return _popcount32(x).sum(-1).to(torch.int32)


def _signs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] float32, +1 for a 0 bit and -1 for a 1."""
    return 1.0 - 2.0 * unpack_bits(words).to(torch.float32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed [..., N, 8] x [..., M, 8] int32 -> [..., N, M] int32 Hamming
    distances (leading dimensions broadcast), by one float32 matrix product
    of the +-1 bit vectors (the package keeps TF32 off, so it is exact)."""
    dot = _signs(a) @ _signs(b).transpose(-1, -2)
    return ((BITS - dot) * 0.5).to(torch.int32)
