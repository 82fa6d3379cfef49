"""Small numeric helpers that reproduce the reference package's jnp semantics."""
from __future__ import annotations

import torch


def float_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` semantics: exact fmod, shifted to the sign of the divisor
    (``torch.remainder`` computes ``x - y * floor(x / y)`` and can differ in
    the last bit)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)
