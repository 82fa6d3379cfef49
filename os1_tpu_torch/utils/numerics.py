"""Small numeric helpers that reproduce the reference package's jnp semantics."""
from __future__ import annotations

import torch


def float_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` semantics: exact fmod, shifted to the sign of the divisor
    (``torch.remainder`` computes ``x - y * floor(x / y)`` and can differ in
    the last bit)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def jacfwd_rows(f, x: torch.Tensor) -> torch.Tensor:
    """Jacobian [..., *out, n] of ``f`` at ``x`` [..., n] by forward-mode AD,
    for an ``f`` that broadcasts over leading dimensions and whose outputs in
    each leading position depend only on the input row in that position (so
    ``x`` [n] gives the plain Jacobian; ``x`` [E, n], one per edge, gives the
    E per-edge Jacobians). One ``torch.func.jvp`` of ``f`` on ``x`` expanded
    over a leading basis dimension: the n tangent directions run as one
    batch. This is ``jax.jacfwd`` (vmapped over the rows) without
    ``torch.func.vmap``, under which a 0-dim tensor plus a Python number gets
    a float64 tangent in torch 2.x."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = basis.reshape((n,) + (1,) * (x.ndim - 1) + (n,)).expand((n,) + x.shape).contiguous()
    _, tangents = torch.func.jvp(f, (x.expand((n,) + x.shape).contiguous(),), (basis,))
    return tangents.movedim(0, -1)
