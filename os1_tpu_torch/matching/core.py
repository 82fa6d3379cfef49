"""Core batched matching machinery shared by every matcher variant.
Port of os1_tpu/matching/core.py.

Every variant is: distance table + boolean gate + row argmin + ratio test +
optional mutual-best + rotation-consistency histogram, over fixed-shape masked
tensors. Distances of gated-out pairs are +BIG so one argmin finds the best
candidate. On the card the first four are one fused kernel launch per call
(``ops/pallas_hamming.py::gated_match_cuda``), batch dimensions included, and
the table never reaches device memory; on the CPU their plain chain runs.
Thresholds mirror the reference: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30
(ORBmatcher.cc:37-39). Ties go to the lowest index, as ``jnp.argmin`` and
``lax.top_k`` give them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import hamming
from ..ops.pallas_hamming import BIG, gated_match, gated_match_cuda, hamming_matrix_cuda
from ..utils.numerics import float_mod

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30


class MatchResult(NamedTuple):
    """Per-row match outcome: row i of A matched to ``idx[i]`` of B (any
    leading batch dimensions: one independent problem per batch entry)."""

    idx: torch.Tensor  # [..., N] int64 index into B (undefined where ~ok)
    dist: torch.Tensor  # [..., N] int32 best Hamming distance
    ok: torch.Tensor  # [..., N] bool


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [M, 8] packed int32 descriptors -> [N, M] int32 distances
    (and [B, M, 8] for B gives [B, N, M]). A CUDA tensor goes through the table
    kernel; a CPU tensor takes the plain version."""
    if desc_a.is_cuda:
        return hamming_matrix_cuda(desc_a, desc_b)
    return hamming.hamming_matrix(desc_a, desc_b)


def _flat(x, lead, tail):
    """``x`` broadcast to ``lead + tail`` and flattened to [B, *tail]."""
    return x.expand(lead + tuple(tail)).reshape((-1,) + tuple(tail))


def _match(desc_a, desc_b, max_dist, ratio, gate=None, lo=-1, hi=1, **factored) -> MatchResult:
    """One gated match over any leading batch dimensions: the fused kernel in
    one launch for CUDA tensors, its plain version for CPU ones. ``desc_a``
    without batch dimensions is shared by every entry."""
    lead = torch.broadcast_shapes(desc_a.shape[:-2], desc_b.shape[:-2])
    n, m = desc_a.shape[-2], desc_b.shape[-2]
    dev = desc_a.device
    a = desc_a[None] if desc_a.ndim == 2 else _flat(desc_a, lead, (n, hamming.WORDS))
    args = dict(desc_a=a.contiguous(),
                desc_b=_flat(desc_b, lead, (m, hamming.WORDS)).contiguous(), max_dist=max_dist,
                ratio=ratio, lo=lo, hi=hi)
    if gate is not None:
        args["gate"] = _flat(gate, lead, (n, m)).contiguous()
    kinds = dict(valid_a=(torch.bool, (n,)), valid_b=(torch.bool, (m,)),
                 uv=(torch.float32, (n, 2)), radius=(torch.float32, (n,)),
                 xy=(torch.float32, (m, 2)), octave_a=(torch.int32, (n,)),
                 octave_b=(torch.int32, (m,)))
    for name, x in factored.items():
        if x is not None:
            dtype, tail = kinds[name]
            x = torch.as_tensor(x, dtype=dtype, device=dev)
            args[name] = _flat(x, lead, tail).contiguous()
    res = (gated_match_cuda if dev.type == "cuda" else gated_match)(**args)
    return MatchResult(idx=res.idx.reshape(lead + (n,)), dist=res.dist.reshape(lead + (n,)),
                       ok=res.ok.reshape(lead + (n,)))


def match_with_gate(desc_a, desc_b, gate, max_dist: int = TH_LOW,
                    ratio: float = 1.0) -> MatchResult:
    """Best gated match in B for every row of A (gate: [..., N, M] bool)."""
    return _match(desc_a, desc_b, max_dist, ratio, gate=gate)


def match_projected(desc_a, desc_b, valid_a, valid_b, uv=None, xy=None, radius=None,
                    octave_a=None, octave_b=None, lo: int = -1, hi: int = 1,
                    max_dist: int = TH_LOW, ratio: float = 1.0) -> MatchResult:
    """Best match in B for every row of A under the factored projection gate,
    ``valid_a x valid_b``, and ``window_gate(uv, xy, radius, ...)`` when ``uv``
    is given (``radius`` scalar or per row), and ``octave_gate(octave_a,
    octave_b, lo, hi)`` when ``octave_a`` is given. The [..., N, M] gate is
    never built on the card."""
    return _match(desc_a, desc_b, max_dist, ratio, valid_a=valid_a, valid_b=valid_b, uv=uv,
                  xy=xy, radius=radius, octave_a=octave_a, octave_b=octave_b, lo=lo, hi=hi)


def mutual_best(result: MatchResult, m: int) -> MatchResult:
    """Keep at most one row of A per column of B (the best-distance one,
    lowest row on ties): the reference's vnMatches21 bookkeeping."""
    n = result.idx.shape[-1]
    batch = result.idx.shape[:-1]
    dev = result.idx.device
    claimed = torch.where(result.ok, result.idx, torch.full_like(result.idx, m))
    col_best = torch.full(batch + (m + 1,), BIG, dtype=torch.int32, device=dev).scatter_reduce(
        -1, claimed, result.dist, reduce="amin")
    is_best = result.ok & (result.dist == torch.gather(col_best, -1, claimed))
    row_ids = torch.arange(n, dtype=torch.int64, device=dev).expand(batch + (n,))
    col_winner = torch.full(batch + (m + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        -1, claimed, torch.where(is_best, row_ids, torch.full_like(row_ids, n)), reduce="amin")
    ok = is_best & (torch.gather(col_winner, -1, claimed) == row_ids)
    return MatchResult(idx=result.idx, dist=result.dist, ok=ok)


def rotation_consistency(angle_a, angle_b, result: MatchResult,
                         n_keep_bins: int = 3) -> MatchResult:
    """Keep matches whose angle difference falls in the 3 dominant histogram
    bins (reference ComputeThreeMaxima, with the 10%-of-max cutoff)."""
    batch = result.idx.shape[:-1]
    angle_b = angle_b.expand(batch + angle_b.shape[-1:])
    rot = angle_a - torch.gather(angle_b, -1, result.idx)
    two_pi = 2.0 * math.pi
    rot = float_mod(rot, two_pi)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1).long()
    counts = torch.zeros(batch + (HISTO_LENGTH,), dtype=torch.int32, device=rot.device).scatter_add_(
        -1, torch.where(result.ok, bins, torch.zeros_like(bins)), result.ok.to(torch.int32))
    # lax.top_k order: descending count, lower bin first on ties.
    top_counts, top_bins = torch.sort(counts, dim=-1, descending=True, stable=True)
    top_counts, top_bins = top_counts[..., :n_keep_bins], top_bins[..., :n_keep_bins]
    keep = top_counts.to(torch.float32) >= 0.1 * top_counts[..., :1].to(torch.float32)
    keep_mask = torch.zeros(batch + (HISTO_LENGTH,), dtype=torch.bool,
                            device=rot.device).scatter(-1, top_bins, keep)
    return MatchResult(idx=result.idx, dist=result.dist,
                       ok=result.ok & torch.gather(keep_mask, -1, bins))
