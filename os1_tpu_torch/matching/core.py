"""Core batched matching machinery shared by every matcher variant.
Port of os1_tpu/matching/core.py.

Every variant is: distance table + boolean gate + row argmin + ratio test +
optional mutual-best + rotation-consistency histogram, over fixed-shape masked
tensors. Distances of gated-out pairs are +BIG so one argmin finds the best
candidate. Thresholds mirror the reference: TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30 (ORBmatcher.cc:37-39). Ties go to the lowest index, as
``jnp.argmin`` and ``lax.top_k`` give them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import hamming
from ..ops.pallas_hamming import hamming_matrix_cuda
from ..utils.numerics import float_mod

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 1 << 20


class MatchResult(NamedTuple):
    """Per-row match outcome: row i of A matched to ``idx[i]`` of B (any
    leading batch dimensions: one independent problem per batch entry)."""

    idx: torch.Tensor  # [..., N] int64 index into B (undefined where ~ok)
    dist: torch.Tensor  # [..., N] int32 best Hamming distance
    ok: torch.Tensor  # [..., N] bool


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 8] x [..., M, 8] packed int32 descriptors -> [..., N, M] int32
    distances. A batch of B tables against one shared A is one table
    [N, B * M]; two batched sides give one table per batch entry.

    A CUDA tensor always goes through the hand-written kernel, at any shape;
    a CPU tensor takes the plain version."""
    if desc_a.ndim == 2 and desc_b.ndim > 2:
        flat = distance_matrix(desc_a, desc_b.reshape(-1, desc_b.shape[-1]))
        return flat.reshape(desc_a.shape[0], -1, desc_b.shape[-2]).transpose(0, 1)
    if desc_a.ndim > 2:  # [B, N, 8] x [B, M, 8]: one kernel launch per entry
        return torch.stack([distance_matrix(x, y) for x, y in zip(desc_a, desc_b)])
    if desc_a.is_cuda:
        return hamming_matrix_cuda(desc_a.contiguous(), desc_b.contiguous())
    return hamming.hamming_matrix(desc_a, desc_b)


def match_with_gate(desc_a, desc_b, gate, max_dist: int = TH_LOW,
                    ratio: float = 1.0, dist=None) -> MatchResult:
    """Best gated match in B for every row of A (gate: [..., N, M] bool)."""
    d = distance_matrix(desc_a, desc_b) if dist is None else dist
    d = torch.where(gate, d, torch.full_like(d, BIG))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    d2 = d.scatter(-1, best_idx[..., None], BIG)
    second = torch.min(d2, dim=-1).values
    ok = (best <= max_dist) & (best.to(torch.float32) <= ratio * second.to(torch.float32))
    return MatchResult(idx=best_idx, dist=best.to(torch.int32), ok=ok)


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
