"""Spatially balanced keypoint selection (the octree-distribution
equivalent). Port of os1_tpu/ops/topk.py.

Per CxC cell take the top-k responses, order all candidates by (rank within
cell, -response) and keep the first n_out: every cell's best corner is
considered before any cell's second-best. The sort is stable, and the per-cell
top-k breaks ties toward the lower index, as the reference does.
"""
from __future__ import annotations

import torch

_INVALID_KEY = 2**31 - 1


def _rank_major_key(rank: torch.Tensor, score: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 key ``rank * 2^21 + (2^20 - round(score * 4096))``; invalid
    lanes sort last."""
    q = torch.clamp(torch.round(score * 4096.0), 0, (1 << 20) - 1).to(torch.int32)
    key = rank * (1 << 21) + ((1 << 20) - q)
    return torch.where(valid, key, torch.full_like(key, _INVALID_KEY))


def _iterative_topk(cells: torch.Tensor, k: int):
    """top-k over the last axis by k masked argmax passes (first index wins)."""
    vals = cells
    iota = torch.arange(cells.shape[-1], device=cells.device)
    out_s, out_i = [], []
    for _ in range(k):
        i = torch.argmax(vals, dim=-1)
        out_s.append(torch.gather(vals, -1, i[..., None])[..., 0])
        out_i.append(i.to(torch.int32))
        vals = torch.where(iota == i[..., None], torch.full_like(vals, float("-inf")), vals)
    return torch.stack(out_s, dim=-1), torch.stack(out_i, dim=-1)


def balanced_cell_topk_batch(scores: torch.Tensor, cell: int, k_per_cell: int, n_out: int):
    """scores: [L, H, W] (zero outside each level's bounds). Returns
    (xy [L, n_out, 2] float32, resp [L, n_out], valid [L, n_out])."""
    L, h, w = scores.shape
    dev = scores.device
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = torch.nn.functional.pad(scores, (0, pw, 0, ph))
    hc, wc = s.shape[1] // cell, s.shape[2] // cell
    cells = (s.reshape(L, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
             .reshape(L, hc * wc, cell * cell))
    top_s, top_i = _iterative_topk(cells, k_per_cell)  # [L, M, k]
    M = hc * wc
    m_idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :, None]
    ys = (m_idx // wc) * cell + top_i // cell
    xs = (m_idx % wc) * cell + top_i % cell
    rank = torch.arange(k_per_cell, dtype=torch.int32, device=dev).expand(L, M, k_per_cell)

    flat_s = top_s.reshape(L, -1)
    flat_y = ys.reshape(L, -1)
    flat_x = xs.reshape(L, -1)
    valid = flat_s > 0.0
    key = _rank_major_key(rank.reshape(L, -1), flat_s, valid)
    order = torch.argsort(key, dim=1, stable=True)[:, :n_out]

    def take(a):
        return torch.gather(a, 1, order)

    out_xy = torch.stack([take(flat_x).to(torch.float32), take(flat_y).to(torch.float32)], dim=-1)
    return out_xy, take(flat_s), take(valid)
