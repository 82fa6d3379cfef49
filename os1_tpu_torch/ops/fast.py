"""FAST-9/16 corner scoring as a dense map, 3x3 NMS and the 20->7 threshold
fallback. Port of os1_tpu/ops/fast.py.

The ring reads and the arc min/max chain run in bf16, as in the reference
(ops/fast.py:77 there): the margins must round at the same places for the
keypoints to come out the same.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .image import edge_index

CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

def _ring_views(img: torch.Tensor) -> list:
    """[..., H, W] -> 16 shifted views (neighbor intensity at each offset)."""
    h, w = img.shape[-2], img.shape[-1]
    padded = img[..., edge_index(h, 3, img.device), :][..., :, edge_index(w, 3, img.device)]
    return [padded[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dx, dy in CIRCLE]


def _arc_min9(x: list) -> torch.Tensor:
    """Max over the 16 window starts of the min over 9 consecutive ring
    positions (window mins from lengths 1, 2, 4, 8)."""
    n = len(x)
    m2 = [torch.minimum(x[k], x[(k + 1) % n]) for k in range(n)]
    m4 = [torch.minimum(m2[k], m2[(k + 2) % n]) for k in range(n)]
    m8 = [torch.minimum(m4[k], m4[(k + 4) % n]) for k in range(n)]
    m9 = [torch.minimum(m8[k], x[(k + 8) % n]) for k in range(n)]
    out = m9[0]
    for k in range(1, n):
        out = torch.maximum(out, m9[k])
    return out


def fast_margin(img: torch.Tensor, bounds=None) -> torch.Tensor:
    """Threshold-free FAST-9/16 corner margin map, [..., H, W] float32.

    bounds: optional ([...] h, [...] w) per-slice valid extents."""
    img = img.to(torch.bfloat16)
    ring = _ring_views(img)
    margin = torch.maximum(
        _arc_min9([r - img for r in ring]),
        _arc_min9([img - r for r in ring]),
    ).to(torch.float32)
    h, w = img.shape[-2], img.shape[-1]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    if bounds is None:
        hb, wb = h, w
    else:
        hb = bounds[0].reshape(bounds[0].shape + (1, 1))
        wb = bounds[1].reshape(bounds[1].shape + (1, 1))
    interior = (ys >= 3) & (ys < hb - 3) & (xs >= 3) & (xs < wb - 3)
    return torch.where(interior, margin, torch.zeros_like(margin))


def nms3x3(scores: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression over the last two axes: keep local maxima
    (a tie with a neighbour is kept, as the reference's >= keeps it), zero
    the rest."""
    s4 = scores.reshape((-1, 1) + scores.shape[-2:])
    neigh_max = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(scores.shape)
    return torch.where((scores >= neigh_max) & (scores > 0.0), scores, torch.zeros_like(scores))


def fast_with_fallback(img: torch.Tensor, hi: float, lo: float, bounds=None) -> torch.Tensor:
    """High-threshold scores; 32x32 regions with none take the low-threshold
    response, scaled into (0, lo] so it ranks below every real corner
    (reference per-cell 20->7 fallback, ORBextractor.cc:848-856)."""
    margin = fast_margin(img, bounds=bounds)
    s_hi = torch.clamp(margin - hi, min=0.0)
    s_lo = torch.clamp(margin - lo, min=0.0)
    region = 32
    h, w = img.shape[-2], img.shape[-1]
    ph = (region - h % region) % region
    pw = (region - w % region) % region
    pad = F.pad(s_hi, (0, pw, 0, ph))
    hp, wp = pad.shape[-2] // region, pad.shape[-1] // region
    pooled = pad.reshape(pad.shape[:-2] + (hp, region, wp, region)).amax(dim=(-3, -1))
    empty = pooled <= 0.0
    empty_full = empty[..., :, None, :, None].expand(
        empty.shape[:-2] + (hp, region, wp, region)
    ).reshape(empty.shape[:-2] + (hp * region, wp * region))[..., :h, :w]
    peak = torch.amax(s_lo, dim=(-2, -1), keepdim=True)
    s_fb = s_lo / (1.0 + peak) * lo
    return torch.where(empty_full, s_fb, s_hi)
