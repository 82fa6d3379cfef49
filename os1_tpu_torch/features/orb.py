"""Batched ORB feature extraction: pyramid FAST -> spatial balance ->
orientation -> steered binary descriptors. Port of os1_tpu/features/orb.py.

The BRIEF pattern and the rotated patch table are built by the same numpy
code from the same seed, so they are identical to the reference's. The
reference picks BRIEF samples with one-hot bf16 matmuls (a TPU idiom); the
port gathers them directly and applies the same bf16 rounding to the sampled
intensities, which gives the same numbers. The two gathers, keypoint windows
and BRIEF samples, are the kernels P1 and P2 of ``ops/patches.py`` on the
card.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fast, hamming, image, topk
from ..ops.patches import brief_samples, keypoint_patches
from ..utils.numerics import float_mod

BORDER = 19
PATCH = 31
BRIEF_RADIUS = 13.0


class OrbConfig(NamedTuple):
    """Static extractor configuration (defaults: the reference's webcam.yaml
    ORBextractor block, nFeatures rounded to 1024)."""

    height: int = 480
    width: int = 640
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_hi: float = 20.0
    fast_lo: float = 7.0
    cell: int = 16
    k_per_cell: int = 4
    seed: int = 42

    @property
    def scales(self) -> tuple:
        return tuple(self.scale_factor**l for l in range(self.n_levels))

    @property
    def sigma2(self) -> tuple:
        return tuple(s * s for s in self.scales)

    @property
    def level_sizes(self) -> tuple:
        return tuple((int(round(self.height / s)), int(round(self.width / s)))
                     for s in self.scales)

    @property
    def features_per_level(self) -> tuple:
        f = 1.0 / self.scale_factor
        raw = np.array([f**l for l in range(self.n_levels)])
        raw = raw / raw.sum() * self.n_features
        counts = np.floor(raw).astype(int)
        counts[0] += self.n_features - counts.sum()
        return tuple(int(c) for c in counts)


class FrameFeatures(NamedTuple):
    """Fixed-capacity masked keypoint set for one image (leading dim N)."""

    xy: torch.Tensor  # [N, 2] float32 (x, y), level-0 pixels, distorted
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor  # [N] float32 radians
    octave: torch.Tensor  # [N] int32
    desc: torch.Tensor  # [N, 8] int32 packed 256-bit
    valid: torch.Tensor  # [N] bool


N_ORIENT = 64
PS = 32  # keypoint patch size
_PC = 15  # patch center


def _brief_pattern(seed: int) -> np.ndarray:
    """[256, 2, 2] float32 sample-pair offsets (isotropic Gaussian BRIEF-I)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, size=(hamming.BITS, 2, 2))
    return np.clip(pts, -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.float32)


def _rotated_patch_table(seed: int) -> np.ndarray:
    """[N_ORIENT, 512] int32 patch-local flat offsets (row * PS + col) of every
    BRIEF sample per discrete orientation, nearest-pixel rounded."""
    pat = _brief_pattern(seed)
    r = BRIEF_RADIUS + 1
    tables = []
    for a in range(N_ORIENT):
        th = 2.0 * np.pi * a / N_ORIENT
        c, s = np.cos(th), np.sin(th)
        x = pat[..., 0] * c - pat[..., 1] * s
        y = pat[..., 0] * s + pat[..., 1] * c
        xi = np.clip(np.round(x), -r, r).astype(np.int64) + _PC
        yi = np.clip(np.round(y), -r, r).astype(np.int64) + _PC
        tables.append((yi * PS + xi).reshape(-1))
    return np.stack(tables).astype(np.int32)


def _ic_patch_weights() -> tuple[np.ndarray, np.ndarray]:
    """x-/y-moment weights [PS, PS] over the radius-15 orientation disc."""
    ys, xs = np.mgrid[0:PS, 0:PS]
    dy, dx = ys - _PC, xs - _PC
    disc = (dx * dx + dy * dy) <= (PATCH // 2) ** 2
    return (dx * disc).astype(np.float32), (dy * disc).astype(np.float32)


@functools.lru_cache(maxsize=8)
def make_extractor(cfg: OrbConfig, device: str | torch.device = "cuda"):
    """Build an extractor: float32 [H, W] grayscale on ``device`` ->
    FrameFeatures. All levels live in one padded [L, H, W] stack and every
    stage runs once over the whole stack."""
    device = torch.device(device)
    sizes = cfg.level_sizes
    budgets = cfg.features_per_level
    L = cfg.n_levels
    n_max = max(budgets)
    Ry, Rx = image.pyramid_matrices(cfg.height, cfg.width, sizes)
    Ry = torch.as_tensor(Ry[1:], device=device).to(torch.bfloat16).to(torch.float32)
    Rx = torch.as_tensor(Rx[1:], device=device).to(torch.bfloat16).to(torch.float32)
    hb = torch.tensor([h for h, _ in sizes], dtype=torch.int64, device=device)
    wb = torch.tensor([w for _, w in sizes], dtype=torch.int64, device=device)
    wx_np, wy_np = _ic_patch_weights()
    ic_wx = torch.as_tensor(wx_np.reshape(-1), device=device)
    ic_wy = torch.as_tensor(wy_np.reshape(-1), device=device)
    sample_table = torch.as_tensor(_rotated_patch_table(cfg.seed), device=device)
    oct_o = torch.cat([torch.full((budgets[l],), l, dtype=torch.int32, device=device)
                       for l in range(L)])
    scale_per_lane = torch.cat([torch.full((budgets[l],), cfg.scales[l], dtype=torch.float32,
                                           device=device) for l in range(L)])
    H, W = cfg.height, cfg.width
    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    interior = ((ys >= BORDER) & (ys < hb[:, None, None] - BORDER)
                & (xs >= BORDER) & (xs < wb[:, None, None] - BORDER))

    def extract(img: torch.Tensor) -> FrameFeatures:
        img = img.to(device=device, dtype=torch.float32)
        pyr = image.build_pyramid_stack(img, Ry, Rx)  # [L, H, W]
        scores = fast.nms3x3(fast.fast_with_fallback(pyr, cfg.fast_hi, cfg.fast_lo,
                                                     bounds=(hb, wb)))
        scores = torch.where(interior, scores, torch.zeros_like(scores))
        xy, resp, valid = topk.balanced_cell_topk_batch(scores, cfg.cell, cfg.k_per_cell, n_max)

        # Per-level budget selection first: orientation and descriptors run
        # on exactly n_features lanes.
        xy_o = torch.cat([xy[l, : budgets[l]] for l in range(L)], dim=0)
        resp_o = torch.cat([resp[l, : budgets[l]] for l in range(L)], dim=0)
        val_o = torch.cat([valid[l, : budgets[l]] for l in range(L)], dim=0)

        blurred = image.gaussian_blur(image.replicate_level_edges(pyr, hb, wb))
        # 32x32 patch per keypoint (P1); start indices clamp into the stack
        # as lax.dynamic_slice clamps them (invalid lanes may sit anywhere).
        kps = torch.stack([oct_o, torch.round(xy_o[:, 1]).to(torch.int32),
                           torch.round(xy_o[:, 0]).to(torch.int32)], dim=1)
        pflat = keypoint_patches(blurred, kps).reshape(-1, PS * PS)

        angle = torch.atan2(pflat @ ic_wy, pflat @ ic_wx)
        two_pi = 2.0 * math.pi
        abin = torch.remainder(
            torch.round(float_mod(angle, two_pi) * (N_ORIENT / two_pi)).to(torch.int32), N_ORIENT)
        # BRIEF samples of the bin's rotated pattern, rounded to bf16 (P2).
        samples = brief_samples(pflat, abin, sample_table).reshape(-1, hamming.BITS, 2)
        desc_o = hamming.pack_bits(samples[..., 0] < samples[..., 1])
        return FrameFeatures(xy=xy_o * scale_per_lane[:, None], response=resp_o, angle=angle,
                             octave=oct_o, desc=desc_o, valid=val_o)

    return extract
