"""Image-plane ops for the feature pipeline: grayscale, separable Gaussian blur
with replicated edges, and the bilinear pyramid stack. Port of the front-end
half of os1_tpu/ops/image.py.

The reference package builds the pyramid as two bf16 matmuls per level with
float32 accumulation (level 0 exact). The port computes the same numbers: the
operands are rounded to bf16, multiplied and summed in float32, and the
intermediate is rounded to bf16 again, exactly where the reference rounds.
"""
from __future__ import annotations

import numpy as np
import torch


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] RGB -> [H, W] float32 luminance (BT.601 weights)."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        return img
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    return img @ w


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def edge_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of an edge-replicated pad of width ``pad`` on an axis of n."""
    return torch.clamp(torch.arange(-pad, n + pad, device=device), 0, n - 1)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate-edge padding over the last two
    axes of [..., H, W] float32 (reference ORBextractor.cc:898). The taps are
    summed in the reference's order."""
    k = _gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    x = img[..., edge_index(h, pad, img.device), :]
    acc = float(k[0]) * x[..., 0:h, :]
    for i in range(1, ksize):
        acc = acc + float(k[i]) * x[..., i:i + h, :]
    x = acc[..., :, edge_index(w, pad, img.device)]
    acc = float(k[0]) * x[..., :, 0:w]
    for i in range(1, ksize):
        acc = acc + float(k[i]) * x[..., :, i:i + w]
    return acc


def replicate_level_edges(stack: torch.Tensor, hb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Replicate each level's last valid row/col into the padding of a
    [L, H, W] pyramid stack (level l occupies the top-left (hb[l], wb[l]))."""
    L, H, W = stack.shape
    ys = torch.minimum(torch.arange(H, device=stack.device)[None, :], hb[:, None] - 1)
    out = torch.gather(stack, 1, ys[:, :, None].expand(L, H, W))
    xs = torch.minimum(torch.arange(W, device=stack.device)[None, :], wb[:, None] - 1)
    return torch.gather(out, 2, xs[:, None, :].expand(L, H, W))


def _resize_matrix(n_in: int, n_out: int, n_pad: int) -> np.ndarray:
    """[n_pad, n_in] bilinear interpolation matrix (half-pixel centers), rows
    past n_out zero."""
    R = np.zeros((n_pad, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        t = src - j0
        ja, jb = np.clip(j0, 0, n_in - 1), np.clip(j0 + 1, 0, n_in - 1)
        R[i, ja] += 1.0 - t
        R[i, jb] += t
    return R


def pyramid_matrices(h: int, w: int, level_sizes) -> tuple[np.ndarray, np.ndarray]:
    """(Ry [L, h, h], Rx [L, w, w]): level l of the padded pyramid stack is
    Ry[l] @ img @ Rx[l].T."""
    Ry = np.stack([_resize_matrix(h, hl, h) for hl, _ in level_sizes])
    Rx = np.stack([_resize_matrix(w, wl, w) for _, wl in level_sizes])
    return Ry, Rx


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 and back (the reference's casts)."""
    return x.to(torch.bfloat16).to(torch.float32)


def build_pyramid_stack(img: torch.Tensor, Ry: torch.Tensor, Rx: torch.Tensor) -> torch.Tensor:
    """[H, W] -> padded pyramid stack [L, H, W]; level 0 is the image itself.
    Ry and Rx are the level-1+ resize matrices already rounded to bf16."""
    t = torch.einsum("lhy,yx->lhx", Ry, _bf16(img))
    rest = torch.einsum("lhx,lwx->lhw", _bf16(t), Rx)
    return torch.cat([img[None], rest], dim=0)
