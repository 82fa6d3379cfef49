"""The benchmark's frame renderer, in PyTorch: textured planes seen from a
camera pose, through the configuration's lens model. It runs on the card
during set-up, in float64, and a whole sequence is a few batched calls.

A PyTorch form of ``os1_tpu_torch/io/synthetic.py``'s ``render`` and
``smooth_texture``, kept here so that the traffic stays what it is when the
program changes. ``reference/render_np.py`` is the frozen numpy copy the CPU
tests hold it against. Beyond the program's renderer it renders through the
radial-tangential distortion of a pinhole calibration (``k1 k2 p1 p2 k3``):
each pixel's ray is the fixed-point inverse of that model, the inverse the
program's undistortion computes, so the program's undistortion does its
real work.
"""
from __future__ import annotations

import math

import torch


def _cubic_weights(f: torch.Tensor) -> torch.Tensor:
    """[n, 4] Keys cubic weights (a = -0.75), OpenCV's interpolateCubic."""
    A = -0.75
    g = f + 1.0
    c0 = ((A * g - 5 * A) * g + 8 * A) * g - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    h = 1.0 - f
    c2 = ((A + 2) * h - (A + 3)) * h * h + 1
    c3 = 1.0 - c0 - c1 - c2
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _cubic_axis(n_in: int, n_out: int, device):
    scale = n_in / n_out
    f = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * scale - 0.5
    s = torch.floor(f)
    idx = (s.long()[:, None] + torch.arange(-1, 3, device=device)[None, :]).clamp(0, n_in - 1)
    return idx, _cubic_weights(f - s)


def resize_cubic(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """float32 bicubic resize [H, W] -> [h, w]: OpenCV's INTER_CUBIC kernel,
    edge replication, rows then columns."""
    img = img.to(torch.float32)
    xi, xw = _cubic_axis(img.shape[1], w, img.device)
    yi, yw = _cubic_axis(img.shape[0], h, img.device)
    tmp = img[:, xi[:, 0]] * xw[:, 0]
    for k in range(1, 4):
        tmp = tmp + img[:, xi[:, k]] * xw[:, k]
    out = tmp[yi[:, 0]] * yw[:, 0, None]
    for k in range(1, 4):
        out = out + tmp[yi[:, k]] * yw[:, k, None]
    return out


def smooth_texture(base: torch.Tensor, size: int, lo: float = 20.0, hi: float = 235.0):
    """Band-limited texture [size, size] float32 from ``base`` [cells, cells]
    uniform draws in [0, 1): corners at every scale."""
    return torch.clamp(resize_cubic(lo + (hi - lo) * base, size, size), 0.0, 255.0)


def undistort_grid(cam: dict, h: int, w: int, device, iters: int = 20) -> torch.Tensor:
    """[h*w, 3] float64 camera-frame rays (z = 1) of every pixel centre under
    the calibration ``cam`` (fx fy cx cy, optional k1 k2 p1 p2 k3)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    xd = ((xs - cam["cx"]) / cam["fx"]).reshape(-1)
    yd = ((ys - cam["cy"]) / cam["fy"]).reshape(-1)
    k1, k2, p1, p2, k3 = (float(cam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
    x, y = xd, yd
    if any((k1, k2, p1, p2, k3)):
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def render(planes, Tcw: torch.Tensor, rays: torch.Tensor, h: int, w: int,
           background: float = 10.0) -> torch.Tensor:
    """Frames [B, h, w] float32 of the camera poses ``Tcw`` [B, 4, 4]: each
    ray meets every plane, and the nearest hit in front samples its texture
    bilinearly. ``planes`` is a list of (origin [3], u [3], v [3], texture
    [th, tw]) float64 tensors (texture float32)."""
    Tcw = Tcw.to(torch.float64)
    R, t = Tcw[:, :3, :3], Tcw[:, :3, 3]
    C = -(R.transpose(1, 2) @ t[:, :, None])[:, :, 0]  # [B, 3] camera centres
    d = rays[None] @ R  # [B, P, 3]: R^T @ ray per pixel
    B = Tcw.shape[0]
    img = torch.full((B, h * w), background, dtype=torch.float64, device=rays.device)
    depth = torch.full((B, h * w), math.inf, dtype=torch.float64, device=rays.device)
    for origin, u, v, tex in planes:
        n = torch.linalg.cross(u, v)
        denom = d @ n
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        tt = ((origin[None] - C) @ n)[:, None] / denom
        rel = C[:, None, :] + tt[..., None] * d - origin
        uu = rel @ u / (u @ u)
        vv = rel @ v / (v @ v)
        ok = (tt > 0.05) & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1) & (tt < depth)
        th, tw = tex.shape
        px = torch.clamp(uu * (tw - 1), 0, tw - 1.001)
        py = torch.clamp(vv * (th - 1), 0, th - 1.001)
        x0, y0 = px.long(), py.long()
        fx, fy = px - x0, py - y0
        x1, y1 = torch.clamp(x0 + 1, max=tw - 1), torch.clamp(y0 + 1, max=th - 1)
        flat = tex.reshape(-1).to(torch.float64)
        val = (flat[y0 * tw + x0] * (1 - fx) * (1 - fy) + flat[y0 * tw + x1] * fx * (1 - fy)
               + flat[y1 * tw + x0] * (1 - fx) * fy + flat[y1 * tw + x1] * fx * fy)
        img = torch.where(ok, val, img)
        depth = torch.where(ok, tt, depth)
    return img.reshape(B, h, w).to(torch.float32)


def render_sequence(planes, Tcw: torch.Tensor, cam: dict, h: int, w: int,
                    background: float = 10.0, batch: int = 16) -> torch.Tensor:
    """[n, h, w] uint8 frames of the poses ``Tcw`` [n, 4, 4], on the planes'
    device, rendered ``batch`` poses a call."""
    rays = undistort_grid(cam, h, w, Tcw.device)
    out = torch.empty((Tcw.shape[0], h, w), dtype=torch.uint8, device=Tcw.device)
    for s in range(0, Tcw.shape[0], batch):
        f = render(planes, Tcw[s:s + batch], rays, h, w, background)
        out[s:s + batch] = torch.clamp(f, 0.0, 255.0).to(torch.uint8)
    return out
