"""Frozen numpy copy of the program's renderer (``os1_tpu_torch/io/
synthetic.py``: ``resize_cubic``, ``render``), with the radial-tangential
lens that ``slambench/render.py`` adds: the plain form the CPU tests hold the
benchmark's PyTorch renderer against. Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    A = np.float32(-0.75)
    f = f.astype(np.float32)
    g = f + np.float32(1)
    c0 = ((A * g - 5 * A) * g + 8 * A) * g - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    h = np.float32(1) - f
    c2 = ((A + 2) * h - (A + 3)) * h * h + 1
    c3 = np.float32(1) - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)


def _cubic_axis(n_in: int, n_out: int):
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, _cubic_weights(f - s)


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    img = img.astype(np.float32)
    xi, xw = _cubic_axis(img.shape[1], w)
    yi, yw = _cubic_axis(img.shape[0], h)
    tmp = img[:, xi[:, 0]] * xw[:, 0]
    for k in range(1, 4):
        tmp = tmp + img[:, xi[:, k]] * xw[:, k]
    out = tmp[yi[:, 0]] * yw[:, 0, None]
    for k in range(1, 4):
        out = out + tmp[yi[:, k]] * yw[:, k, None]
    return out


def pixel_rays(cam: dict, h: int, w: int, iters: int = 20):
    """(xn, yn) [h, w] float64 undistorted normalized coordinates of every
    pixel centre: the fixed-point inverse of the radial-tangential model."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xd = (xs - cam["cx"]) / cam["fx"]
    yd = (ys - cam["cy"]) / cam["fy"]
    k1, k2, p1, p2, k3 = (float(cam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
    x, y = xd, yd
    if any((k1, k2, p1, p2, k3)):
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (xd - dx) / radial, (yd - dy) / radial
    return x, y


def render(planes, Tcw: np.ndarray, cam: dict, h: int, w: int,
           background: float = 10.0) -> np.ndarray:
    """One frame [h, w] float32; ``planes`` is a list of (origin, u, v,
    texture) numpy arrays."""
    R = Tcw[:3, :3].astype(np.float64)
    t = Tcw[:3, 3].astype(np.float64)
    C = -R.T @ t
    xn, yn = pixel_rays(cam, h, w)
    d_world = np.stack([xn, yn, np.ones_like(xn)], axis=-1) @ R
    img = np.full((h, w), background, np.float64)
    depth = np.full((h, w), np.inf)
    for origin, u_axis, v_axis, tex in planes:
        n = np.cross(u_axis, v_axis)
        denom = d_world @ n
        tt = ((origin - C) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        hit = C + tt[..., None] * d_world
        rel = hit - origin
        uu = rel @ u_axis / (u_axis @ u_axis)
        vv = rel @ v_axis / (v_axis @ v_axis)
        ok = (tt > 0.05) & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1) & (tt < depth)
        th, tw = tex.shape
        px = np.clip(uu * (tw - 1), 0, tw - 1.001)
        py = np.clip(vv * (th - 1), 0, th - 1.001)
        x0 = px.astype(int)
        y0 = py.astype(int)
        fx = px - x0
        fy = py - y0
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, np.minimum(x0 + 1, tw - 1)] * fx * (1 - fy)
            + tex[np.minimum(y0 + 1, th - 1), x0] * (1 - fx) * fy
            + tex[np.minimum(y0 + 1, th - 1), np.minimum(x0 + 1, tw - 1)] * fx * fy
        )
        img = np.where(ok, val, img)
        depth = np.where(ok, tt, depth)
    return img.astype(np.float32)
