"""3D map rendering: map points, keyframe frusta, covisibility graph and the
current camera — the reference MapDrawer (MapDrawer.cc:42-261) re-targeted
from Pangolin/OpenGL to a headless software projection (PNG snapshots /
live window frames). Port of os1_tpu/viz/map_drawer.py: numpy over the host
map store, OpenCV imported inside :func:`draw_map`.
"""
from __future__ import annotations

import numpy as np


def _look_at(eye, target, up=(0, -1, 0)):
    eye = np.asarray(eye, float)
    f = np.asarray(target, float) - eye
    f = f / (np.linalg.norm(f) + 1e-9)
    up = np.asarray(up, float)
    s = np.cross(f, up)
    s /= np.linalg.norm(s) + 1e-9
    u = np.cross(s, f)
    R = np.stack([s, u, f])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T


def draw_map(
    store,
    current_Tcw: np.ndarray | None = None,
    size: tuple = (640, 480),
    focal: float = 420.0,
    view_eye=None,
    show_points: bool = True,
    show_keyframes: bool = True,
    show_graph: bool = True,
) -> np.ndarray:
    """Render a bird's-eye view of the map. Returns BGR uint8 [H, W, 3]."""
    import cv2

    w, h = size
    out = np.full((h, w, 3), 18, np.uint8)
    pts = store.pt_xyz[store.pt_valid]
    kfs = np.nonzero(store.kf_valid)[0]
    centers = np.array(
        [-store.kf_T[k][:3, :3].T @ store.kf_T[k][:3, 3] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))

    everything = np.concatenate([pts, centers]) if len(pts) else centers
    if len(everything) == 0:
        return out
    center = np.median(everything, axis=0)
    spread = float(np.percentile(np.linalg.norm(everything - center, axis=1), 90) + 1e-3)
    eye = center + np.array([0.0, -2.6 * spread, -2.6 * spread]) if view_eye is None else view_eye
    V = _look_at(eye, center)

    def project(X):
        Xc = X @ V[:3, :3].T + V[:3, 3]
        z = np.clip(Xc[:, 2], 1e-3, None)
        u = focal * Xc[:, 0] / z + w / 2
        v = focal * Xc[:, 1] / z + h / 2
        ok = (Xc[:, 2] > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        return np.stack([u, v], 1).astype(int), ok

    if len(pts) and show_points:
        uv, ok = project(pts)
        far = store.pt_far[store.pt_valid]
        colors = store.pt_color[store.pt_valid]
        has_color = colors.any(axis=1)
        for i in np.nonzero(ok)[0]:
            if far[i]:
                c = (180, 64, 200)  # far-point color coding (os1 MapDrawer)
            elif has_color[i]:
                c = tuple(int(x) for x in colors[i][::-1])
            else:
                c = (90, 90, 90)
            out[uv[i, 1], uv[i, 0]] = c

    # Covisibility graph + frusta.
    if len(centers):
        cuv, cok = project(centers)
        if show_graph:
            for a_i, k in enumerate(kfs):
                ws = store.covisibility_weights(int(k))
                for b in np.nonzero(ws >= 100)[0]:
                    b_i = np.searchsorted(kfs, b)
                    if b_i < len(kfs) and kfs[b_i] == b and cok[a_i] and cok[b_i]:
                        cv2.line(out, tuple(cuv[a_i]), tuple(cuv[b_i]),
                                 (70, 130, 70), 1)
        if show_keyframes:
            for i in np.nonzero(cok)[0]:
                cv2.rectangle(out, tuple(cuv[i] - 2), tuple(cuv[i] + 2),
                              (255, 160, 0), 1)

    if current_Tcw is not None:
        c = (-current_Tcw[:3, :3].T @ current_Tcw[:3, 3])[None]
        cuv, cok = project(c)
        if cok[0]:
            cv2.circle(out, tuple(cuv[0]), 5, (0, 0, 255), 2)
    return out
