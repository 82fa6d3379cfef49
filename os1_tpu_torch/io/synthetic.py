"""Synthetic textured-scene renderer: ground-truth image sequences for
end-to-end runs. Port (a numpy copy) of os1_tpu/io/synthetic.py that needs
neither OpenCV nor a frame cache: the band-limited textures use a numpy form
of OpenCV's bicubic resize, and sequences are rendered in memory.

The reference's de-facto regression mechanism is deterministic video replay
(SURVEY.md §4); with no camera or dataset available, this renderer is the
equivalent: known geometry + known trajectory -> images, so ATE can be
asserted against exact ground truth.

Scene model: N textured planes in world space. Per camera pose, each pixel's
ray is intersected with every plane; the nearest positive hit samples that
plane's texture bilinearly. Pure numpy, vectorized per plane.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TexturedPlane:
    origin: np.ndarray  # [3] a point on the plane (texture (0,0))
    u_axis: np.ndarray  # [3] in-plane axis, |u| = world width of texture
    v_axis: np.ndarray  # [3] in-plane axis
    texture: np.ndarray  # [Ht, Wt] float32 intensities


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """[n, 4] Keys cubic weights (a = -0.75), as OpenCV's interpolateCubic."""
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
    """Source indices [n_out, 4] (edge-replicated) and weights [n_out, 4] of a
    bicubic resize along one axis, half-pixel centers."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, _cubic_weights(f - s)


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """float32 bicubic resize [H, W] -> [h, w] (cv2.INTER_CUBIC's kernel,
    edge replication, rows then columns in float32)."""
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


def smooth_texture(h, w, cells, lo=20.0, hi=235.0, seed=0):
    """Band-limited random texture with strong corners at every scale."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, size=(cells, cells)).astype(np.float32)
    return np.clip(resize_cubic(base, h, w), 0, 255)


def default_scene(seed=0) -> list[TexturedPlane]:
    """Two fronto-parallel planes at different depths + a floor: general
    (non-planar) structure so initialization takes the fundamental path."""
    t1 = smooth_texture(512, 512, 48, seed=seed)
    t2 = smooth_texture(512, 512, 40, seed=seed + 1)
    t3 = smooth_texture(512, 512, 56, seed=seed + 2)
    return [
        TexturedPlane(
            origin=np.array([-4.0, -3.0, 8.0]),
            u_axis=np.array([8.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 6.0, 0.0]),
            texture=t1,
        ),
        TexturedPlane(
            origin=np.array([-5.0, -3.5, 12.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 7.0, 0.0]),
            texture=t2,
        ),
        TexturedPlane(  # floor
            origin=np.array([-5.0, 2.0, 4.0]),
            u_axis=np.array([10.0, 0.0, 0.0]),
            v_axis=np.array([0.0, 0.5, 9.0]),
            texture=t3,
        ),
    ]


def render(scene, Tcw: np.ndarray, K: np.ndarray, h: int, w: int,
           background: float = 10.0, fisheye: bool = False) -> np.ndarray:
    """Render one grayscale frame [h, w] float32 from camera pose Tcw.

    fisheye=True renders through the equidistant model (distorted radius =
    angle from axis — the os1 fisheye extension, Frame.cc:355-384): each
    pixel's ray is bent by tan(theta_d)/theta_d, exactly the inverse the
    camera model undistorts with, so a fisheye System on these frames sees
    geometrically consistent input."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    C = -R.T @ t  # camera center (world)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    if fisheye:
        theta_d = np.sqrt(xn * xn + yn * yn)
        safe = np.clip(np.where(theta_d < 1e-8, 1.0, theta_d),
                       None, np.pi / 2.0 - 1e-3)
        scale = np.where(theta_d < 1e-8, 1.0, np.tan(safe) / safe)
        xn, yn = xn * scale, yn * scale
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
    d_world = d_cam @ R  # R^T @ d per pixel

    img = np.full((h, w), background, np.float64)
    depth = np.full((h, w), np.inf)
    for plane in scene:
        n = np.cross(plane.u_axis, plane.v_axis)
        denom = d_world @ n
        tt = ((plane.origin - C) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        hit = C + tt[..., None] * d_world
        rel = hit - plane.origin
        uu = rel @ plane.u_axis / (plane.u_axis @ plane.u_axis)
        vv = rel @ plane.v_axis / (plane.v_axis @ plane.v_axis)
        ok = (tt > 0.05) & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1) & (tt < depth)
        th, tw = plane.texture.shape
        px = np.clip(uu * (tw - 1), 0, tw - 1.001)
        py = np.clip(vv * (th - 1), 0, th - 1.001)
        x0 = px.astype(int)
        y0 = py.astype(int)
        fx = px - x0
        fy = py - y0
        tex = plane.texture
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, np.minimum(x0 + 1, tw - 1)] * fx * (1 - fy)
            + tex[np.minimum(y0 + 1, th - 1), x0] * (1 - fx) * fy
            + tex[np.minimum(y0 + 1, th - 1), np.minimum(x0 + 1, tw - 1)] * fx * fy
        )
        img = np.where(ok, val, img)
        depth = np.where(ok, tt, depth)
    return img.astype(np.float32)


def room_scene(seed=0, half_size: float = 6.0, half_h: float = 2.5) -> list[TexturedPlane]:
    """Four inward-facing textured walls of a square room — the rendered rig
    for end-to-end loop-closure tests: a camera circling inside revisits its
    starting view after 360 degrees."""
    S, hh = half_size, half_h
    walls = []
    specs = [
        (np.array([-S, -hh, S]), np.array([2 * S, 0.0, 0.0])),   # z = +S
        (np.array([S, -hh, -S]), np.array([-2 * S, 0.0, 0.0])),  # z = -S
        (np.array([S, -hh, S]), np.array([0.0, 0.0, -2 * S])),   # x = +S
        (np.array([-S, -hh, -S]), np.array([0.0, 0.0, 2 * S])),  # x = -S
    ]
    for i, (origin, u) in enumerate(specs):
        walls.append(TexturedPlane(
            origin=origin, u_axis=u, v_axis=np.array([0.0, 2 * hh, 0.0]),
            texture=smooth_texture(512, 512, 44 + 6 * i, seed=seed + i),
        ))
    return walls


def loop_trajectory(n_frames: int, radius: float = 1.5,
                    revolutions: float = 1.15) -> list[np.ndarray]:
    """Closed-circuit trajectory: the camera moves on a circle in the x-z
    plane looking radially outward, covering ``revolutions`` turns — the
    final ~0.15 turn revisits the start and exercises loop closure.
    Returns Tcw matrices (world = circle center frame)."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * revolutions * i / max(n_frames - 1, 1)
        fwd = np.array([np.sin(th), 0.0, np.cos(th)])
        right = np.array([np.cos(th), 0.0, -np.sin(th)])
        down = np.array([0.0, 1.0, 0.0])
        Rwc = np.stack([right, down, fwd], axis=1)  # columns = camera axes
        pos = radius * fwd + np.array([0.0, 0.05 * np.sin(3 * th), 0.0])
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ pos
        poses.append(Tcw.astype(np.float32))
    return poses


def orbit_trajectory(n_frames: int, radius: float = 0.04,
                     advance: float = 0.06) -> list[np.ndarray]:
    """Sideways-dominant smooth trajectory with small rotations: good
    parallax for initialization, realistic for handheld motion.
    Returns a list of Tcw matrices (world = first-camera frame)."""
    from scipy.spatial.transform import Rotation

    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        pos = np.array(
            [advance * i, radius * np.sin(2 * np.pi * s), 0.15 * np.sin(np.pi * s)]
        )
        yaw = -0.15 * s  # slowly turn toward the scene
        Rwc = Rotation.from_euler("yxz", [yaw, 0.02 * np.sin(4 * s), 0.0]).as_matrix()
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ pos
        poses.append(Tcw.astype(np.float32))
    return poses


def render_sequence(scene, poses, K, h: int, w: int, noise_sigma: float = 0.0,
                    seed: int = 0) -> np.ndarray:
    """Render a whole trajectory to a [n, h, w] uint8 stack; noise_sigma > 0
    adds per-frame Gaussian photometric noise drawn from ``seed``."""
    frames = np.stack([np.clip(render(scene, T, K, h, w), 0, 255) for T in poses])
    if noise_sigma > 0.0:
        rng = np.random.default_rng(seed)
        frames = frames + rng.normal(0.0, noise_sigma, frames.shape)
    return np.clip(frames, 0, 255).astype(np.uint8)


def aligned_errors(est: list[np.ndarray], gt: list[np.ndarray]) -> np.ndarray:
    """Per-frame position error after Sim3 (Umeyama) alignment of the
    estimated camera centers onto ground truth (scale is unobservable in
    monocular SLAM). Returns [n] distances; ate_rmse is their RMS."""
    pe = np.array([-T[:3, :3].T @ T[:3, 3] for T in est])
    pg = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    ec, gc = pe - mu_e, pg - mu_g
    cov = gc.T @ ec / len(pe)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (ec**2).sum() / len(pe)
    scale = np.trace(np.diag(d) @ S) / max(var_e, 1e-12)
    t = mu_g - scale * R @ mu_e
    aligned = (scale * (R @ pe.T)).T + t
    return np.linalg.norm(aligned - pg, axis=1)


def ate_rmse(est: list[np.ndarray], gt: list[np.ndarray]) -> float:
    """Absolute trajectory error after Sim3 (Umeyama) alignment — the
    standard monocular evaluation (scale is unobservable)."""
    return float(np.sqrt((aligned_errors(est, gt) ** 2).mean()))
