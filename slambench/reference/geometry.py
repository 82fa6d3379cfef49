"""Plain geometry for judging poses and maps: the pinhole projection of
undistorted keypoints and the absolute trajectory error after a similarity
alignment (Umeyama), the standard evaluation of monocular SLAM, whose scale
is unobservable. numpy, float64; nothing of the program."""
from __future__ import annotations

import numpy as np


def project(Tcw: np.ndarray, X: np.ndarray, cam: dict) -> np.ndarray:
    """World points [n, 3] seen from the pose Tcw [4, 4] -> undistorted
    pixels [n, 2]."""
    pc = X @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = np.where(np.abs(pc[:, 2]) < 1e-12, 1e-12, pc[:, 2])
    return np.stack([cam["fx"] * pc[:, 0] / z + cam["cx"], cam["fy"] * pc[:, 1] / z + cam["cy"]],
                    axis=1)


def centres(Tcw: np.ndarray) -> np.ndarray:
    """Camera centres [n, 3] of poses [n, 4, 4]."""
    R, t = Tcw[:, :3, :3], Tcw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def ate_pct(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS distance between the estimated camera centres, aligned onto the
    ground truth's by the best similarity, and the ground truth's, in % of
    the ground truth's path length over the same frames."""
    pe, pg = centres(np.asarray(est, np.float64)), centres(np.asarray(gt, np.float64))
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    ec, gc = pe - mu_e, pg - mu_g
    U, d, Vt = np.linalg.svd(gc.T @ ec / len(pe))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(d) @ S) / max((ec ** 2).sum() / len(pe), 1e-300)
    aligned = s * ec @ R.T + mu_g
    rms = np.sqrt(((aligned - pg) ** 2).sum(1).mean())
    path = np.linalg.norm(np.diff(pg, axis=0), axis=1).sum()
    return float(100.0 * rms / max(path, 1e-12))
