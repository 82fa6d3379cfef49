"""Batched RANSAC PnP: camera pose from 3D-2D correspondences. Port of
os1_tpu/solvers/pnp.py (the reference's PnPsolver, used by relocalization,
Tracking.cc:1015).

Every sample of 6 correspondences gives two hypotheses: the 6-point DLT
system, one 12x12 symmetric ``eigh`` of the same shape for all 256 samples,
and the pose from the homography of the sample's best-fit plane (a 9x9
``eigh``), so the RANSAC iterations run as one batched solve. The plane
hypothesis is the port's: the JAX package solves the DLT alone, which
coplanar points leave undetermined, so it relocalizes in front of a single
wall only by rounding noise. The best hypothesis is refit on all its inliers
(a weighted DLT) and kept if the refit scores at least as well. The caller
polishes the pose with the LM pose optimization, as in the reference.

The draw is an argument: ``sampler(valid [..., N] bool, iters, k) -> [...,
iters, k]`` indices of valid correspondences (the relocalizer passes a
``solvers.initializer.GumbelSampler``; a test replays the JAX package's
draw). Any leading batch dimensions of ``points`` and ``valid`` are
independent problems: relocalization solves its candidates as lanes of one
call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3

ITERS = 256
SAMPLE = 6
CHI2 = 5.991


class PnPResult(NamedTuple):
    success: torch.Tensor  # [...] bool
    Tcw: torch.Tensor  # [..., 4, 4]
    inliers: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor  # [...] int64


def _dlt_pose(X: torch.Tensor, uv_n: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """[..., s, 3] world points and [..., s, 2] normalized image coordinates
    (rows weighted by ``w`` [..., s] when given) -> the [..., 3, 4] DLT
    projection, up to scale."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zero = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zero, -uv_n[..., 0:1] * Xh], dim=-1)
    rows_v = torch.cat([zero, Xh, -uv_n[..., 1:2] * Xh], dim=-1)
    if w is not None:
        rows_u, rows_v = rows_u * w[..., None], rows_v * w[..., None]
    A = torch.cat([rows_u, rows_v], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))


def _pose_from_P(P: torch.Tensor, X_ref: torch.Tensor) -> torch.Tensor:
    """Orthogonalize a DLT [..., 3, 4] into SE3, fixing scale and cheirality
    with a reference world point [..., 3] (the sample centroid)."""
    M = P[..., :3]
    scale = torch.pow(torch.abs(torch.linalg.det(M)) + 1e-12, 1.0 / 3.0)
    sign_z = torch.sign(torch.sum(M[..., 2, :] * X_ref, dim=-1) + P[..., 2, 3])
    P = P * (sign_z / scale)[..., None, None]
    return se3.from_Rt(se3.normalize_rotation(P[..., :3]), P[..., 3])


def _plane_pose(X: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """[..., s, 3] world points taken as coplanar and [..., s, 2] normalized
    image coordinates -> the [..., 4, 4] pose from the plane-to-image
    homography. The plane is the samples' best-fit plane (its two widest
    principal axes); the homography's first two columns are the rotation's
    first two, up to scale, and the third the translation of the centroid.
    The DLT's 12 unknowns are not determined by coplanar points (the plane
    leaves three directions of the system free), and the walls of a room
    are planes."""
    c = X.mean(dim=-2)
    Xc = X - c[..., None, :]
    _, axes = torch.linalg.eigh(Xc.transpose(-1, -2) @ Xc)
    e1, e2 = axes[..., :, 2], axes[..., :, 1]
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)  # plane -> world
    ab = Xc @ B[..., :2]  # [..., s, 2] plane coordinates
    abh = torch.cat([ab, torch.ones_like(ab[..., :1])], dim=-1)
    zero = torch.zeros_like(abh)
    rows_u = torch.cat([abh, zero, -uv_n[..., 0:1] * abh], dim=-1)
    rows_v = torch.cat([zero, abh, -uv_n[..., 1:2] * abh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 2.0 / (torch.linalg.norm(h1, dim=-1) + torch.linalg.norm(h2, dim=-1) + 1e-12)
    lam = lam * torch.where(h3[..., 2] < 0, -torch.ones_like(lam), torch.ones_like(lam))
    r1, r2, t = h1 * lam[..., None], h2 * lam[..., None], h3 * lam[..., None]
    Rp = se3.normalize_rotation(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1))
    R = Rp @ B.transpose(-1, -2)
    return se3.from_Rt(R, t - (R @ c[..., None])[..., 0])


def _reproj_err(T, points, uv, sigma2, intr):
    """(chi2 error, depth) of every correspondence under T."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pc = se3.transform(T, points)
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, torch.full_like(pc[..., 2], 1e-8), pc[..., 2])
    pu = fx * pc[..., 0] / z + cx
    pv = fy * pc[..., 1] / z + cy
    err = ((pu - uv[..., 0]) ** 2 + (pv - uv[..., 1]) ** 2) / torch.clamp(sigma2, min=1e-8)
    return err, pc[..., 2]


def solve_pnp(points: torch.Tensor, uv: torch.Tensor, sigma2: torch.Tensor,
              valid: torch.Tensor, intr: torch.Tensor, sampler,
              min_inliers: int = 10) -> PnPResult:
    """RANSAC pose from [..., N, 3] world points and [N, 2] undistorted pixels
    (``uv`` and ``sigma2`` [N] may carry the batch dimensions too), under the
    [..., N] mask ``valid``."""
    lead = valid.shape[:-1]
    n = valid.shape[-1]
    B = int(torch.Size(lead).numel())
    pts = points.expand(lead + (n, 3)).reshape(B, n, 3)
    uv = uv.expand(lead + (n, 2)).reshape(B, n, 2)
    sigma2 = sigma2.expand(lead + (n,)).reshape(B, n)
    valid = valid.reshape(B, n)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    uv_n = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)

    idx = sampler(valid, ITERS, SAMPLE).reshape(B, ITERS, SAMPLE)
    lane = torch.arange(B, device=idx.device)[:, None, None]
    X = pts[lane, idx]  # [B, I, s, 3]
    # Two hypotheses a sample: the DLT, and the plane pose for a sample that
    # lies on a plane; the DLT's come first, so they win ties.
    T = torch.cat([_pose_from_P(_dlt_pose(X, uv_n[lane, idx]), X.mean(dim=-2)),
                   _plane_pose(X, uv_n[lane, idx])], dim=1)  # [B, 2I, 4, 4]

    # Score every hypothesis against all correspondences.
    err, z = _reproj_err(T, pts[:, None], uv[:, None], sigma2[:, None], intr)
    inl = (err < CHI2) & (z > 0) & valid[:, None, :]
    counts = inl.sum(-1)  # [B, I]
    best = torch.argmax(counts, dim=-1)  # first maximum
    rows = torch.arange(B, device=idx.device)
    best_inl = inl[rows, best]
    best_count = counts[rows, best]

    # Refit on the best hypothesis's inliers (weighted full DLT), re-score.
    w = best_inl.to(pts.dtype)
    cen = torch.sum(pts * w[..., None], dim=-2) / torch.clamp(torch.sum(w, -1), min=1.0)[:, None]
    T_ref = _pose_from_P(_dlt_pose(pts, uv_n, w), cen)
    err2, z2 = _reproj_err(T_ref, pts, uv, sigma2, intr)
    inl2 = (err2 < CHI2) & (z2 > 0) & valid
    use_refined = inl2.sum(-1) >= best_count
    T_out = torch.where(use_refined[:, None, None], T_ref, T[rows, best])
    inl_out = torch.where(use_refined[:, None], inl2, best_inl)
    n_out = inl_out.sum(-1)
    return PnPResult(success=(n_out >= min_inliers).reshape(lead),
                     Tcw=T_out.reshape(lead + (4, 4)), inliers=inl_out.reshape(lead + (n,)),
                     n_inliers=n_out.reshape(lead))
