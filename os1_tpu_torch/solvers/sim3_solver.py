"""Batched RANSAC Sim(3) alignment between two keyframes' matched 3D points.
Port of os1_tpu/solvers/sim3_solver.py (reference Sim3Solver.cc: Horn's
closed-form absolute orientation with scale, Sim3Solver.cc:229-342, in a
RANSAC; here the 128 hypotheses are one batch of 4x4 symmetric ``eigh``).

Convention: S12 maps camera-2 coordinates to camera 1, ``x1 ~ S12 @ x2``.

The draw is an argument: ``sampler(valid [N] bool, iters, k) -> [iters, k]``
indices of valid pairs (the loop closer passes a
``solvers.initializer.GumbelSampler``; a test replays the JAX package's
draw).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3

ITERS = 128
SAMPLE = 3
CHI2 = 9.21  # 2-dof 99% (reference mvnMaxError 9.210 * sigma^2)


class Sim3Result(NamedTuple):
    success: torch.Tensor  # bool scalar
    S12: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int64 scalar


def _quat_rotation(q):
    """Rotation of the unit quaternion [..., 4] = [w, x, y, z]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _horn_rotation(M):
    """Horn's optimal rotation for the cross-covariance M [..., 3, 3]
    (2 -> 1): the top eigenvector of the 4x4 N matrix."""
    S = lambda i, j: M[..., i, j]  # noqa: E731
    N = torch.stack([
        torch.stack([S(0, 0) + S(1, 1) + S(2, 2), S(1, 2) - S(2, 1), S(2, 0) - S(0, 2),
                     S(0, 1) - S(1, 0)], -1),
        torch.stack([S(1, 2) - S(2, 1), S(0, 0) - S(1, 1) - S(2, 2), S(0, 1) + S(1, 0),
                     S(2, 0) + S(0, 2)], -1),
        torch.stack([S(2, 0) - S(0, 2), S(0, 1) + S(1, 0), -S(0, 0) + S(1, 1) - S(2, 2),
                     S(1, 2) + S(2, 1)], -1),
        torch.stack([S(0, 1) - S(1, 0), S(2, 0) + S(0, 2), S(1, 2) + S(2, 1),
                     -S(0, 0) - S(1, 1) + S(2, 2)], -1),
    ], dim=-2)
    _, vecs = torch.linalg.eigh(N)
    return _quat_rotation(vecs[..., :, -1])


def _horn(p1, p2):
    """Closed-form Sim3 from [..., s, 3] point sets (x1 ~ s R x2 + t)."""
    c1 = p1.mean(dim=-2)
    c2 = p2.mean(dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    R = _horn_rotation(q2.transpose(-1, -2) @ q1)
    # Scale, the reference's asymmetric form: <q1, R q2> / |q2|^2.
    rot_q2 = q2 @ R.transpose(-1, -2)
    s = torch.sum(q1 * rot_q2, dim=(-2, -1)) / torch.clamp(torch.sum(q2 * q2, dim=(-2, -1)),
                                                         min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


def _project(intr, pc):
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, torch.full_like(pc[..., 2], 1e-8), pc[..., 2])
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)


def solve_sim3(x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, intr, sampler,
               min_inliers: int = 20, fix_scale: bool = False) -> Sim3Result:
    """RANSAC Horn alignment of [N, 3] camera-frame pairs with the two-way
    reprojection inlier check (Sim3Solver::CheckInliers). min_inliers=20 is
    LoopClosing.cc:297."""
    idx = sampler(valid, ITERS, SAMPLE)  # [I, 3]
    R, t, s = _horn(x1[idx], x2[idx])
    s = torch.clamp(s, 0.01, 100.0)
    if fix_scale:
        s = torch.ones_like(s)
    inv_s2_1 = 1.0 / torch.clamp(sigma2_1, min=1e-8)
    inv_s2_2 = 1.0 / torch.clamp(sigma2_2, min=1e-8)

    def count_inliers(R, t, s):
        """[..., N] inlier masks of the hypotheses (R, t, s) [...]."""
        S12 = sim3.from_Rts(R, t, s)
        S21 = sim3.inverse(S12)
        lead = S12.shape[:-2]
        p1_from_2 = sim3.transform(S12, x2.expand(lead + x2.shape))
        p2_from_1 = sim3.transform(S21, x1.expand(lead + x1.shape))
        e1 = torch.sum((_project(intr, p1_from_2) - uv1) ** 2, dim=-1) * inv_s2_1
        e2 = torch.sum((_project(intr, p2_from_1) - uv2) ** 2, dim=-1) * inv_s2_2
        return ((e1 < CHI2) & (e2 < CHI2) & valid
                & (p1_from_2[..., 2] > 0) & (p2_from_1[..., 2] > 0))

    inl = count_inliers(R, t, s)  # [I, N]
    counts = inl.sum(-1)
    best = torch.argmax(counts)  # the first maximum

    # Weighted refit on the best hypothesis's inliers.
    w = inl[best].to(x1.dtype)
    sw = torch.clamp(torch.sum(w), min=1.0)
    c1 = torch.sum(x1 * w[:, None], dim=0) / sw
    c2 = torch.sum(x2 * w[:, None], dim=0) / sw
    d1, d2 = x1 - c1, x2 - c2
    Rr = _horn_rotation((d2 * w[:, None]).T @ d1)
    sr = torch.sum(d1 * (d2 @ Rr.T) * w[:, None]) / torch.clamp(
        torch.sum(d2 ** 2 * w[:, None]), min=1e-12)
    sr = torch.clamp(sr, 0.01, 100.0)
    if fix_scale:
        sr = torch.ones_like(sr)
    tr = c1 - sr * (Rr @ c2)
    inl_ref = count_inliers(Rr, tr, sr)
    use_ref = inl_ref.sum() >= counts[best]
    R_out = torch.where(use_ref, Rr, R[best])
    t_out = torch.where(use_ref, tr, t[best])
    s_out = torch.where(use_ref, sr, s[best])
    inl_out = torch.where(use_ref, inl_ref, inl[best])
    n_out = inl_out.sum()
    return Sim3Result(success=n_out >= min_inliers, S12=sim3.from_Rts(R_out, t_out, s_out),
                      inliers=inl_out, n_inliers=n_out)
