"""Two-view triangulation: batched DLT + parallax / cheirality validation.
Port of os1_tpu/geometry/triangulation.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3

QINF_DISTANCE = 1e8


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous DLT (w = 1): solve the 3x3 normal equations by Cramer's
    rule. P1, P2: (..., 3, 4); x1, x2: (..., 2). Returns (..., 3)."""
    rows = torch.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )  # (..., 4, 4)
    B = rows[..., :3]
    b = rows[..., 3]
    G = B.transpose(-1, -2) @ B
    rhs = -torch.einsum("...ri,...r->...i", B, b)
    c00 = G[..., 1, 1] * G[..., 2, 2] - G[..., 1, 2] * G[..., 2, 1]
    c01 = G[..., 0, 2] * G[..., 2, 1] - G[..., 0, 1] * G[..., 2, 2]
    c02 = G[..., 0, 1] * G[..., 1, 2] - G[..., 0, 2] * G[..., 1, 1]
    c10 = G[..., 1, 2] * G[..., 2, 0] - G[..., 1, 0] * G[..., 2, 2]
    c11 = G[..., 0, 0] * G[..., 2, 2] - G[..., 0, 2] * G[..., 2, 0]
    c12 = G[..., 0, 2] * G[..., 1, 0] - G[..., 0, 0] * G[..., 1, 2]
    c20 = G[..., 1, 0] * G[..., 2, 1] - G[..., 1, 1] * G[..., 2, 0]
    c21 = G[..., 0, 1] * G[..., 2, 0] - G[..., 0, 0] * G[..., 2, 1]
    c22 = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
    det = G[..., 0, 0] * c00 + G[..., 0, 1] * c10 + G[..., 0, 2] * c20
    safe_det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return torch.einsum("...ij,...j->...i", adj, rhs) / safe_det[..., None]


class TriangulationCheck(NamedTuple):
    points: torch.Tensor  # (..., 3)
    valid: torch.Tensor  # (...,) bool
    far: torch.Tensor  # (...,) bool
    parallax_cos: torch.Tensor  # (...,)


def parallax_cosine(Tcw1: torch.Tensor, Tcw2: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle between the rays from both camera centers to xw."""
    O1 = se3.camera_center(Tcw1)
    O2 = se3.camera_center(Tcw2)
    r1 = xw - O1[..., None, :] if xw.ndim > O1.ndim else xw - O1
    r2 = xw - O2[..., None, :] if xw.ndim > O2.ndim else xw - O2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    nn = n1 * n2
    denom = torch.where(nn < 1e-12, torch.full_like(nn, 1e-12), nn)
    return torch.sum(r1 * r2, dim=-1) / denom


def validate(Tcw1, Tcw2, xw, uv1, uv2, project1, project2, sigma2_1, sigma2_2,
             rays1=None, cos_far_threshold: float = 0.9998,
             chi2_threshold: float = 5.991,
             enable_far_points: bool = False) -> TriangulationCheck:
    """Positive depth in both cameras, reprojection chi2 per level in both
    images, and a parallax gate; low-parallax candidates optionally routed to
    quasi-infinity along the first view's ray."""
    pc1 = se3.transform(Tcw1, xw)
    pc2 = se3.transform(Tcw2, xw)
    pos_depth = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)
    e1 = project1(pc1) - uv1
    e2 = project2(pc2) - uv2
    chi1 = torch.sum(e1 * e1, dim=-1) / torch.clamp(sigma2_1, min=1e-8)
    chi2_ = torch.sum(e2 * e2, dim=-1) / torch.clamp(sigma2_2, min=1e-8)
    reproj_ok = (chi1 < chi2_threshold) & (chi2_ < chi2_threshold)
    cosp = parallax_cosine(Tcw1, Tcw2, xw)
    good_parallax = cosp < cos_far_threshold
    valid = pos_depth & reproj_ok & good_parallax
    far = torch.zeros_like(valid)
    points = xw
    if enable_far_points and rays1 is not None:
        O1 = se3.camera_center(Tcw1)
        far_pts = O1 + rays1 * QINF_DISTANCE
        far = pos_depth & reproj_ok & (~good_parallax)
        points = torch.where(far[..., None], far_pts, xw)
    return TriangulationCheck(points=points, valid=valid, far=far, parallax_cos=cosp)


def median_depth(Tcw: torch.Tensor, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median scene depth of masked points in camera frame: the (count-1)//2-th
    order statistic of the sorted depths, masked entries at +inf."""
    z = se3.transform(Tcw, points)[..., 2]
    z = torch.where(mask, z, torch.full_like(z, float("inf")))
    z_sorted = torch.sort(z, dim=-1).values
    n = torch.sum(mask, dim=-1)
    idx = torch.clamp((n - 1) // 2, 0, z.shape[-1] - 1)
    return torch.gather(z_sorted, -1, idx[..., None])[..., 0]
