"""Monocular reprojection residuals and analytic Jacobians.
Port of os1_tpu/optim/reprojection.py.

Pose parametrization: left-multiplicative se3 increment, T <- exp(xi) @ T.
"""
from __future__ import annotations

import torch

from ..geometry import se3

HUBER_MONO = 2.447651  # sqrt(5.991), reference Optimizer.cc thHuber


def _safe_z(pc):
    z = pc[..., 2]
    return torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)


def project_point(Tcw, X, intr):
    """Camera-frame point and pixel projection on undistorted coords.
    intr: [4] (fx, fy, cx, cy). Returns (pc [..., 3], uv [..., 2])."""
    pc = se3.transform(Tcw, X)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = _safe_z(pc)
    uv = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)
    return pc, uv


def residual(Tcw, X, uv_obs, intr):
    """r = projection - measurement, [..., 2]."""
    _, uv = project_point(Tcw, X, intr)
    return uv - uv_obs


def _jac_proj_pc(pc, intr):
    """d(uv)/d(pc): [..., 2, 3]."""
    fx, fy = intr[0], intr[1]
    x, y = pc[..., 0], pc[..., 1]
    zi = 1.0 / _safe_z(pc)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row_v = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def jacobians(Tcw, X, intr):
    """(J_pose [..., 2, 6] for a left-multiplicative update, J_point [..., 2, 3])."""
    pc = se3.transform(Tcw, X)
    Jp = _jac_proj_pc(pc, intr)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    J_xi = torch.cat([eye, -se3.hat(pc)], dim=-1)  # [..., 3, 6]
    return Jp @ J_xi, Jp @ Tcw[..., :3, :3]


def huber_weight(chi2, delta: float):
    """IRLS weight of the Huber kernel at squared error chi2."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)
