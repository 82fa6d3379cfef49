"""SE(3) Lie-group operations on torch tensors (port of os1_tpu/geometry/se3.py).

Conventions as in the reference package: a rigid transform ``T`` is a
(..., 4, 4) matrix ``[[R, t], [0, 1]]``; world-to-camera is ``Tcw``; tangent
vectors are (..., 6) ``xi = [rho (3), phi (3)]``, translation first. Every
function broadcasts over leading batch dimensions and runs on the device of
its inputs.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _safe_norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-37)


def _sinc(theta):
    small = torch.abs(theta) < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta):
    small = torch.abs(theta) < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 0.5 - theta * theta / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye3(phi, K.shape) + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map (..., 3, 3) -> (..., 3). Valid for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    near_pi = theta > 3.0
    tiny = torch.abs(sin_theta) < 1e-6
    factor = torch.where(tiny, torch.ones_like(theta),
                         theta / torch.where(tiny, torch.ones_like(theta), sin_theta))
    phi_generic = factor[..., None] * w
    one_minus_cos = torch.clamp(1.0 - cos_theta, min=1e-8)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / one_minus_cos[..., None], min=0.0)
    sign = torch.where(w >= 0, 1.0, -1.0)
    phi_pi = theta[..., None] * torch.sqrt(axis_sq) * sign
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    b = _cosc(theta)
    c = torch.where(small, 1.0 / 6.0 - theta * theta / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    return _eye3(phi, K.shape) + b[..., None, None] * K + c[..., None, None] * K2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)
    K = hat(phi)
    K2 = K @ K
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe),
    )
    return _eye3(phi, K.shape) - 0.5 * K + cot_term[..., None, None] * K2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_Rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """se(3) logarithm: (..., 4, 4) -> (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # [0, 0, 0, 1] made on the device: a row built from host data would be a
    # blocking host-to-device copy on a card, a stream synchronisation.
    zero = torch.zeros_like(t[..., None, :])
    bottom = torch.cat([zero, torch.ones_like(zero[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) or (..., 3) points."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if points.ndim == T.ndim:  # (..., N, 3): batch dims match, extra N axis
        return points @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ points[..., None])[..., 0] + t


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """Camera center in world coords: -R^T t."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w]
    (Shepperd-style branch selection on the largest diagonal term)."""
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def s_of(t):
        return torch.sqrt(torch.clamp(t, min=_EPS)) * 2.0

    s0, s1, s2, s3 = s_of(t0), s_of(t1), s_of(t2), s_of(t3)
    q0 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s0, (m[..., 0, 2] - m[..., 2, 0]) / s0,
                      (m[..., 1, 0] - m[..., 0, 1]) / s0, 0.25 * s0], dim=-1)
    q1 = torch.stack([0.25 * s1, (m[..., 0, 1] + m[..., 1, 0]) / s1,
                      (m[..., 0, 2] + m[..., 2, 0]) / s1, (m[..., 2, 1] - m[..., 1, 2]) / s1], dim=-1)
    q2 = torch.stack([(m[..., 0, 1] + m[..., 1, 0]) / s2, 0.25 * s2,
                      (m[..., 1, 2] + m[..., 2, 1]) / s2, (m[..., 0, 2] - m[..., 2, 0]) / s2], dim=-1)
    q3 = torch.stack([(m[..., 0, 2] + m[..., 2, 0]) / s3, (m[..., 1, 2] + m[..., 2, 1]) / s3,
                      0.25 * s3, (m[..., 1, 0] - m[..., 0, 1]) / s3], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    which = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)
    q = torch.gather(qs, -2, which[..., None, None].expand(which.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) near-rotations back onto SO(3) via SVD."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    S = torch.stack([one, one, det], dim=-1)
    return (U * S[..., None, :]) @ Vt
