"""Sim(3) similarity transforms on torch tensors (port of
os1_tpu/geometry/sim3.py; the reference's g2o Sim3 machinery for monocular
loop closing with scale drift, LoopClosing.cc:234-405, Optimizer.cc:591-863).

A Sim3 element ``S = [[s*R, t], [0, 1]]`` is a (..., 4, 4) matrix or the tuple
``(R, t, s)``; tangent vectors are (..., 7) ``xi = [rho (3), phi (3), sigma]``
with ``sigma = log s``. Every function broadcasts over leading dimensions and
is safe under forward-mode AD (``torch.func.jvp``): the guarded branches
compute on safe operands, so an untaken branch produces no NaN.
"""
from __future__ import annotations

import torch

from . import se3


def from_Rts(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation, translation and scale."""
    return se3.from_Rt(R * s[..., None, None], t)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors: elementwise, so it costs no
    LU factorization on the card and differentiates in forward mode."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def to_Rts(S: torch.Tensor):
    """Split (..., 4, 4) into (R, t, s)."""
    sR = S[..., :3, :3]
    s = torch.pow(torch.clamp(_det3(sR), min=1e-12), 1.0 / 3.0)
    return sR / s[..., None, None], S[..., :3, 3], s


def inverse(S: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: (1/s, R^T, -(1/s) R^T t)."""
    R, t, s = to_Rts(S)
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return from_Rts(Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0], inv_s)


def transform(S: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    return se3.transform(S, points)


def _coeffs(theta, sigma):
    """Coefficients (A, B, C) of W = A*K + B*K^2 + C*I for the Sim3 exp
    (Strasdat's closed form), with the reference's guarded Taylor branches
    near sigma = 0 and theta = 0."""
    eps = 1e-5
    one = torch.ones_like(sigma)
    s = torch.exp(sigma)
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    safe_sig = torch.where(sig_small, one, sigma)
    safe_th = torch.where(th_small, torch.ones_like(theta), theta)
    th2 = safe_th * safe_th

    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sig)
    sin_t, cos_t = torch.sin(safe_th), torch.cos(safe_th)

    # sigma == 0: the SE3 coefficients.
    a_ss = torch.where(th_small, 0.5 - theta * theta / 24.0, (1.0 - cos_t) / th2)
    b_ss = torch.where(th_small, 1.0 / 6.0 - theta * theta / 120.0,
                       (safe_th - sin_t) / (th2 * safe_th))
    # sigma != 0, theta == 0.
    a_s0 = torch.where(sig_small, 0.5 * one, ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig))
    b_s0 = torch.where(sig_small, one / 6.0,
                       (s * (0.5 * safe_sig * safe_sig - safe_sig + 1.0) - 1.0) / (safe_sig ** 3))
    # General case.
    denom = safe_sig * safe_sig + th2
    a_gen = (s * sin_t * safe_sig + (1.0 - s * cos_t) * safe_th) / (safe_th * denom)
    b_gen = (C - ((s * cos_t - 1.0) * safe_sig + s * sin_t * safe_th) / denom) / th2

    A = torch.where(sig_small, a_ss, torch.where(th_small, a_s0, a_gen))
    B = torch.where(sig_small, b_ss, torch.where(th_small, b_s0, b_gen))
    return A, B, C


def _W(phi, sigma):
    theta = se3._safe_norm(phi)
    K = se3.hat(phi)
    A, B, C = _coeffs(theta, sigma)
    eye = se3._eye3(phi, K.shape)
    return A[..., None, None] * K + B[..., None, None] * (K @ K) + C[..., None, None] * eye


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential: (..., 7) [rho, phi, sigma] -> (..., 4, 4)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_W(phi, sigma) @ rho[..., None])[..., 0]
    return from_Rts(se3.so3_exp(phi), t, torch.exp(sigma))


def log(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm: (..., 4, 4) -> (..., 7) [rho, phi, sigma]."""
    R, t, s = to_Rts(S)
    sigma = torch.log(s)
    phi = se3.so3_log(R)
    rho = torch.linalg.solve_ex(_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def compose(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Matrix product of two Sim3s."""
    return S1 @ S2


def from_se3(T: torch.Tensor) -> torch.Tensor:
    """An SE3 matrix is the Sim3 of scale 1."""
    return T


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Project to SE3: keep the rotation, divide the translation by the scale
    (Optimizer.cc:824-840, ``Tiw = [R, t/s]``)."""
    R, t, s = to_Rts(S)
    return se3.from_Rt(R, t / s[..., None])


# The reference's vmapped forms: every function above broadcasts already.
exp_batch = exp
log_batch = log
