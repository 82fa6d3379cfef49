"""Sim3 refinement between two keyframes. Port of os1_tpu/optim/sim3_opt.py
(reference Optimizer::OptimizeSim3, Optimizer.cc:865-1063: one Sim3 vertex
with inverse-pair projection edges, 10 LM iterations, the chi2 = 10 outlier
cut, 10 more).

LM over the 7-dim tangent, Huber IRLS at sqrt(10). The reference takes the
Jacobians by ``jax.jacfwd`` of the residuals at zero; the port writes them
out (:func:`_linearize`, held against forward-mode autodiff in the tests):
the autodiff form is tens of thousands of small kernels a solve on the card.
The accept/reject is branchless: nothing is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, sim3
from .reprojection import huber_weight

CHI2_SIM3 = 9.99  # reference th2 = 10
HUBER_SIM3 = 3.1623  # sqrt(10), the reference's deltaHuber on Sim3 edges


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int64 scalar


def _project(intr, pc):
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, torch.full_like(pc[..., 2], 1e-8), pc[..., 2])
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)


def _residuals(xi, S0, x1, x2, uv1, uv2, intr):
    """Stacked two-way reprojection residuals [..., 2N, 2] of
    S12 = exp(xi) @ S0 (xi [..., 7])."""
    return _residuals_at(sim3.exp(xi) @ S0, x1, x2, uv1, uv2, intr)


def _residuals_at(S12, x1, x2, uv1, uv2, intr):
    """:func:`_residuals` at xi = 0, where exp(xi) is the identity exactly."""
    S21 = sim3.inverse(S12)
    lead = S12.shape[:-2]
    r1 = _project(intr, sim3.transform(S12, x2.expand(lead + x2.shape))) - uv1
    r2 = _project(intr, sim3.transform(S21, x1.expand(lead + x1.shape))) - uv2
    return torch.cat([r1, r2], dim=-2)


def _dproj(intr, pc):
    """d(pixel)/d(camera point) [..., 2, 3] of :func:`_project`."""
    fx, fy = intr[0], intr[1]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, torch.full_like(pc[..., 2], 1e-8), pc[..., 2])
    zi = 1.0 / z
    zero = torch.zeros_like(zi)
    return torch.stack([torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi], -1),
                        torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi], -1)], -2)


def _linearize(S12, x1, x2, uv1, uv2, intr):
    """(:func:`_residuals_at` [2N, 2], its Jacobian [2N, 2, 7] at xi = 0).
    To first order exp(xi) q = q + rho + phi x q + sigma q, so a camera-1
    point q = S12 x2 moves by [I, -[q]x, q] xi, and a camera-2 point S21 x1
    (S21 = S12^-1, which takes exp(-xi) on its right) by -A21 [I, -[x1]x, x1]
    xi, with A21 the 3x3 block of S21."""
    S21 = sim3.inverse(S12)
    q1 = sim3.transform(S12, x2)
    q2 = sim3.transform(S21, x1)
    r = torch.cat([_project(intr, q1) - uv1, _project(intr, q2) - uv2], dim=0)
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(x1.shape[:-1] + (3, 3))
    G1 = torch.cat([eye, -se3.hat(q1), q1[..., None]], dim=-1)  # [N, 3, 7]
    G2 = -S21[:3, :3] @ torch.cat([eye, -se3.hat(x1), x1[..., None]], dim=-1)
    return r, torch.cat([_dproj(intr, q1) @ G1, _dproj(intr, q2) @ G2], dim=0)


def optimize_sim3(S12_0, x1, x2, valid, uv1, uv2, sigma2_1, sigma2_2, intr,
                  iters: int = 10) -> Sim3OptResult:
    """Refine S12 (x1 ~ S12 x2, camera frames) over the pairs ``valid`` [N]."""
    n = x1.shape[0]
    inv_s2 = torch.cat([1.0 / torch.clamp(sigma2_1, min=1e-8),
                        1.0 / torch.clamp(sigma2_2, min=1e-8)])

    def chi2_of(S12, active2):
        r = _residuals_at(S12, x1, x2, uv1, uv2, intr)
        c = torch.sum(r * r, dim=-1) * inv_s2
        return torch.where(active2, c, torch.zeros_like(c))

    def robust_cost(S12, active2):
        c = chi2_of(S12, active2)
        d2 = 10.0
        rho = torch.where(c <= d2, c, 2.0 * torch.sqrt(c * d2) - d2)
        return torch.sum(torch.where(active2, rho, torch.zeros_like(rho)))

    def lm(S12, active2, n_iters):
        lam = torch.tensor(1e-3, dtype=x1.dtype, device=x1.device)
        cost = robust_cost(S12, active2)
        eye7 = torch.eye(7, dtype=x1.dtype, device=x1.device)
        for _ in range(n_iters):
            r, J = _linearize(S12, x1, x2, uv1, uv2, intr)
            chi2 = torch.sum(r * r, dim=-1) * inv_s2
            w = huber_weight(chi2, HUBER_SIM3) * torch.where(active2, inv_s2,
                                                             torch.zeros_like(inv_s2))
            H = torch.einsum("nki,n,nkj->ij", J, w, J)
            b = torch.einsum("nki,n,nk->i", J, w, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            delta = -torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
            S_new = sim3.exp(delta) @ S12
            new_cost = robust_cost(S_new, active2)
            ok = new_cost < cost
            S12 = torch.where(ok, S_new, S12)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
            cost = torch.where(ok, new_cost, cost)
        return S12

    def pair_bad(S12, active2):
        c = chi2_of(S12, active2)
        return (c[:n] > CHI2_SIM3) | (c[n:] > CHI2_SIM3)

    active2 = torch.cat([valid, valid])
    S12 = lm(S12_0, active2, iters)
    # Outlier removal and the second round (Optimizer.cc:987-1037).
    inlier = valid & ~pair_bad(S12, active2)
    active2 = torch.cat([inlier, inlier])
    S12 = lm(S12, active2, iters)
    inlier = inlier & ~pair_bad(S12, active2)
    return Sim3OptResult(S12=S12, inliers=inlier, n_inliers=inlier.sum())
