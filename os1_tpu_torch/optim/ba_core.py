"""Bundle adjustment with an explicit Schur complement (g2o BlockSolver_6_3
replacement). Port of os1_tpu/optim/ba_core.py.

Observations are grouped by point in padded [P, O] arrays; landmarks are
marginalized as batched 3x3 inverses and the reduced [C, C, 6, 6] camera
system is solved densely. The reduced system is summed with fixed-order
contractions (no float atomics), so a rerun gives the same bits. LM damping
with branchless accept/reject: no value is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..geometry import se3
from . import reprojection as rp

CHI2_MONO = 5.991

# Padded problem buckets of the reference's local mapper
# (os1_tpu/pipeline/local_mapping.py:36-37); the initial two-view BA uses the
# smallest bucket that holds its points, so its arithmetic matches.
P_BUCKETS = (2048, 8192)  # point capacity
C_BUCKETS = (32, 64)  # camera capacity


class BAProblem(NamedTuple):
    cam_T: torch.Tensor  # [C, 4, 4] world-to-camera poses
    cam_fixed: torch.Tensor  # [C] bool
    points: torch.Tensor  # [P, 3]
    point_valid: torch.Tensor  # [P] bool
    obs_cam: torch.Tensor  # [P, O] int64 camera index per observation slot
    obs_uv: torch.Tensor  # [P, O, 2]
    obs_sigma2: torch.Tensor  # [P, O]
    obs_valid: torch.Tensor  # [P, O] bool
    intr: torch.Tensor  # [4]


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


class BAState(NamedTuple):
    """Resumable LM state (chunked iteration, as the reference package)."""

    cam_T: torch.Tensor
    points: torch.Tensor
    active: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def _zero_where_not(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _residuals_and_cost(prob: BAProblem, Tcw, X, active):
    """Masked residuals, chi2 and the robust (Huber) cost."""
    r = _zero_where_not(active[..., None], rp.residual(Tcw, X, prob.obs_uv, prob.intr))
    inv_s2 = 1.0 / torch.clamp(prob.obs_sigma2, min=1e-8)
    chi2 = torch.sum(r * r, dim=-1) * inv_s2
    d2 = rp.HUBER_MONO**2
    rho = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(chi2 * d2) - d2)
    return r, chi2, inv_s2, torch.sum(_zero_where_not(active, rho))


def _per_obs_terms(prob: BAProblem, cam_T, points, active):
    Tcw = cam_T[prob.obs_cam]  # [P, O, 4, 4]
    X = points[:, None, :].expand(prob.obs_uv.shape[:2] + (3,))
    r, chi2, inv_s2, cost = _residuals_and_cost(prob, Tcw, X, active)
    J_c, J_p = rp.jacobians(Tcw, X, prob.intr)
    J_c = _zero_where_not(active[..., None, None], J_c)
    J_p = _zero_where_not(active[..., None, None], J_p)
    w = _zero_where_not(active, rp.huber_weight(chi2, rp.HUBER_MONO) * inv_s2)
    return r, J_c, J_p, w, cost


def _cost_only(prob, cam_T, points, active):
    """The robust cost alone (no Jacobians): the same arithmetic as
    :func:`_per_obs_terms`'s cost."""
    X = points[:, None, :].expand(prob.obs_uv.shape[:2] + (3,))
    return _residuals_and_cost(prob, cam_T[prob.obs_cam], X, active)[3]


def assemble_reduced(prob: BAProblem, cam_T, points, active, lam):
    """Point-marginalized camera system: (S [C, C, 6, 6], b_red [C, 6],
    H_pp_inv [P, 3, 3], W [P, O, 6, 3], b_p [P, 3])."""
    C = cam_T.shape[0]
    r, J_c, J_p, w, _ = _per_obs_terms(prob, cam_T, points, active)
    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    H_pp = torch.einsum("poki,po,pokj->pij", J_p, w, J_p)
    b_p = torch.einsum("poki,po,pok->pi", J_p, w, r)
    tr = H_pp[:, 0, 0] + H_pp[:, 1, 1] + H_pp[:, 2, 2]
    H_pp = H_pp + lam * eye3 * torch.clamp(tr[:, None, None] / 3.0, min=1e-6)
    pv = prob.point_valid
    H_pp = torch.where(pv[:, None, None], H_pp, eye3)
    b_p = _zero_where_not(pv[:, None], b_p)
    H_pp_inv = torch.linalg.inv_ex(H_pp)[0]

    Hc_o = torch.einsum("poki,po,pokj->poij", J_c, w, J_c)  # [P, O, 6, 6]
    W = torch.einsum("poki,po,pokj->poij", J_c, w, J_p)  # [P, O, 6, 3]
    b_co = torch.einsum("poki,po,pok->poi", J_c, w, r)  # [P, O, 6]
    Y = torch.einsum("poij,pjk->poik", W, H_pp_inv)  # [P, O, 6, 3]

    # Camera one-hot over observation slots: fixed-order contractions.
    E = F.one_hot(prob.obs_cam, C).to(cam_T.dtype)  # [P, O, C]
    S_diag = torch.einsum("poc,poij->cij", E, Hc_o)
    A = torch.einsum("poc,poik->pcik", E, Y)
    B = torch.einsum("poc,pojk->pcjk", E, W)
    S = -torch.einsum("pcik,pdjk->cdij", A, B)
    ar = torch.arange(C, device=S.device)
    S[ar, ar] = S[ar, ar] + S_diag
    b_c = torch.einsum("poc,poi->ci", E, b_co)
    corr = torch.einsum("poc,poij,pj->ci", E, Y, b_p)
    return S, b_c - corr, H_pp_inv, W, b_p


def solve_cameras(S, b_red, cam_fixed, lam):
    """Damp, project out fixed cameras, and densely solve. -> delta_c [C, 6]."""
    C = S.shape[0]
    dev, dt = S.device, S.dtype
    ar = torch.arange(C, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = S[ar, ar]
    tr = torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)
    S = S.clone()
    S[ar, ar] = diag + lam * eye6 * torch.clamp(tr[:, None, None] / 6.0, min=1e-6)
    free = ~cam_fixed
    mask2 = free[:, None] & free[None, :]
    S = _zero_where_not(mask2[:, :, None, None], S)
    S[ar, ar] = S[ar, ar] + torch.where(free[:, None, None], torch.zeros_like(eye6), eye6)
    b_red = _zero_where_not(free[:, None], b_red)
    S_full = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    eye = torch.eye(C * 6, dtype=dt, device=dev)
    delta = -torch.linalg.solve_ex(S_full + 1e-9 * eye, b_red.reshape(-1, 1))[0].reshape(C, 6)
    return _zero_where_not(free[:, None], delta)


def backsub_points(prob: BAProblem, delta_c, H_pp_inv, W, b_p):
    """H_pp dp = -(b_p + sum_o W^T dc)."""
    dc_per_obs = delta_c[prob.obs_cam]
    wtd = torch.einsum("poij,poi->pj", W, dc_per_obs)
    delta_p = -torch.einsum("pij,pj->pi", H_pp_inv, b_p + wtd)
    return _zero_where_not(prob.point_valid[:, None], delta_p)


def _schur_step(prob, cam_T, points, active, lam):
    S, b_red, H_pp_inv, W, b_p = assemble_reduced(prob, cam_T, points, active, lam)
    delta_c = solve_cameras(S, b_red, prob.cam_fixed, lam)
    delta_p = backsub_points(prob, delta_c, H_pp_inv, W, b_p)
    return se3.exp(delta_c) @ cam_T, points + delta_p


def classify_obs(prob: BAProblem, cam_T, points, chi2_th: float = CHI2_MONO):
    """Final inlier classification: chi2 gate + positive depth."""
    Tcw = cam_T[prob.obs_cam]
    X = points[:, None, :].expand(prob.obs_uv.shape[:2] + (3,))
    pc, uv = rp.project_point(Tcw, X, prob.intr)
    r = uv - prob.obs_uv
    chi2 = torch.sum(r * r, dim=-1) / torch.clamp(prob.obs_sigma2, min=1e-8)
    return prob.obs_valid & (chi2 <= chi2_th) & (pc[..., 2] > 0)


def ba_begin(prob: BAProblem, lam0: float = 1e-4) -> BAState:
    lam = torch.tensor(lam0, dtype=prob.points.dtype, device=prob.points.device)
    return BAState(cam_T=prob.cam_T, points=prob.points, active=prob.obs_valid, lam=lam,
                   cost=_cost_only(prob, prob.cam_T, prob.points, prob.obs_valid))


def ba_iterate(prob: BAProblem, state: BAState, n: int) -> BAState:
    """n damped-LM iterations with branchless accept/reject."""
    cam_T, points, lam, cost = state.cam_T, state.points, state.lam, state.cost
    for _ in range(n):
        cand_T, cand_p = _schur_step(prob, cam_T, points, state.active, lam)
        new_cost = _cost_only(prob, cand_T, cand_p, state.active)
        ok = new_cost < cost
        cam_T = torch.where(ok, cand_T, cam_T)
        points = torch.where(ok, cand_p, points)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
        cost = torch.where(ok, new_cost, cost)
    return BAState(cam_T=cam_T, points=points, active=state.active, lam=lam, cost=cost)


def ba_reclassify(prob: BAProblem, state: BAState, lam0: float = 1e-4) -> BAState:
    """Drop chi2/depth outliers from the active set and reset the damping: the
    boundary between the reference's 5- and 10-iteration local-BA phases
    (Optimizer.cc:466-510)."""
    active = classify_obs(prob, state.cam_T, state.points)
    lam = torch.tensor(lam0, dtype=prob.points.dtype, device=prob.points.device)
    return BAState(cam_T=state.cam_T, points=state.points, active=active, lam=lam,
                   cost=_cost_only(prob, state.cam_T, state.points, active))


def ba_result(prob: BAProblem, state: BAState) -> BAResult:
    return BAResult(cam_T=state.cam_T, points=state.points,
                    obs_inlier=classify_obs(prob, state.cam_T, state.points), cost=state.cost)
