"""Sim3 pose-graph (essential graph) optimization. Port of
os1_tpu/optim/pose_graph.py (reference Optimizer::OptimizeEssentialGraph,
Optimizer.cc:591-863: spanning tree + strong covisibility + loop edges).

The residual of edge (i, j) with measurement S_ji is
``log(S_ji . S_i . S_j^-1)``. Left-multiplicative updates, the [E, 7, 14]
edge Jacobians by forward-mode autodiff over all edges at once
(``utils.numerics.jacfwd_rows``, the reference's vmapped ``jax.jacfwd``),
dense [7K, 7K] normal equations, LM with branchless accept/reject.

The normal equations are ``A^T A`` and ``A^T r`` of the dense edge Jacobian
``A`` [7E, 7K], which a one-hot contraction places: every node's blocks are
summed by a matrix product in a fixed order, not by scatter-adds (float
atomics on the card), so a rerun gives the same bits. The reference pads the
edge arrays to compile buckets; the port takes the edges as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import sim3
from ..utils.numerics import jacfwd_rows

LAM0 = 1e-4  # initial LM damping


def _edge_residual(xi, S_i, S_j, S_meas_ji):
    """[..., 7] residuals of edges at their stacked increments xi [..., 14]."""
    Si = sim3.exp(xi[..., :7]) @ S_i
    Sj = sim3.exp(xi[..., 7:]) @ S_j
    return sim3.log(S_meas_ji @ Si @ sim3.inverse(Sj))


def _edge_cost(S, edge_i, edge_j, edge_S):
    """Sum of squared residuals at the current poses."""
    r = sim3.log(edge_S @ S[edge_i] @ sim3.inverse(S[edge_j]))
    return torch.sum(r * r)


def normal_equations(S_cur, edge_i, edge_j, edge_S, Ei, Ej, edge_valid=None):
    """(H [K, K, 7, 7], b [K, 7]) of the edges at the current poses, by the
    one-hot contraction (module docstring); ``Ei``, ``Ej`` [E, K] are the
    edges' one-hot end nodes. Edges with ``edge_valid`` False add nothing."""
    K = S_cur.shape[0]
    zero14 = torch.zeros((edge_i.shape[0], 14), dtype=S_cur.dtype, device=S_cur.device)
    Si, Sj = S_cur[edge_i], S_cur[edge_j]
    r = _edge_residual(zero14, Si, Sj, edge_S)  # [E, 7]
    J = jacfwd_rows(lambda xi: _edge_residual(xi, Si, Sj, edge_S), zero14)  # [E, 7, 14]
    if edge_valid is not None:
        r = torch.where(edge_valid[:, None], r, torch.zeros_like(r))
        J = torch.where(edge_valid[:, None, None], J, torch.zeros_like(J))
    A = (torch.einsum("eki,ea->ekai", J[..., :7], Ei)
         + torch.einsum("eki,ea->ekai", J[..., 7:], Ej)).reshape(-1, K * 7)
    H = (A.T @ A).reshape(K, 7, K, 7).permute(0, 2, 1, 3)
    b = (A.T @ r.reshape(-1)).reshape(K, 7)
    return H, b


def damped_step(H, b, S_cur, lam, free):
    """Damping on the diagonal blocks, then the gauge (only ``free`` nodes
    move), the dense [7K, 7K] solve and the left-multiplicative update."""
    K = S_cur.shape[0]
    dev, dt = S_cur.device, S_cur.dtype
    eye7 = torch.eye(7, dtype=dt, device=dev)
    ar = torch.arange(K, device=dev)
    mask = (free[:, None] & free[None, :])[:, :, None, None]
    diag = H[ar, ar]
    tr = torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)
    H = H.clone()
    H[ar, ar] = diag + lam * eye7 * torch.clamp(tr[:, None, None] / 7.0, min=1e-6)
    H = torch.where(mask, H, torch.zeros_like(H))
    H[ar, ar] = H[ar, ar] + torch.where(free[:, None, None], torch.zeros_like(eye7), eye7)
    b = torch.where(free[:, None], b, torch.zeros_like(b))
    Hf = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    delta = -torch.linalg.solve_ex(Hf + 1e-9 * torch.eye(K * 7, dtype=dt, device=dev),
                                   b.reshape(-1, 1))[0].reshape(K, 7)
    delta = torch.where(free[:, None], delta, torch.zeros_like(delta))
    return sim3.exp(delta) @ S_cur


def optimize_pose_graph(S, kf_valid, fixed, edge_i, edge_j, edge_S, iters: int = 20):
    """S [K, 4, 4] Sim3 world -> camera per node; ``fixed`` [K] anchors the
    gauge; edges (edge_i, edge_j) [E] with measurements S_ji [E, 4, 4]."""
    K = S.shape[0]
    edge_i, edge_j = edge_i.long(), edge_j.long()
    free = kf_valid & ~fixed
    Ei = F.one_hot(edge_i, K).to(S.dtype)  # [E, K]
    Ej = F.one_hot(edge_j, K).to(S.dtype)

    S_cur = S
    lam = torch.full((), LAM0, dtype=S.dtype, device=S.device)
    cost = _edge_cost(S_cur, edge_i, edge_j, edge_S)
    for _ in range(iters):
        H, b = normal_equations(S_cur, edge_i, edge_j, edge_S, Ei, Ej)
        S_new = damped_step(H, b, S_cur, lam, free)
        new_cost = _edge_cost(S_new, edge_i, edge_j, edge_S)
        ok = new_cost < cost
        S_cur = torch.where(ok, S_new, S_cur)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
        cost = torch.where(ok, new_cost, cost)
    return S_cur
