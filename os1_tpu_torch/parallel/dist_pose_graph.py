"""Edge-sharded Sim3 pose-graph (essential graph) optimization over a mesh.
Port of os1_tpu/parallel/dist_pose_graph.py.

The edges shard over the mesh; each position builds the dense normal
equations H [K, K, 7, 7] and b [K, 7] of its own edges with the port's
fixed-order one-hot form (``optim.pose_graph.normal_equations``: forward-mode
edge Jacobians, ``A^T A`` and ``A^T r``, no scatter-adds), one
:func:`~.mesh.psum` per LM iteration sums them, and the damped [7K, 7K]
solve runs once per distinct device. Communication per iteration is O(K^2),
whatever the edge count, which is what grows with the trajectory
(covisibility edges, minFeat = 100, reference Optimizer.cc:591-863).
Padded edges (``edge_valid`` False: identity measurements at (0, 0)) add
exactly nothing to H, b or the cost.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry import sim3
from ..optim.pose_graph import LAM0, damped_step, normal_equations
from .mesh import Mesh, per_device, psum, replicate

def _shard_cost(S_cur, edge_i, edge_j, edge_S, edge_valid):
    r = sim3.log(edge_S @ S_cur[edge_i] @ sim3.inverse(S_cur[edge_j]))
    e = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(edge_valid, e, torch.zeros_like(e)))


def shard_edges(edge_i, edge_j, edge_S, edge_valid, mesh: Mesh):
    """The edge arrays padded to a multiple of the mesh (``edge_valid``
    False, identity measurements at (0, 0)) and split into equal contiguous
    shards, one per position on its device: a list of (edge_i, edge_j,
    edge_S, edge_valid)."""
    n = mesh.size
    pad = (-edge_i.shape[0]) % n
    if pad:
        dev = edge_i.device
        edge_i = torch.cat([edge_i, torch.zeros(pad, dtype=edge_i.dtype, device=dev)])
        edge_j = torch.cat([edge_j, torch.zeros(pad, dtype=edge_j.dtype, device=dev)])
        eye = torch.eye(4, dtype=edge_S.dtype, device=dev).expand(pad, 4, 4)
        edge_S = torch.cat([edge_S, eye])
        edge_valid = torch.cat([edge_valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    rows = edge_i.shape[0] // n
    return [tuple(a[s * rows:(s + 1) * rows].to(d) for a in (edge_i, edge_j, edge_S, edge_valid))
            for s, d in enumerate(mesh.flat_devices)]


def make_distributed_pose_graph(mesh: Mesh, iters: int = 15, lam0: float = LAM0):
    """A runner fn(S [K, 4, 4], kf_valid, fixed, shards) -> S_out [K, 4, 4]
    on S's device, where ``shards`` is :func:`shard_edges`' output."""
    devices = mesh.flat_devices

    def run(S, kf_valid, fixed, shards):
        K = S.shape[0]
        ei = [e[0].long() for e in shards]
        ej = [e[1].long() for e in shards]
        eS = [e[2] for e in shards]
        ev = [e[3] for e in shards]
        Ei = [F.one_hot(i, K).to(S.dtype) for i in ei]
        Ej = [F.one_hot(j, K).to(S.dtype) for j in ej]
        S_cur = replicate(S, mesh)
        free = replicate(kf_valid & ~fixed, mesh)
        lam = replicate(torch.full((), lam0, dtype=S.dtype, device=S.device), mesh)

        def cost_of(S_rep):
            return psum([_shard_cost(S_rep[s], ei[s], ej[s], eS[s], ev[s])
                         for s in range(len(devices))], mesh)

        cost = cost_of(S_cur)
        for _ in range(iters):
            parts = [normal_equations(S_cur[s], ei[s], ej[s], eS[s], Ei[s], Ej[s], ev[s])
                     for s in range(len(devices))]
            # The one collective of the normal equations per iteration.
            H = psum([p[0] for p in parts], mesh)
            b = psum([p[1] for p in parts], mesh)
            S_new = per_device(mesh, damped_step, H, b, S_cur, lam, free)
            new_cost = cost_of(S_new)
            ok = per_device(mesh, torch.lt, new_cost, cost)
            S_cur = per_device(mesh, torch.where, ok, S_new, S_cur)
            lam = per_device(mesh, lambda k, lm: torch.where(k, lm * 0.5, lm * 4.0), ok, lam)
            cost = per_device(mesh, torch.where, ok, new_cost, cost)
        return S_cur[0].to(S.device)

    return run


def distributed_pose_graph(S, kf_valid, fixed, edge_i, edge_j, edge_S, edge_valid,
                           mesh: Mesh, iters: int = 15, lam0: float = LAM0):
    """Shard the edges over ``mesh``, run, return S_out [K, 4, 4]."""
    shards = shard_edges(edge_i, edge_j, edge_S, edge_valid, mesh)
    return make_distributed_pose_graph(mesh, iters=iters, lam0=lam0)(S, kf_valid, fixed, shards)
