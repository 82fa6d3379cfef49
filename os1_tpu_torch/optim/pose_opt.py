"""Motion-only pose optimization on one SE3 pose with fixed map points.
Port of os1_tpu/optim/pose_opt.py (reference Optimizer::PoseOptimization,
Optimizer.cc:206-338).

Rounds of iterations with chi2 = 5.991 inlier reclassification between
rounds; LM accept/reject (``accept_reject=True``) or damped Gauss-Newton.
Accept/reject is branchless (``torch.where`` on 0-d tensors), so the solve
never reads a value back to the host. ``solve_ex`` is used for the 6x6 system
because ``solve`` synchronises to check for singular input.

Its shapes are fixed for a configuration and it reads nothing back, so on a
card the solve is captured once per input signature as a CUDA graph and
replayed: the same kernels in the same order, one host launch instead of
some 2,700. On the CPU it runs eagerly.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..geometry import se3
from ..utils.profiling import span
from . import reprojection as rp

CHI2_MONO = 5.991


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [..., 4, 4]
    inlier: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor  # [...] int
    chi2: torch.Tensor  # [...] final robust total cost


def _normal_system(Tcw, X, uv, intr, sigma2, active):
    """6x6 GN system over active observations with Huber IRLS, for a pose
    [..., 4, 4] and its observations [..., N]."""
    T_obs = Tcw if Tcw.ndim == 2 else Tcw[..., None, :, :]  # one pose per observation row
    r = rp.residual(T_obs, X, uv, intr)
    J_pose, _ = rp.jacobians(T_obs, X, intr)
    r = torch.where(active[..., None], r, torch.zeros_like(r))
    J_pose = torch.where(active[..., None, None], J_pose, torch.zeros_like(J_pose))
    inv_s2 = 1.0 / torch.clamp(sigma2, min=1e-8)
    chi2 = torch.sum(r * r, dim=-1) * inv_s2
    w = rp.huber_weight(chi2, rp.HUBER_MONO) * inv_s2
    w = torch.where(active, w, torch.zeros_like(w))
    w = w.expand(J_pose.shape[:-2])
    H = torch.einsum("...nki,...n,...nkj->...ij", J_pose, w, J_pose)
    b = torch.einsum("...nki,...n,...nk->...i", J_pose, w, r)
    d2 = rp.HUBER_MONO**2
    rho = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(chi2 * d2) - d2)
    cost = torch.sum(torch.where(active, rho, torch.zeros_like(rho)), dim=-1)
    return H, b, cost, chi2


def optimize_pose(Tcw0, points, uv, sigma2, valid, intr, rounds: int = 4,
                  iters_per_round: int = 10, accept_reject: bool = True,
                  timer=None) -> PoseOptResult:
    """Pose-only solve. points [N, 3], uv [N, 2] undistorted pixels,
    sigma2 [N], valid [N] match mask, intr [4]. Leading batch dimensions of
    Tcw0 [..., 4, 4], points and valid are independent solves (``uv`` and
    ``sigma2`` broadcast).

    On CUDA tensors the solve replays the CUDA graph captured for its
    signature (:func:`_graph_key`), captured at the first call; each replay
    is a ``trk.pose_graph`` stage of ``timer``. The results are clones, so a
    later replay does not overwrite them."""
    args = (Tcw0, points, uv, sigma2, valid, intr)
    sched = (rounds, iters_per_round, accept_reject)
    if not Tcw0.is_cuda:
        return _optimize_pose_eager(*args, *sched)
    key = _graph_key(args, sched)
    with _GRAPHS_LOCK, torch.cuda.device(Tcw0.device):
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = _PoseGraph(args, sched)
        with span(timer, "trk.pose_graph"):
            return graph(args)


def _graph_key(args, sched) -> tuple:
    """What a captured solve is keyed on: the device, each input's shape and
    dtype, and the schedule (rounds, iterations a round, accept/reject)."""
    return (args[0].device, *((tuple(a.shape), a.dtype) for a in args), *sched)


class _PoseGraph:
    """One solve captured as a CUDA graph over static inputs. A call copies
    the caller's inputs in, replays on the current stream and returns clones
    of the outputs, so a later replay leaves earlier results as they were."""

    def __init__(self, args, sched):
        self.static = [a.clone() for a in args]
        side = torch.cuda.Stream()
        # PyTorch's warm-up before a capture: lazy initialisations (the
        # cuBLAS and cuSOLVER handles and workspaces) run outside the graph.
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _optimize_pose_eager(*self.static, *sched)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: launches of other threads during the capture (the
        # mapping and loop-closing workers on the default stream) neither
        # join nor break it.
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            self.out = _optimize_pose_eager(*self.static, *sched)

    def __call__(self, args) -> PoseOptResult:
        for s, a in zip(self.static, args):
            s.copy_(a)
        self.graph.replay()
        return PoseOptResult(*(t.clone() for t in self.out))


_GRAPHS: dict = {}  # _graph_key -> _PoseGraph
_GRAPHS_LOCK = threading.Lock()


def _optimize_pose_eager(Tcw0, points, uv, sigma2, valid, intr, rounds: int,
                         iters_per_round: int, accept_reject: bool) -> PoseOptResult:
    """The solve as a loop of PyTorch operations (what a graph captures)."""
    dev, dt = Tcw0.device, Tcw0.dtype
    batch = Tcw0.shape[:-2]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Tcw = Tcw0
    inlier = valid
    cost = torch.full(batch, float("inf"), dtype=dt, device=dev)
    for _ in range(rounds):
        lam = torch.full(batch, 1e-3, dtype=dt, device=dev)
        cost = torch.full(batch, float("inf"), dtype=dt, device=dev)
        for _ in range(iters_per_round):
            H, b, c, _ = _normal_system(Tcw, points, uv, intr, sigma2, inlier)
            Hd = H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
            delta = -torch.linalg.solve_ex(Hd + 1e-10 * eye6, b[..., None])[0][..., 0]
            T_new = se3.exp(delta) @ Tcw
            if not accept_reject:
                Tcw, cost = T_new, c
                continue
            _, _, cost_new, _ = _normal_system(T_new, points, uv, intr, sigma2, inlier)
            improved = cost_new < c
            Tcw = torch.where(improved[..., None, None], T_new, Tcw)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
            cost = torch.where(improved, cost_new, c)
        _, _, _, chi2 = _normal_system(Tcw, points, uv, intr, sigma2, valid)
        inlier = valid & (chi2 <= CHI2_MONO)
    return PoseOptResult(Tcw=Tcw, inlier=inlier, n_inliers=torch.sum(inlier, dim=-1), chi2=cost)
