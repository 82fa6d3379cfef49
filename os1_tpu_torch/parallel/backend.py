"""Mesh solver backend: the live pipeline's BA protocol, landmark-sharded.
Port of os1_tpu/parallel/backend.py.

``optim.ba_core`` drives every bundle adjustment through the resumable
ba_begin / ba_iterate / ba_reclassify / ba_result protocol (chunks the
mapper can abort between). :class:`MeshBABackend` gives the same protocol
with the landmarks sharded over a :class:`~.mesh.Mesh`, so the local mapper's
local BA and the loop closer's global BA route through the mesh without a
change to their orchestration (BASELINE.json configs 4-5).

Each LM iteration assembles every shard's point-marginalized camera system
(``ba_core.assemble_reduced``), sums ``S`` [C, C, 6, 6] and ``b_red``
[C, 6] with one :func:`~.mesh.psum`, solves the cameras once per distinct
device (every copy of the replicated state is the same), back-substitutes
each shard's points and sums the shards' costs with a second ``psum``.
The LM schedule, the branchless accept/reject and the chi2 reclassification
are ``ba_core``'s; no value is read back to the host.

A sharded problem is a :class:`ShardedProblem`, a state a tuple of
``ba_core.BAState`` with one entry per mesh position: the cameras, the
damping and the cost replicated (one tensor per distinct device), the
points and the active masks the position's own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..optim import ba_core
from ..optim.ba_core import BAProblem, BAResult, BAState
from .mesh import Mesh, per_device, psum, replicate

AXIS = "points"
_PT_FIELDS = ("points", "point_valid", "obs_cam", "obs_uv", "obs_sigma2", "obs_valid")


class ShardedProblem(NamedTuple):
    shards: tuple  # BAProblem per mesh position, on the position's device
    n_points: int  # the problem's point count before padding
    device: torch.device  # where the problem came from; result() gathers there


def _pad_rows(x: torch.Tensor, n: int, value) -> torch.Tensor:
    if n == 0:
        return x
    pad = torch.full((n,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


class MeshBABackend:
    """Drop-in for the ba_* protocol of ``optim.ba_core`` on a mesh.

    The mesh may be 1-D (("points",): one host, config 4) or 2-D (("dcn",
    "ici"): several hosts, config 5). The landmarks shard over all its
    positions, and the per-iteration sum of the reduced camera system runs
    the innermost axis first, so only the already-reduced [C, C, 6, 6]
    block crosses the outer axis."""

    def __init__(self, mesh: Mesh, lam0: float = 1e-4):
        self.mesh = mesh
        self.lam0 = lam0
        self._devices = mesh.flat_devices

    # ------------------------------------------------------------------ #
    def shard(self, prob: BAProblem) -> ShardedProblem:
        """Split the point axis into ``mesh.size`` equal contiguous shards,
        padded to a multiple of the mesh with ``point_valid=False`` and
        ``obs_valid=False`` rows; the camera arrays are replicated."""
        n = self.mesh.size
        P = prob.points.shape[0]
        pad = (-P) % n
        padded = prob._replace(
            points=_pad_rows(prob.points, pad, 0.0),
            point_valid=_pad_rows(prob.point_valid, pad, False),
            obs_cam=_pad_rows(prob.obs_cam, pad, 0),
            obs_uv=_pad_rows(prob.obs_uv, pad, 0.0),
            obs_sigma2=_pad_rows(prob.obs_sigma2, pad, 1.0),
            obs_valid=_pad_rows(prob.obs_valid, pad, False))
        rows = (P + pad) // n
        rep = {k: replicate(getattr(prob, k), self.mesh) for k in ("cam_T", "cam_fixed", "intr")}
        shards = []
        for s, dev in enumerate(self._devices):
            part = {k: getattr(padded, k)[s * rows:(s + 1) * rows].to(dev) for k in _PT_FIELDS}
            shards.append(BAProblem(**part, **{k: v[s] for k, v in rep.items()}))
        return ShardedProblem(shards=tuple(shards), n_points=P, device=prob.points.device)

    def _lam(self, like: BAProblem) -> list:
        dt = like.points.dtype
        return replicate(torch.full((), self.lam0, dtype=dt, device=self._devices[0]), self.mesh)

    def _cost(self, sp: ShardedProblem, cam_T, points, active) -> list:
        return psum([ba_core._cost_only(p, T, x, a)
                     for p, T, x, a in zip(sp.shards, cam_T, points, active)], self.mesh)

    def _state(self, cam_T, points, active, lam, cost) -> tuple:
        return tuple(BAState(cam_T=T, points=x, active=a, lam=lm, cost=c)
                     for T, x, a, lm, c in zip(cam_T, points, active, lam, cost))

    # ------------------------------------------------------------------ #
    def begin(self, sp: ShardedProblem) -> tuple:
        cam_T = [p.cam_T for p in sp.shards]
        points = [p.points for p in sp.shards]
        active = [p.obs_valid for p in sp.shards]
        return self._state(cam_T, points, active, self._lam(sp.shards[0]),
                           self._cost(sp, cam_T, points, active))

    def iterate(self, sp: ShardedProblem, state: tuple, n: int) -> tuple:
        """``n`` LM iterations, one ``psum`` of the reduced system each."""
        cam_T = [s.cam_T for s in state]
        points = [s.points for s in state]
        active = [s.active for s in state]
        lam = [s.lam for s in state]
        cost = [s.cost for s in state]
        for _ in range(n):
            parts = [ba_core.assemble_reduced(p, T, x, a, lm)
                     for p, T, x, a, lm in zip(sp.shards, cam_T, points, active, lam)]
            # The one collective of the reduced system (innermost axis first).
            S = psum([q[0] for q in parts], self.mesh)
            b_red = psum([q[1] for q in parts], self.mesh)
            fixed = [p.cam_fixed for p in sp.shards]
            delta_c = per_device(self.mesh, ba_core.solve_cameras, S, b_red, fixed, lam)
            cand_T = per_device(self.mesh, lambda d, T: se3.exp(d) @ T, delta_c, cam_T)
            cand_p = [x + ba_core.backsub_points(p, d, q[2], q[3], q[4])
                      for p, x, d, q in zip(sp.shards, points, delta_c, parts)]
            new_cost = self._cost(sp, cand_T, cand_p, active)
            ok = per_device(self.mesh, torch.lt, new_cost, cost)
            points = [torch.where(k, c, x) for k, c, x in zip(ok, cand_p, points)]
            cam_T = per_device(self.mesh, torch.where, ok, cand_T, cam_T)
            lam = per_device(self.mesh, lambda k, lm: torch.where(k, lm * 0.5, lm * 4.0), ok, lam)
            cost = per_device(self.mesh, torch.where, ok, new_cost, cost)
        return self._state(cam_T, points, active, lam, cost)

    def reclassify(self, sp: ShardedProblem, state: tuple) -> tuple:
        """Drop chi2/depth outliers from the active sets, reset the damping."""
        cam_T = [s.cam_T for s in state]
        points = [s.points for s in state]
        active = [ba_core.classify_obs(p, T, x) for p, T, x in zip(sp.shards, cam_T, points)]
        return self._state(cam_T, points, active, self._lam(sp.shards[0]),
                           self._cost(sp, cam_T, points, active))

    def result(self, sp: ShardedProblem, state: tuple) -> BAResult:
        """The points and inlier masks gathered in shard order onto the
        problem's device, the padding trimmed."""
        inlier = [ba_core.classify_obs(p, s.cam_T, s.points) for p, s in zip(sp.shards, state)]
        cam_T, points, cost = self.gather(sp, state)
        obs_inlier = torch.cat([m.to(sp.device) for m in inlier])[:sp.n_points]
        return BAResult(cam_T=cam_T, points=points, obs_inlier=obs_inlier, cost=cost)

    def gather(self, sp: ShardedProblem, state: tuple):
        """(cam_T, points, cost) on the problem's device, the points in shard
        order with the padding trimmed."""
        dev = sp.device
        points = torch.cat([s.points.to(dev) for s in state])[:sp.n_points]
        return state[0].cam_T.to(dev), points, state[0].cost.to(dev)


def two_level_backend(n_hosts: int, devices=None) -> MeshBABackend:
    """A ("dcn", "ici") 2-D mesh backend standing for ``n_hosts`` hosts: the
    devices reshaped to [n_hosts, per_host], the landmarks sharded over
    both axes. ``devices`` defaults to every card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = np.asarray(devices, dtype=object)
    if devs.size == 0 or devs.size % n_hosts:
        raise ValueError(f"{devs.size} devices do not split over {n_hosts} hosts")
    return MeshBABackend(Mesh(devs.reshape(n_hosts, -1), ("dcn", "ici")))


def default_mesh_backend(device) -> MeshBABackend | None:
    """A backend over every card when the system runs on a card and more
    than one exists (config 4: the map's landmarks sharded over all of
    them); None otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return MeshBABackend(Mesh(np.asarray(cards, dtype=object), (AXIS,)))
