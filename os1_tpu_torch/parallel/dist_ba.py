"""Distributed Schur-complement bundle adjustment over a device mesh, the
fixed-iteration standalone runner. Port of os1_tpu/parallel/dist_ba.py.

The scaling design of BASELINE.json configs 4-5: the landmarks shard along
the point axis; each position marginalizes its own landmark blocks, the
reduced camera system (tiny beside the landmark system: (6C)^2 against 3P)
is summed with one psum per LM iteration and solved once per device, and
the back-substitution touches only the position's own points. The sum moves
[C, C, 6, 6] + [C, 6] and a scalar per iteration, whatever the point count.
The live pipeline's resumable form is :class:`.backend.MeshBABackend`; this
runner is its begin and ``iters`` iterations, with no reclassification.
"""
from __future__ import annotations

from ..optim.ba_core import BAProblem
from .backend import MeshBABackend, ShardedProblem
from .mesh import Mesh


def shard_problem(prob: BAProblem, mesh: Mesh) -> ShardedProblem:
    """The point-axis arrays split over the mesh (padded to a multiple of
    it), the camera arrays replicated."""
    return MeshBABackend(mesh).shard(prob)


def make_distributed_ba(mesh: Mesh, iters: int = 10, lam0: float = 1e-4):
    """A runner sharded problem -> (cam_T, points, cost), gathered onto the
    problem's device."""
    be = MeshBABackend(mesh, lam0=lam0)

    def run(sp: ShardedProblem):
        return be.gather(sp, be.iterate(sp, be.begin(sp), iters))

    return run


def distributed_ba(prob: BAProblem, mesh: Mesh, iters: int = 10, lam0: float = 1e-4):
    """Shard, run, return (cam_T, points, cost)."""
    return make_distributed_ba(mesh, iters=iters, lam0=lam0)(shard_problem(prob, mesh))
