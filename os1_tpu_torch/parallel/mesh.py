"""A device mesh for one controlling process: the port's stand-in for
``jax.sharding.Mesh`` and ``jax.lax.psum`` in the reference's
``shard_map`` programs (os1_tpu/parallel/).

The reference is single-controller: one Python process drives every device
of its mesh. So is this module. A :class:`Mesh` is a numpy object array of
``torch.device`` with one name per axis; entries may repeat, so that eight
shards on one card stand where the reference's tests put eight virtual CPU
devices. A sharded value is a list with one tensor per mesh position, in
row-major order of ``Mesh.devices``.

:func:`psum` is the one collective: a sum over every position in a fixed
order, the innermost axis first and then the outer ones (the reference's
"ici" before "dcn", os1_tpu/parallel/backend.py:67-71), by plain adds on
the first device of each group, with no float atomics and no NCCL, so a
rerun gives the same bits. The sum comes back replicated: one tensor per
distinct device, shared by every position on that device (no copy where
positions share a device). Every operation names its device, so the worker
threads never depend on a thread's current device.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """``devices`` (an array-like of ``torch.device`` or device strings,
    one dimension per axis name) and ``axis_names``."""

    def __init__(self, devices, axis_names):
        devs = np.asarray(devices, dtype=object)
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [torch.device(d) for d in devs.reshape(-1)]
        self.devices = flat.reshape(devs.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs as many axis names, "
                             f"got {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> list:
        """The device of each position, row-major."""
        return list(self.devices.reshape(-1))

    @property
    def distinct_devices(self) -> list:
        """Each device once, in order of first position."""
        out = []
        for d in self.flat_devices:
            if d not in out:
                out.append(d)
        return out


def replicate(x: torch.Tensor, mesh: Mesh) -> list:
    """One copy of ``x`` per distinct device, shared by the positions on it
    (``x`` itself where it already lies there)."""
    copies = {d: x if x.device == d else x.to(d) for d in mesh.distinct_devices}
    return [copies[d] for d in mesh.flat_devices]


def per_device(mesh: Mesh, fn, *per_position) -> list:
    """``fn`` once per distinct device, on the values of that device's first
    position (each a list with one entry per position); the result is
    shared by every position on the device. For replicated values, whose
    copies are the same, this is the reference's replicated computation."""
    out = {}
    for s, d in enumerate(mesh.flat_devices):
        if d not in out:
            out[d] = fn(*(v[s] for v in per_position))
    return [out[d] for d in mesh.flat_devices]


def psum(parts, mesh: Mesh) -> list:
    """The sum of ``parts`` (one tensor per mesh position), replicated (see
    the module docstring). The innermost axis is reduced first: in a
    ("dcn", "ici") mesh each row's positions are summed in order on the row's
    first device, then the row sums in order on the mesh's first device."""
    if len(parts) != mesh.size:
        raise ValueError(f"psum over {mesh.size} positions got {len(parts)} parts")
    partial = list(parts)
    shape = mesh.devices.shape
    for axis in reversed(range(len(shape))):
        n = shape[axis]
        groups = len(partial) // n
        partial = [_ordered_sum(partial[g * n:(g + 1) * n]) for g in range(groups)]
    return replicate(partial[0], mesh)


def _ordered_sum(parts) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + (p if p.device == acc.device else p.to(acc.device))
    return acc
