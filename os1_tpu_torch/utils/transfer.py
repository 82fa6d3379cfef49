"""Device-to-host transfers that start at dispatch. Counterpart of
os1_tpu/utils/transfer.py, whose tunnel logic is not ported: on a card the
copy is a non-blocking copy into pinned host memory, queued in stream order
right after the work that produces the tensor, and a CUDA event marks its
end. :func:`fetch` waits on that event only, so work queued after the
announce (the next frame's dispatch) does not delay the read.

:func:`upload` is the other way: a set of host arrays packed into one pinned
buffer and sent in one non-blocking copy (a copy from pageable memory waits
for the stream, once per array).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .profiling import HostReads


class Announced(NamedTuple):
    host: object  # the host copy (pinned on a card), or a tuple of them, complete once ``done`` is
    done: object  # torch.cuda.Event, or None for tensors on the CPU


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def announce(t) -> Announced:
    """Start the copy of ``t`` (a tensor, or a tuple of tensors on one
    device) to the host now; read it with :func:`fetch`."""
    many = isinstance(t, (tuple, list))
    ts = tuple(t) if many else (t,)
    host = tuple(_host_copy(x) for x in ts)
    done = None
    if ts[0].is_cuda:
        done = torch.cuda.Event()
        done.record()
    return Announced(host=host if many else host[0], done=done)


def fetch(a: Announced, reads: HostReads):
    """Wait for an announced copy and return it as numpy (a list for a
    tuple): one host read, its wait on the copy's event timed."""
    reads.tick(a.done.synchronize if a.done is not None else None)
    if isinstance(a.host, tuple):
        return [h.numpy() for h in a.host]
    return a.host.numpy()


_ALIGN = 16  # byte alignment of each array in an upload buffer


def upload(arrays: dict, device) -> dict:
    """numpy arrays -> new tensors on ``device`` by one copy of one packed
    buffer (pinned on a card; never a view of the arrays); uint32 arrives as
    int32 with the same bits."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a)
              for k, a in arrays.items()}
    offs, total = {}, 0
    for k, a in arrays.items():
        offs[k] = total
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    buf = host.numpy()
    for k, a in arrays.items():
        buf[offs[k]:offs[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return {k: dev[offs[k]:offs[k] + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .reshape(a.shape) for k, a in arrays.items()}
