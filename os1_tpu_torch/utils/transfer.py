"""Device-to-host transfers that start at dispatch. Counterpart of
os1_tpu/utils/transfer.py, whose tunnel logic is not ported: on a card the
copy is a non-blocking copy into pinned host memory, queued in stream order
right after the work that produces the tensor, and a CUDA event marks its
end. :func:`fetch` waits on that event only, so work queued after the
announce (the next frame's dispatch) does not delay the read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .profiling import HostReads


class Announced(NamedTuple):
    host: torch.Tensor  # the host copy (pinned on a card), complete once ``done`` is
    done: object  # torch.cuda.Event, or None for a tensor on the CPU


def announce(t: torch.Tensor) -> Announced:
    """Start the copy of ``t`` to the host now; read it with :func:`fetch`."""
    t = t.detach()
    if not t.is_cuda:
        return Announced(host=t.clone(), done=None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return Announced(host=host, done=done)


def fetch(a: Announced, reads: HostReads) -> np.ndarray:
    """Wait for an announced copy and return it as numpy: one host read."""
    reads.count += 1
    if a.done is not None:
        a.done.synchronize()
    return a.host.numpy()
