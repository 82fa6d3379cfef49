"""Lightweight stage timing for the host-orchestrated pipeline.
Port of os1_tpu/utils/profiling.py.

Stages are timed on the host clock. Device work is asynchronous, so with
``sync=False`` a stage's time is its enqueue time unless the stage itself
reads a result back; ``sync=True`` synchronises the current CUDA device at
the end of every stage so that each stage owns its device time.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimer:
    """Accumulates wall-clock per named stage.

    Usage::

        timer = StageTimer(sync=True)
        with timer("extract"):
            feats = extractor(img)
        print(timer.report())
    """

    def __init__(self, sync: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        return "\n".join(
            f"{name:<28s} {tot:8.3f}s {self.counts[name]:6d}x "
            f"{tot / self.counts[name] * 1e3:8.2f}ms/call {tot / total * 100:5.1f}%"
            for name, tot in rows
        )

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class HostReads:
    """Counts device-to-host reads: each one waits for the device to finish
    the work queued before it (a host sync when the tensor is on a card)."""

    def __init__(self):
        self.count = 0

    def numpy(self, t: torch.Tensor):
        self.count += 1
        return t.detach().cpu().numpy()

    def numpy_all(self, ts):
        """One read of several results of the same device work: the first
        copy waits for the work, the rest find it done."""
        self.count += 1
        return [t.detach().cpu().numpy() for t in ts]

    def item(self, t: torch.Tensor):
        self.count += 1
        return t.item()
