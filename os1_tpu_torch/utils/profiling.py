"""Lightweight stage timing for the host-orchestrated pipeline.
Port of os1_tpu/utils/profiling.py.

Stages are timed on the host clock. Device work is asynchronous, so with
``sync=False`` a stage's time is its enqueue time unless the stage itself
reads a result back; ``sync=True`` synchronises the current CUDA device at
the end of every stage so that each stage owns its device time (with the
worker threads on, that waits for every thread's work: time the threaded
mode unsynchronised).

Both counters are exact when several threads update them (the tracker and
the mapping, loop-closing and global-BA threads of the threaded mode).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

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
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> str:
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        return "\n".join(
            f"{name:<28s} {tot:8.3f}s {self.counts[name]:6d}x "
            f"{tot / self.counts[name] * 1e3:8.2f}ms/call {tot / total * 100:5.1f}%"
            for name, tot in rows
        )

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()


def span(timer: StageTimer | None, name: str):
    """``timer(name)``, or no stage where ``timer`` is None."""
    return nullcontext() if timer is None else timer(name)


@contextmanager
def detached(*users):
    """Take the ``timer`` off each of ``users`` for the block, then put it
    back."""
    timers = [u.timer for u in users]
    for u in users:
        u.timer = None
    try:
        yield
    finally:
        for u, t in zip(users, timers):
            u.timer = t


class HostReads:
    """Counts device-to-host reads: each one waits for the device to finish
    the work queued before it (a host sync when the tensor is on a card).
    With a ``timer``, each read's blocking part is a ``host.read`` stage of
    it: one stage a read counted, so the two never disagree."""

    def __init__(self, timer: StageTimer | None = None):
        self.count = 0
        self.timer = timer
        self._lock = threading.Lock()

    def tick(self, wait=None):
        """Count one read and run its blocking part, ``wait()``, inside the
        timer's ``host.read`` stage. Returns what ``wait`` returns."""
        with self._lock:
            self.count += 1
        with span(self.timer, "host.read"):
            return wait() if wait is not None else None

    def numpy(self, t: torch.Tensor):
        return self.tick(lambda: t.detach().cpu().numpy())

    def numpy_all(self, ts):
        """One read of several results of the same device work: the first
        copy waits for the work, the rest find it done."""
        return self.tick(lambda: [t.detach().cpu().numpy() for t in ts])

    def item(self, t: torch.Tensor):
        return self.tick(t.item)
