"""Cooperative keyframe scheduling. Port of the CoopScheduler of
os1_tpu/pipeline/workers.py (the shipped configuration's mapping topology).

The reference's LocalMapping and LoopClosing threads (LocalMapping.cc:46-110,
LoopClosing.cc:58-89) become one deterministic interleave on the tracking
thread: each keyframe event is a generator (materialize + BoW, point culling,
triangulation, fusion, local BA chunks, keyframe culling, then the loop
steps) that yields at every dispatch -> result boundary, and the System
advances it once per tracked frame. The card works on a mapping stage while
the host tracks the next frame, and two runs give bit-identical trajectories.

Control protocol: ``insert`` sets the mapper's BA abort flag
(LocalMapping.cc:112); ``accepting`` is SetAcceptKeyFrames' backpressure;
``clear`` is RequestReset (the epoch guards of the apply steps make the
dropped in-flight event safe).

The threaded MappingWorker and LoopWorker of the reference package are not
ported yet.
"""
from __future__ import annotations

from collections import deque


class CoopScheduler:
    def __init__(self, mapper, loop_steps=None, on_prepare=None, on_pass_done=None):
        self.mapper = mapper
        self.loop_steps = loop_steps  # callable(kf) -> generator, or None
        self.on_prepare = on_prepare  # callback(kf): materialize + BoW
        self.on_pass_done = on_pass_done  # callback(kf): publish the mirror
        self._queue: deque = deque()
        self._active = None

    def insert(self, kf: int, bootstrap: bool = False) -> None:
        self._queue.append((kf, bootstrap))
        self.mapper.abort_ba = True  # a running local BA yields to the new keyframe

    @property
    def accepting(self) -> bool:
        """Backpressure: at most one keyframe queues behind the active event."""
        return len(self._queue) < 2

    def queue_size(self) -> int:
        return len(self._queue)

    def busy(self) -> bool:
        return self._active is not None or bool(self._queue)

    def step(self, budget: int = 1) -> None:
        """Advance the active event by up to ``budget`` steps (a step is one
        dispatch -> result interval). Called once per tracked frame."""
        for _ in range(budget):
            if self._active is None:
                if not self._queue:
                    return
                kf, bootstrap = self._queue.popleft()
                self.mapper.abort_ba = False
                self._active = self._event(kf, bootstrap)
            try:
                next(self._active)
            except StopIteration:
                self._active = None

    def drain(self) -> None:
        """Run every queued event to completion (flush, mode switch)."""
        while self.busy():
            self.step()

    def clear(self) -> None:
        """Drop the queued events and the one in flight."""
        self._queue.clear()
        self._active = None

    def _event(self, kf: int, bootstrap: bool):
        if self.on_prepare is not None:
            self.on_prepare(kf)
        yield from self.mapper.process_steps(kf, bootstrap=bootstrap)
        if self.on_pass_done is not None:
            self.on_pass_done(kf)
        if self.loop_steps is not None and not bootstrap:
            yield from self.loop_steps(kf)
