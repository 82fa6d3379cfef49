"""Keyframe scheduling: the reference's worker threads and the cooperative
scheduler. Port of os1_tpu/pipeline/workers.py.

Threaded (``System(async_mapping=True)``, the reference's topology,
System.cc:63-83):

  Tracker (caller thread)
    -> MappingWorker thread "LocalMapping": materialize + BoW, point culling,
       triangulation, fusion, local BA, keyframe culling
       -> LoopWorker thread "LoopClosing": detection, the Sim3 candidates,
          correction (+ a detached "GlobalBA" thread)

Every store mutation and every host read of mutable store state happens under
ONE map lock (:class:`MapLock`, the reference's Map::mMutexMapUpdate,
Map.h:140). A stage snapshots its inputs and dispatches its device work under
the lock, releases it, reads the result back, and takes the lock again to
write the result into the store: the result reads (``HostReads``,
``transfer.fetch``) are never made under the lock by a worker. All threads
launch on the device's default stream, so the device runs their work in the
order it was issued: a mirror row published by one thread is in place for
any kernel another thread issues after the publish, and memory freed by one
thread is reused in stream order.

Control protocol (the same for both schedulers where it applies):
  * insert sets the mapper's BA abort flag (InsertKeyFrame, LocalMapping.cc:112);
  * ``accepting`` is SetAcceptKeyFrames' backpressure (LocalMapping.cc:53,101):
    up to one keyframe queues behind the pass in flight;
  * ``request_stop`` / ``wait_stopped`` / ``release`` (LocalMapping.cc:479-553),
    used by loop correction and the global BA's write-back;
  * ``request_reset`` (LocalMapping.cc:614-631) drops the queue;
  * ``shutdown`` (RequestFinish, LocalMapping.cc:633-667).

The LocalMapping thread advances a keyframe's pass at the cooperative
scheduler's pace, one stage a tracked frame and two under backlog
(:class:`FramePacer`), while the stage itself runs beside the tracker. Run
as fast as it can, the thread finished a whole pass within a frame when
frames came as fast as they were tracked; the keyframe policy, which counts
ages and gates in keyframes and was tuned with the mapping a few frames
behind (as a real-time ORB-SLAM's is at the camera's rate), then inserted a
keyframe almost every frame and culled them as fast: on bench.py's loop
sequence 216-234 keyframes against 83 paced, at under half the paced frame
rate on an NVIDIA H100. A stop request or shutdown lets the pass in flight
finish unpaced, so a loop correction never waits for the next frame.

A worker survives an exception in a keyframe's pass, as the reference's does:
it prints the traceback and goes on with the next keyframe. It also keeps the
exception in ``errors``, so that a caller can fail on it.

Cooperative (``coop_mapping=True``, the shipped configuration): each keyframe
event is a generator (materialize + BoW, point culling, triangulation,
fusion, local BA chunks, keyframe culling, then the loop steps) that yields
at every dispatch -> result boundary, and the System advances it once per
tracked frame on the tracking thread. Two runs give bit-identical
trajectories.
"""
from __future__ import annotations

import threading
import time
import traceback
from collections import defaultdict, deque
from contextlib import contextmanager


class MapLock:
    """The map lock: a re-entrant lock that adds up, per thread name, the
    seconds spent waiting for it (``wait_s``) and the waits (``waits``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._stats = threading.Lock()
        self.wait_s: dict[str, float] = defaultdict(float)
        self.waits: dict[str, int] = defaultdict(int)

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            t0 = time.perf_counter()
            self._lock.acquire()
            dt = time.perf_counter() - t0
            name = threading.current_thread().name
            with self._stats:
                self.wait_s[name] += dt
                self.waits[name] += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def reset_stats(self) -> None:
        with self._stats:
            self.wait_s.clear()
            self.waits.clear()


class FramePacer:
    """Ties a worker's steps to the tracked frames: :meth:`tick` after each
    frame, :meth:`wait_after` until a later frame was tracked or the worker
    is asked to stop. Inside :meth:`free_running` (end of stream, a save, a
    mode switch, shutdown) nothing waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._frame = 0
        self._free = 0

    def tick(self) -> None:
        with self._cv:
            self._frame += 1
            self._cv.notify_all()

    def frame(self) -> int:
        with self._cv:
            return self._frame

    def wait_after(self, frame: int, cancelled=lambda: False) -> None:
        """Wait for a frame after ``frame``; ``cancelled()`` ends the wait,
        checked at each :meth:`wake`."""
        with self._cv:
            while self._frame <= frame and not self._free and not cancelled():
                self._cv.wait()

    def wake(self) -> None:
        """Have the waiters check ``cancelled`` again."""
        with self._cv:
            self._cv.notify_all()

    @contextmanager
    def free_running(self):
        with self._cv:
            self._free += 1
            self._cv.notify_all()
        try:
            yield
        finally:
            with self._cv:
                self._free -= 1


def _report(worker, kf, exc) -> None:
    """A keyframe's pass raised: print it, as the reference does, and keep
    it (``worker.errors``)."""
    traceback.print_exc()
    with worker._cv:
        worker.errors.append((kf, exc))


class MappingWorker:
    """LocalMapping thread: consumes the keyframe queue, runs the whole local
    mapping pass for each keyframe, then hands it to the loop worker. The
    pass is paced by ``pacer``, which the tracking side ticks once a frame;
    a stop request or shutdown lets the pass in flight finish unpaced."""

    def __init__(self, mapper, lock, on_process=None, on_pass_done=None, loop_worker=None):
        self.mapper = mapper
        self.lock = lock
        # callback(kf) before the pass (materialize + BoW); False skips the pass
        self.on_process = on_process
        self.on_pass_done = on_pass_done  # callback(kf) after the pass: publish the mirror
        self.loop_worker = loop_worker
        self.pacer = FramePacer()
        self.errors: list = []  # (kf, exception) per pass that raised
        self.max_queue = 0  # deepest queue seen at an insert
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._finishing = False
        self._stop_requested = False
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True, name="LocalMapping")
        self._thread.start()

    # ---------------- producer side (tracker thread) -------------------- #
    def insert_keyframe(self, kf: int, bootstrap: bool = False) -> None:
        """Queue a keyframe; a running local BA yields to it."""
        with self._cv:
            self._queue.append((kf, bootstrap))
            self.max_queue = max(self.max_queue, len(self._queue))
            self.mapper.abort_ba = True
            self._idle.clear()
            self._cv.notify()

    def interrupt_ba(self) -> None:
        """Tracking::NeedNewKeyFrame's InterruptBA (Tracking.cc:755)."""
        self.mapper.abort_ba = True

    @property
    def accepting(self) -> bool:
        """Backpressure: no keyframe while stopped, and at most one queued
        behind the pass in flight (the mapper skips its heavy stages while
        one waits, as the reference's CheckNewKeyFrames gates do,
        LocalMapping.cc:72)."""
        with self._cv:
            return not self._stop_requested and len(self._queue) < 2

    def queue_size(self) -> int:
        with self._cv:
            return len(self._queue)

    def queued(self) -> list[int]:
        """The keyframes waiting for their pass (the mapper never culls
        them: see ``LocalMapper.cull_keyframes``)."""
        with self._cv:
            return [kf for kf, _ in self._queue]

    # ---------------- control protocol ---------------------------------- #
    def request_stop(self) -> None:
        """Pause after the pass in flight (the queue is kept): loop
        correction and the global BA's write-back need the mapper quiet
        (LoopClosing.cc:413-431)."""
        with self._cv:
            self._stop_requested = True
            self.mapper.abort_ba = True
            self._cv.notify()
        self.pacer.wake()  # the pass in flight runs on without frames

    def wait_stopped(self, timeout: float | None = None) -> bool:
        return self._stopped.wait(timeout)

    def release(self) -> None:
        """Resume after :meth:`request_stop` (LocalMapping::Release)."""
        with self._cv:
            self._stop_requested = False
            self._stopped.clear()
            self._cv.notify()

    def request_reset(self) -> None:
        """Drop the queued keyframes; the pass in flight finishes with its BA
        aborted."""
        with self._cv:
            self._queue.clear()
            self.mapper.abort_ba = True

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the queue is drained and the pass in flight is done."""
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._finishing = True
            self.mapper.abort_ba = True
            self._cv.notify()
        self.pacer.wake()
        self._thread.join(timeout)

    # ---------------- worker loop ---------------------------------------- #
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._finishing and not self._stop_requested:
                    self._idle.set()
                    self._cv.wait()
                if self._finishing:
                    self._idle.set()
                    return
                if self._stop_requested:
                    self._stopped.set()
                    self._cv.wait()  # until release() or shutdown()
                    continue
                kf, bootstrap = self._queue.popleft()
                self._idle.clear()
            try:
                self.mapper.abort_ba = False
                if self.on_process is not None and self.on_process(kf) is False:
                    continue  # the keyframe died before its pass (a cull or a reset)
                self._pass(kf, bootstrap)
                if self.on_pass_done is not None:
                    self.on_pass_done(kf)
                if self.loop_worker is not None and not bootstrap:
                    self.loop_worker.insert_keyframe(kf)
            except Exception as exc:  # noqa: BLE001: the worker goes on, the error is kept
                _report(self, kf, exc)
            finally:
                with self._cv:
                    if not self._queue:
                        self._idle.set()

    def _pass(self, kf: int, bootstrap: bool) -> None:
        """The local-mapping pass; paced, one stage a tracked frame, two
        while two keyframes wait (the cooperative scheduler's budget)."""
        frame, done = self.pacer.frame(), 0
        for _ in self.mapper.process_steps(kf, bootstrap=bootstrap):
            done += 1
            if done >= (2 if self.queue_size() >= 2 else 1):
                self.pacer.wait_after(frame, self._unpaced)
                frame, done = self.pacer.frame(), 0

    def _unpaced(self) -> bool:
        return self._stop_requested or self._finishing


class LoopWorker:
    """LoopClosing thread: consumes the keyframes local mapping has processed
    and attempts a loop closure on each."""

    def __init__(self, process, lock):
        self.process = process  # callback(kf) -> bool (closed a loop)
        self.lock = lock
        self.errors: list = []  # (kf, exception) per attempt that raised
        self.max_queue = 0
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._finishing = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True, name="LoopClosing")
        self._thread.start()

    def insert_keyframe(self, kf: int) -> None:
        with self._cv:
            self._queue.append(kf)
            self.max_queue = max(self.max_queue, len(self._queue))
            self._idle.clear()
            self._cv.notify()

    def queue_size(self) -> int:
        with self._cv:
            return len(self._queue)

    def request_reset(self) -> None:
        with self._cv:
            self._queue.clear()

    def wait_idle(self, timeout: float | None = None) -> bool:
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._finishing = True
            self._cv.notify()
        self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._finishing:
                    self._idle.set()
                    self._cv.wait()
                if self._finishing:
                    self._idle.set()
                    return
                kf = self._queue.popleft()
                self._idle.clear()
            try:
                self.process(kf)
            except Exception as exc:  # noqa: BLE001
                _report(self, kf, exc)
            finally:
                with self._cv:
                    if not self._queue:
                        self._idle.set()


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
