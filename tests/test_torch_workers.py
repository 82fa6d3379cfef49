"""The threaded workers' control protocol and the counters they share.

- ``os1_tpu_torch.pipeline.workers.MappingWorker`` and ``LoopWorker`` against
  the JAX package's, with a recording fake mapper that blocks each pass on a
  gate the test opens: one event script (insert, accepting, queue_size,
  request_stop, wait_stopped, release, request_reset, a bootstrap keyframe,
  an ``on_process`` that raises, wait_idle, shutdown) played through both
  gives the same passes in the same order, with the same BA abort flag at
  each pass's start, the same observations of the queue, and the same
  keyframes handed to the loop worker. The port's pass is paced by frames
  (``MappingWorker.pacer``), so the script runs through it twice: with the
  pacer free, and with a thread ticking it every millisecond as tracked
  frames do. The port also keeps the exception (``errors``); the JAX package
  only prints it.
- Keyframe culling spares the keyframes still waiting for their pass
  (``MappingWorker.queued``, wired into ``LocalMapper.queued_fn`` by the
  threaded System): a waiting keyframe holds only old, well-observed points
  and looks redundant before its pass has triangulated anything. Without
  the rule (the JAX package's) it is culled and its pass skipped.
- ``MapLock`` adds up the time a thread waits for it, per thread.
- ``HostReads``, ``StageTimer`` and the kernel wrappers' launch counters
  stay exact when 32 threads update them at once, with the interpreter
  switching threads every microsecond (a lost update would show).

Every wait carries a timeout and asserts that it returned.
"""
import contextlib
import sys
import threading
import time

import pytest

pytest.importorskip("jax")

from os1_tpu.pipeline import workers as jworkers  # noqa: E402
from os1_tpu_torch.ops import cuda_build  # noqa: E402
from os1_tpu_torch.pipeline import workers as tworkers  # noqa: E402
from os1_tpu_torch.utils.profiling import HostReads, StageTimer  # noqa: E402

TIMEOUT = 10.0


def _until(pred, timeout=TIMEOUT):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


class FakeMapper:
    """Records each pass (kf, bootstrap, abort flag at its start) and holds it
    until the test opens the keyframe's gate; then three more stages. The
    JAX package's worker runs ``process``, the port's ``process_steps``."""

    def __init__(self):
        self.abort_ba = False
        self.passes = []
        self.gates = {}

    def gate(self, kf):
        return self.gates.setdefault(kf, threading.Event())

    def process_steps(self, kf, bootstrap=False):
        self.passes.append((kf, bootstrap, self.abort_ba))
        assert self.gate(kf).wait(TIMEOUT), f"gate {kf} never opened"
        for _ in range(3):
            yield

    def process(self, kf, bootstrap=False):
        for _ in self.process_steps(kf, bootstrap):
            pass


@contextlib.contextmanager
def _ticking(pacer, period=1e-3):
    """Tick ``pacer`` every ``period`` seconds, as tracked frames do."""
    done = threading.Event()

    def tick():
        while not done.wait(period):
            pacer.tick()

    t = threading.Thread(target=tick, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
        t.join(TIMEOUT)


def _script(mod, pacing=None):
    """Play the event script through one package's workers; returns what it
    saw. ``pacing`` ("free" or "ticked") runs the port's worker with its
    pacer free or ticked."""
    mapper = FakeMapper()
    lock = threading.RLock()
    looped, prepared = [], []

    def on_process(kf):
        prepared.append(kf)
        if kf == 5:
            raise ValueError("a bad keyframe")

    lw = mod.LoopWorker(looped.append, lock)
    mw = mod.MappingWorker(mapper, lock, on_process=on_process, loop_worker=lw)
    seen = [("start", mw.accepting, mw.queue_size())]
    paced = {None: contextlib.nullcontext, "ticked": lambda: _ticking(mw.pacer),
             "free": lambda: mw.pacer.free_running()}[pacing]
    try:
        with paced():
            _events(mw, lw, mapper, seen)
    finally:
        mw.shutdown(timeout=TIMEOUT)
        lw.shutdown(timeout=TIMEOUT)
    seen.append(("shut down", mw._thread.is_alive(), lw._thread.is_alive()))
    return dict(seen=seen, passes=mapper.passes, looped=looped, prepared=prepared, mw=mw, lw=lw)


def _events(mw, lw, mapper, seen):
    """The event script, recording its observations in ``seen``."""
    mw.insert_keyframe(1)
    assert _until(lambda: len(mapper.passes) == 1)
    seen.append(("pass 1 running", mw.accepting, mw.queue_size(), mapper.abort_ba))
    mw.insert_keyframe(2)
    seen.append(("2 queued", mw.accepting, mw.queue_size(), mapper.abort_ba))
    mw.insert_keyframe(3)
    seen.append(("3 queued", mw.accepting, mw.queue_size()))
    mw.request_stop()
    seen.append(("stop requested", mw.accepting, mw.queue_size()))
    mapper.gate(1).set()
    assert mw.wait_stopped(TIMEOUT)
    seen.append(("stopped", len(mapper.passes), mw.queue_size(), mw.wait_idle(0.05)))
    mw.request_reset()
    seen.append(("reset", mw.queue_size(), mapper.abort_ba))
    mw.release()
    assert mw.wait_idle(TIMEOUT)
    seen.append(("released", mw.accepting, len(mapper.passes)))
    for kf in (4, 6):
        mapper.gate(kf).set()
    mw.insert_keyframe(4, bootstrap=True)
    assert mw.wait_idle(TIMEOUT)
    mw.insert_keyframe(5)  # on_process raises: no pass, the worker goes on
    assert mw.wait_idle(TIMEOUT)
    mw.insert_keyframe(6)
    assert mw.wait_idle(TIMEOUT) and lw.wait_idle(TIMEOUT)
    seen.append(("idle", mw.accepting, mw.queue_size()))


@pytest.mark.parametrize("pacing", ["free", "ticked"])
def test_worker_protocol_matches_jax(pacing):
    ref, port = _script(jworkers), _script(tworkers, pacing)
    assert port["seen"] == ref["seen"]
    assert port["passes"] == ref["passes"]
    assert port["looped"] == ref["looped"]
    assert port["prepared"] == ref["prepared"]
    # The script's expectations, spelled out.
    assert port["passes"] == [(1, False, False), (4, True, False), (6, False, False)]
    assert port["looped"] == [1, 6]  # no bootstrap keyframe, no failed pass
    assert ("2 queued", True, 1, True) in port["seen"]  # an insert raises the abort flag
    assert ("3 queued", False, 2) in port["seen"]  # backpressure: one behind the pass
    assert ("shut down", False, False) in port["seen"]
    assert [(kf, type(e)) for kf, e in port["mw"].errors] == [(5, ValueError)]
    assert port["lw"].errors == []


def test_worker_lists_the_keyframes_waiting_for_their_pass():
    """``queued`` names the keyframes behind the pass in flight, in order,
    and drops each as its pass starts."""
    mapper = FakeMapper()
    mw = tworkers.MappingWorker(mapper, threading.RLock())
    try:
        with mw.pacer.free_running():
            mw.insert_keyframe(1)
            assert _until(lambda: len(mapper.passes) == 1)
            mw.insert_keyframe(2)
            mw.insert_keyframe(3)
            assert mw.queued() == [2, 3]
            mapper.gate(1).set()
            assert _until(lambda: len(mapper.passes) == 2)
            assert mw.queued() == [3]
            for kf in (2, 3):
                mapper.gate(kf).set()
            assert mw.wait_idle(TIMEOUT)
            assert mw.queued() == []
    finally:
        mw.shutdown(timeout=TIMEOUT)


def _redundant_map():
    """Eight keyframes that all observe the same 40 points (every point seen
    by all eight, so every keyframe is 100% redundant), and a LocalMapper on
    them. Keyframe 7 is the one whose pass runs the culling."""
    import numpy as np
    import torch

    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.map.store import MapConfig, MapStore
    from os1_tpu_torch.pipeline.config import SlamConfig
    from os1_tpu_torch.pipeline.local_mapping import LocalMapper

    class _Mirror:
        device = torch.device("cpu")

    cfg = SlamConfig(camera=Camera.make(100.0, 100.0, 40.0, 30.0, width=80, height=60),
                     orb=OrbConfig(height=60, width=80, n_features=40, n_levels=2),
                     map=MapConfig(max_keyframes=8, max_points=64, n_features=40,
                                   max_obs_per_point=8))
    store = MapStore(cfg.map)
    for _ in range(8):
        store.add_keyframe_pending(np.eye(4), frame_id=0)
    pts = store.alloc_points(40)
    store.pt_valid[pts] = True
    for k in range(8):
        store.add_observations(pts, np.full(40, k), np.arange(40))
    return store, LocalMapper(cfg=cfg, store=store, mirror=_Mirror())


@pytest.mark.parametrize("queued", [[], [2], [2, 5]])
def test_culling_spares_keyframes_waiting_for_their_pass(queued):
    store, mapper = _redundant_map()
    culled = []
    mapper.on_cull_keyframe = culled.append
    mapper.queued_fn = lambda: list(queued)
    mapper.cull_keyframes(7)
    assert all(store.kf_valid[k] for k in queued)
    assert not set(culled) & set(queued) and not set(culled) & {0, 1, 7}
    # The gauge and the pass's own keyframe stay; the first unprotected
    # covisible keyframe goes (then its points are seen by fewer than four).
    first = min(set(range(2, 7)) - set(queued))
    assert culled[0] == first


def test_without_the_rule_a_waiting_keyframe_is_culled():
    """The JAX package's rule, no queue: keyframe 2 is culled although its
    pass has not run."""
    store, mapper = _redundant_map()
    mapper.cull_keyframes(7)
    assert not store.kf_valid[2]


def test_loop_worker_keeps_errors():
    def process(kf):
        if kf == 2:
            raise RuntimeError("boom")
        done.append(kf)

    done = []
    lw = tworkers.LoopWorker(process, threading.RLock())
    try:
        for kf in (1, 2, 3):
            lw.insert_keyframe(kf)
        assert lw.wait_idle(TIMEOUT)
    finally:
        lw.shutdown(timeout=TIMEOUT)
    assert done == [1, 3]
    assert [(kf, type(e)) for kf, e in lw.errors] == [(2, RuntimeError)]


def test_map_lock_counts_the_wait_per_thread():
    lock = tworkers.MapLock()
    held = threading.Event()

    def hold():
        with lock:
            held.set()
            time.sleep(0.2)

    t = threading.Thread(target=hold, name="Holder")
    t.start()
    assert held.wait(TIMEOUT)
    with lock:  # waits about 0.2 s
        with lock:  # re-entrant: no wait
            pass
    t.join(TIMEOUT)
    assert not t.is_alive()
    me = threading.current_thread().name
    assert lock.waits[me] == 1 and 0.1 < lock.wait_s[me] < 5.0
    assert "Holder" not in lock.waits
    lock.reset_stats()
    assert not lock.waits and not lock.wait_s


N_THREADS = 32  # more than the cores


def _hammer(fn, n=500):
    def body():
        for _ in range(n):
            fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, name=f"T{i}") for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return N_THREADS * n


def test_counters_are_exact_under_threads():
    reads = HostReads()
    total = _hammer(reads.tick)
    assert reads.count == total

    timer = StageTimer()

    def stage():
        with timer("s"):
            pass

    assert _hammer(stage) == timer.counts["s"]

    def fake_wrapper():
        cuda_build.count_launch(fake_wrapper)

    cuda_build.reset_launches(fake_wrapper)
    total = _hammer(fake_wrapper)
    assert fake_wrapper.launches == total
    assert fake_wrapper.launches_by_thread == {f"T{i}": total // N_THREADS
                                               for i in range(N_THREADS)}
    cuda_build.reset_launches(fake_wrapper)
    assert fake_wrapper.launches == 0 and fake_wrapper.launches_by_thread == {}
