"""The threaded mode of the port, ``System(cfg, async_mapping=True)``: the
tracker on the caller's thread, local mapping on the LocalMapping thread,
loop closing on the LoopClosing thread and each global BA on a GlobalBA
thread, on the CPU at 240x320, 512 features, 4 levels, MapConfig(64, 8192,
512), on orbit_trajectory(40, advance=0.08) of default_scene(seed=3) (the
JAX package's own pipeline test sequence).

- ``tests/test_async_pipeline.py``'s ``TestThreadedPipeline`` on the port, with
  its gates: initialized before frame 10, OK on more than 85% of the frames
  from the first OK one, at least 3 keyframes and 100 points, every live
  keyframe materialized and nothing pending after flush, more than 25
  trajectory entries, ATE under 15% of the path length (the mode is not
  deterministic: the bound catches a corrupt map, not drift); no worker
  caught an exception. A reset with keyframes queued leaves nothing
  pending, and the system initializes again.
- With a barrier (``pipelined=False``, both workers and the global BA waited
  for after every frame, the mapping pass not paced meanwhile) the threaded
  mode runs the same keyframe passes in the same order as the synchronous
  mode, so the trajectories are bit-identical (SHA-256 of the poses).
- The mapping pass advances one stage a tracked frame: it waits for the
  next frame, and runs straight through while the pacer is free. A stop
  request (a loop correction) or shutdown lets the pass in flight finish
  with no frame tracked; a correction whose stop request is not met in time
  raises with the worker released.
- The detached global BA on that run's map: a newer loop's ``abort_gba``
  stops it between chunks (no chunk after the abort, the map untouched); a
  second one runs its four chunks on the GlobalBA thread, with local mapping
  stopped for its write-back, and ``flush()`` joins it.

Every wait carries a timeout; every system is shut down in a ``finally``.
"""
import copy
import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import synthetic
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState
from os1_tpu_torch.pipeline import loop_closing

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
WAIT = 60.0


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    return SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H),
                      orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def sequence():
    poses = synthetic.orbit_trajectory(40, advance=0.08)
    return synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W), poses


def _traj(sys_, poses):
    """(ATE, path length, entries, SHA-256 prefix of the poses)."""
    traj = sys_.frame_trajectory()
    est = [T for (_, _, T) in traj]
    gt = [poses[fid] for (_, fid, _) in traj]
    centres = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
    length = np.linalg.norm(np.diff(centres, axis=0), axis=1).sum()
    sha = hashlib.sha256(np.ascontiguousarray(np.stack(est)).tobytes()).hexdigest()[:16]
    return synthetic.ate_rmse(est, gt), length, len(est), sha


@pytest.fixture(scope="module")
def sync_run(sequence):
    frames, poses = sequence
    s = System(_config(), device="cpu", pipelined=False)
    try:
        for i, f in enumerate(frames):
            s.track_monocular(f, timestamp=i / 30.0)
        s.flush()
    finally:
        s.shutdown()
    return dict(sys=s, sha=_traj(s, poses)[3])


def test_threaded_tracks_and_maps(sequence):
    frames, poses = sequence
    s = System(_config(), device="cpu", pipelined=True, async_mapping=True)
    try:
        assert s.mapping_worker is not None and s.loop_worker is not None and s.coop is None
        states = [s.track_monocular(f, timestamp=i / 30.0)[0] for i, f in enumerate(frames)]
        s.flush()
        first_ok = next(i for i, st in enumerate(states) if st == TrackingState.OK)
        assert first_ok < 10, [st.name for st in states[:12]]
        ok_after = [st == TrackingState.OK for st in states[first_ok:]]
        assert np.mean(ok_after) > 0.85, [st.name for st in states]
        assert s.store.n_keyframes() >= 3
        assert s.store.n_points() > 100
        live = np.nonzero(s.store.kf_valid)[0]
        assert all(s.store.kf_feat_valid[k].any() for k in live)
        assert not s._pending_frames
        assert s.mapping_worker.queue_size() == 0 and s.loop_worker.queue_size() == 0
        ate, length, n_est, _ = _traj(s, poses)
        assert n_est > 25
        assert ate < 0.15 * length, f"ATE {ate:.4f} over {length:.2f}"
        assert s.worker_errors() == []
        assert s.mapping_worker.max_queue >= 1  # the passes ran on the LocalMapping thread
    finally:
        s.shutdown()
    assert not s.mapping_worker._thread.is_alive() and not s.loop_worker._thread.is_alive()


def test_threaded_reset_mid_sequence(sequence):
    frames, _ = sequence
    s = System(_config(), device="cpu", pipelined=True, async_mapping=True)
    try:
        for i, f in enumerate(frames[:20]):
            s.track_monocular(f, timestamp=i / 30.0)
        s.reset()
        assert not s._pending_frames
        states = [s.track_monocular(f, timestamp=1.0 + i / 30.0)[0] for i, f in enumerate(frames)]
        s.flush()
        assert TrackingState.OK in states
        assert s.worker_errors() == []
    finally:
        s.shutdown()


def test_threaded_with_a_barrier_matches_sync(sequence, sync_run):
    frames, poses = sequence
    s = System(_config(), device="cpu", pipelined=False, async_mapping=True)
    try:
        for i, f in enumerate(frames):
            s.track_monocular(f, timestamp=i / 30.0)
            with s.mapping_worker.pacer.free_running():
                assert s.mapping_worker.wait_idle(WAIT)
                assert s.loop_worker.wait_idle(WAIT)
                assert s.loop_closer.wait_gba(WAIT)
        s.flush()
        assert s.worker_errors() == []
        assert _traj(s, poses)[3] == sync_run["sha"]
    finally:
        s.shutdown()


def _until(pred, timeout=WAIT):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


def test_detached_global_ba(sync_run, monkeypatch):
    """Spawned, aborted between chunks by a newer loop, joined by flush()."""
    t0 = time.perf_counter()
    chunks, gate = [], threading.Event()
    iterate = loop_closing.ba_iterate

    def gated(prob, state, n):
        chunks.append(threading.current_thread().name)
        if len(chunks) == 2:
            assert gate.wait(WAIT)
        return iterate(prob, state, n)

    monkeypatch.setattr(loop_closing, "ba_iterate", gated)
    s = System(_config(), store=copy.deepcopy(sync_run["sys"].store), device="cpu",
               pipelined=True, async_mapping=True)
    lc = s.loop_closer
    try:
        T0, X0 = s.store.kf_T.copy(), s.store.pt_xyz.copy()
        lc._spawn_gba()
        assert _until(lambda: len(chunks) == 2)
        aborter = threading.Thread(target=lc.abort_gba)  # what a newer loop does first
        aborter.start()
        assert _until(lambda: lc._stop_gba)
        gate.set()
        aborter.join(WAIT)
        assert not aborter.is_alive() and lc._gba_thread is None
        assert chunks == ["GlobalBA"] * 2  # no chunk after the abort
        np.testing.assert_array_equal(s.store.kf_T, T0)
        np.testing.assert_array_equal(s.store.pt_xyz, X0)

        chunks.clear()
        lc._stop_gba = False
        lc._spawn_gba()
        s.flush()  # joins it
        assert not lc._gba_thread.is_alive()
        assert chunks == ["GlobalBA"] * (loop_closing.GBA_ITERS // loop_closing.GBA_CHUNK)
        assert lc.gba_spawned == 2 and lc.gba_errors == []
        assert np.abs(s.store.kf_T - T0).max() > 1e-7  # the solve was written back
        assert s.mapping_worker.accepting  # released after the write-back
    finally:
        s.shutdown()
    assert time.perf_counter() - t0 < 30.0


class _Stages:
    """A fake mapper whose pass has four stages."""

    def __init__(self):
        self.abort_ba = False
        self.done = []

    def process_steps(self, kf, bootstrap=False):
        for k in range(4):
            self.done.append((kf, k))
            yield


def test_mapping_pass_is_paced_by_frames():
    """A fake pass of four stages advances one stage a tick, and runs through
    once the pacer is free."""
    from os1_tpu_torch.pipeline.workers import MappingWorker

    mapper = _Stages()
    w = MappingWorker(mapper, threading.RLock())
    try:
        w.insert_keyframe(1)
        assert _until(lambda: len(mapper.done) == 1)
        time.sleep(0.2)
        assert len(mapper.done) == 1  # waits for a frame
        w.pacer.tick()
        assert _until(lambda: len(mapper.done) == 2)
        time.sleep(0.2)
        assert len(mapper.done) == 2
        with w.pacer.free_running():
            assert w.wait_idle(WAIT)
        assert mapper.done == [(1, k) for k in range(4)]
    finally:
        w.shutdown(timeout=WAIT)
    assert not w._thread.is_alive()


def test_stop_needs_no_frames():
    """A paced pass in flight, then a stop request with no frame tracked
    (the caller stopped feeding frames while a loop is corrected): the pass
    finishes unpaced and the worker stops; after the release the next pass
    is paced again. Shutdown mid-pass needs no frame either."""
    from os1_tpu_torch.pipeline.workers import MappingWorker

    mapper = _Stages()
    w = MappingWorker(mapper, threading.RLock())
    try:
        w.insert_keyframe(1)
        assert _until(lambda: len(mapper.done) == 1)
        w.request_stop()
        assert w.wait_stopped(WAIT)
        assert mapper.done == [(1, k) for k in range(4)]
        w.release()
        w.insert_keyframe(2)
        assert _until(lambda: len(mapper.done) == 5)
        time.sleep(0.2)
        assert len(mapper.done) == 5  # paced again
    finally:
        w.shutdown(timeout=WAIT)
    assert not w._thread.is_alive()
    assert mapper.done[4:] == [(2, k) for k in range(4)]


def test_correction_fails_when_mapping_does_not_stop(monkeypatch):
    """``LoopCloser._stop_mapping`` raises when the worker has not stopped in
    time, and releases it, so the map is not corrected under a running pass
    and local mapping is not left stopped."""
    from types import SimpleNamespace

    from os1_tpu_torch.utils.profiling import StageTimer

    calls = []
    worker = SimpleNamespace(request_stop=lambda: calls.append("stop"),
                             wait_stopped=lambda timeout: calls.append(timeout) and False,
                             release=lambda: calls.append("release"))
    monkeypatch.setattr(loop_closing, "STOP_WAIT_S", 0.25)
    closer = SimpleNamespace(mapping_worker=worker, timer=StageTimer())
    with pytest.raises(RuntimeError, match="did not stop"):
        loop_closing.LoopCloser._stop_mapping(closer)
    assert calls == ["stop", 0.25, "release"]


def test_refilled_point_slots_are_not_bound(sequence):
    """Points culled while frames are in flight and their slots refilled with
    new points at the same places with the same descriptors (a point
    triangulated again): a frame dispatched before the refill and read after
    it drops those bindings instead of taking the new points for the old
    ones (the slots are valid again and the geometry fits, so neither the
    validity check nor the pose's inlier test can tell them apart); each drop
    is counted in ``Tracker.stale_binds``. The next dispatch masks the
    refilled slots in the device chain it extends."""
    frames, _ = sequence
    s = System(_config(), device="cpu", pipelined=True, enable_loop_closing=False)
    try:
        for i, f in enumerate(frames[:16]):
            s.track_monocular(f, timestamp=i / 30.0)
        tr, st = s.tracker, s.store
        assert tr.state == TrackingState.OK and tr._pending and tr._chain is not None
        bound = np.unique(tr.last.bind[tr.last.bind >= 0])[:40]
        assert len(bound) == 40
        kept = {f: getattr(st, f)[bound].copy()
                for f in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist")}
        st.cull_points(bound)
        for p in bound:
            st._pt_cursor = int(p)
            assert st.alloc_points(1)[0] == p
        for f, v in kept.items():
            getattr(st, f)[bound] = v
        s.mirror.refresh()
        s.track_monocular(frames[16], timestamp=16 / 30.0)  # applies a frame dispatched before
        assert tr.stale_binds > 0
        assert tr.state == TrackingState.OK
        assert not np.isin(tr.last.bind, bound).any()
        s.flush()
        assert tr.state == TrackingState.OK
    finally:
        s.shutdown()
