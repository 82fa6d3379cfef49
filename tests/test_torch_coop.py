"""The shipped mode of the port, ``System(cfg, pipelined=True,
coop_mapping=True, enable_loop_closing=False)``: pipelined tracking over the
device chain and the cooperative mapping scheduler (os1_tpu_torch.pipeline.
workers.CoopScheduler), on the CPU at 240x320, 512 features, 4 levels,
MapConfig(64, 8192, 512), on orbit_trajectory(40, advance=0.08) of
default_scene(seed=3) (the JAX package's own pipeline test sequence).

- Against the JAX package in the same mode (distributed=False; the two-view
  draws replayed): the same state, keyframe count and point count on every
  frame of the first 17 (0-16), poses within atol 1e-3 (measured 2.3e-4).
  The prefix stops there because frame 15's result, applied at frame 16,
  binds 7 features differently: their chi2 sit on the 5.991 threshold, and
  the points they bind, triangulated in float32, already differ by up to
  5.2e-4 between the packages (the triangulation drift
  tests/test_torch_mapping.py documents). From frame 17 the new keyframe's
  triangulation accepts 10 more points in the port, and the runs part.
- Two port runs give bit-identical trajectories (SHA-256 of the poses).
- The run tracks and maps: initialized before frame 10, OK on every frame
  from the first OK one, every live keyframe materialized, nothing pending
  and the scheduler idle after flush, ATE under 4% of the path length (the
  JAX package's coop bound).
- A reset with keyframe events queued clears the scheduler and the pending
  frames, and the system initializes again.
- Localization mode drains the scheduler and leaves the store bit-identical
  while the rest of the sequence is tracked.
- The scheduler's protocol on a stub mapper: insert raises the BA abort
  flag, a new event lowers it, the backpressure bound, step budgets, drain
  and clear.
"""
import hashlib

import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import synthetic
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState
from os1_tpu_torch.pipeline.workers import CoopScheduler

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 40
N_PARITY = 17
SHIPPED = dict(enable_mapping=True, enable_loop_closing=False, pipelined=True,
               coop_mapping=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    return SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H,
                                         device="cpu"),
                      orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def sequence():
    poses = synthetic.orbit_trajectory(N_FRAMES, advance=0.08)
    return synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W), poses


def _run(frames, **kw):
    sys_ = System(_config(), device="cpu", **{**SHIPPED, **kw})
    states = [sys_.track_monocular(f, timestamp=i / 30.0)[0] for i, f in enumerate(frames)]
    sys_.flush()
    return sys_, states


def _sha(sys_):
    poses = np.stack([T for _, _, T in sys_.frame_trajectory()])
    return hashlib.sha256(np.ascontiguousarray(poses).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def two_runs(sequence):
    return [_run(sequence[0]) for _ in range(2)]


def test_coop_tracks_and_maps(two_runs, sequence):
    sys_, states = two_runs[0]
    first = states.index(TrackingState.OK)
    assert first < 10
    assert all(s == TrackingState.OK for s in states[first:]), [s.name for s in states]
    st = sys_.store
    assert st.n_keyframes() >= 3 and st.n_points() > 100
    assert all(st.kf_feat_valid[k].any() for k in np.nonzero(st.kf_valid)[0])
    assert not sys_._pending_frames and not sys_.coop.busy() and not sys_.tracker._pending
    assert not sys_.mirror._pending_rows
    traj = sys_.frame_trajectory()
    poses = sequence[1]
    gt = [poses[f] for _, f, _ in traj]
    ate = synthetic.ate_rmse([T for _, _, T in traj], gt)
    path = np.linalg.norm(np.diff(np.array([-T[:3, :3].T @ T[:3, 3] for T in gt]), axis=0),
                          axis=1).sum()
    assert len(traj) > 25 and ate < 0.04 * path, (ate, path)
    # Every keyframe event added its BoW vector; culled keyframes left the database.
    assert np.array_equal(sys_.db.active, st.kf_valid)


def test_coop_deterministic(two_runs):
    (a, sa), (b, sb) = two_runs
    assert sa == sb
    assert _sha(a) == _sha(b)


def test_coop_matches_jax_prefix(sequence):
    pytest.importorskip("jax")
    from os1_tpu.features.orb import OrbConfig as JOrb
    from os1_tpu.geometry.camera import Camera as JCamera
    from os1_tpu.map.store import MapConfig as JMap
    from os1_tpu.pipeline import SlamConfig as JSlam
    from os1_tpu.pipeline import System as JSystem

    from test_torch_slice import ReplaySampler

    cam = JCamera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    jsys = JSystem(cfg=JSlam(camera=cam, orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                             map=JMap(max_keyframes=64, max_points=8192, n_features=512)),
                   distributed=False, **SHIPPED)
    tsys = System(_config(), device="cpu", sampler=ReplaySampler(), **SHIPPED)
    frames = sequence[0]
    for i in range(N_PARITY):
        sj, Tj = jsys.track_monocular(frames[i], timestamp=i / 30.0)
        st, Tt = tsys.track_monocular(frames[i], timestamp=i / 30.0)
        assert st.name == sj.name, i
        assert tsys.store.n_keyframes() == jsys.store.n_keyframes(), i
        assert tsys.store.n_points() == jsys.store.n_points(), i
        if Tj is not None:
            np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    jsys.flush()
    tsys.flush()
    tj, tt = jsys.frame_trajectory(), tsys.frame_trajectory()
    assert [f for _, f, _ in tt] == [f for _, f, _ in tj]
    for (_, _, A), (_, _, B) in zip(tj, tt):
        np.testing.assert_allclose(B, A, atol=1e-3)
    assert tsys.store.n_keyframes() >= 5


def test_coop_reset_mid_sequence(sequence):
    frames = sequence[0]
    sys_ = System(_config(), device="cpu", **SHIPPED)
    for i, f in enumerate(frames[:12]):
        sys_.track_monocular(f, timestamp=i / 30.0)
    assert sys_.store.n_keyframes() > 2
    sys_.reset()
    assert not sys_._pending_frames and not sys_.coop.busy() and not sys_.tracker._pending
    assert sys_.store.n_keyframes() == 0 and not sys_.db.active.any()
    assert sys_.state == TrackingState.NO_IMAGES_YET
    states = [sys_.track_monocular(f, timestamp=1.0 + i / 30.0)[0]
              for i, f in enumerate(frames[:10])]
    sys_.flush()
    assert TrackingState.OK in states and sys_.store.n_keyframes() >= 2


def test_localization_mode_freezes_the_store(sequence):
    frames = sequence[0]
    sys_ = System(_config(), device="cpu", **SHIPPED)
    for i, f in enumerate(frames[:25]):
        sys_.track_monocular(f, timestamp=i / 30.0)
    sys_.activate_localization_mode()
    assert not sys_.coop.busy()
    st = sys_.store
    before = {k: v.copy() for k, v in vars(st).items() if isinstance(v, np.ndarray)}
    states = [sys_.track_monocular(f, timestamp=(25 + i) / 30.0)[0]
              for i, f in enumerate(frames[25:33])]
    sys_.flush()
    assert states[-1] == TrackingState.OK
    for k, v in before.items():
        assert np.array_equal(getattr(st, k), v), k
    sys_.deactivate_localization_mode()
    assert sys_.enable_mapping and not sys_.tracker.only_tracking


class _StubMapper:
    def __init__(self):
        self.abort_ba = False
        self.log = []

    def process_steps(self, kf, bootstrap=False):
        self.log.append(("start", kf))
        for s in range(2 if bootstrap else 3):
            yield
            self.log.append(("step", kf, s))


def test_scheduler_protocol():
    m = _StubMapper()
    done = []
    sch = CoopScheduler(m, on_prepare=lambda k: done.append(("prep", k)),
                        on_pass_done=lambda k: done.append(("pass", k)))
    assert sch.accepting and not sch.busy()
    sch.insert(1)
    assert m.abort_ba and sch.queue_size() == 1
    sch.step()
    assert not m.abort_ba and done == [("prep", 1)] and sch.busy()
    sch.insert(2)
    sch.insert(3)
    assert m.abort_ba and not sch.accepting and sch.queue_size() == 2
    sch.step(budget=3)  # finishes event 1, whose last step is the pass-done publish
    assert ("pass", 1) in done and sch.queue_size() == 2
    sch.clear()
    assert not sch.busy() and sch.accepting
    sch.insert(4, bootstrap=True)
    sch.drain()
    assert not sch.busy() and done[-2:] == [("prep", 4), ("pass", 4)]
    assert m.log[-1] == ("step", 4, 1)
