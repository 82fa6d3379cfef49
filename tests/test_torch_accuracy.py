"""The port's bench configuration and accuracy rig (os1_tpu_torch.io.sequences
and os1_tpu_torch.accuracy) against bench.py and accuracy.py of the JAX
package, on the CPU.

- Sequences: the orbit, loop and photo poses equal the JAX package's
  trajectories of bench.py's arguments exactly; frames 0 and 150 of each,
  rendered by the port, agree with the JAX package's renders within one grey
  level on every pixel (the JAX textures go through OpenCV's bicubic resize,
  the port's through its numpy copy, up to 8e-4 apart; the photo room has no
  resize and is bit-equal); the path length equals accuracy.py's sum.
- ``build_system``'s configuration equals bench.py's field by field in the
  three modes, with bench.py's mode mapping.
- The rig against accuracy.py's ``run_once``, both on the same 20 frames of
  the pipeline test sequence (orbit_trajectory(40, advance=0.08) of
  default_scene(seed=3)) at 240x320, 512 features, 4 levels,
  MapConfig(64, 8192, 512), sync mode, the two-view draws replayed:
  tracked, lost frames, keyframes, points and loops equal; the ATE within
  atol 1e-3 (measured 1.7e-4: float32 solves summed in another order). The
  JAX system's ``warmup()`` is replaced by a no-op: it only compiles the
  JAX programs (about 60 s on the CPU at this size) and leaves the state as
  it was; the port's ``warmup()`` runs.
- Two port runs in the sync mode and two in the coop mode give one SHA each;
  ``main`` exits 1 with ``DETERMINISM VIOLATION`` when two runs differ and 2
  when the photographs are missing.
- ``--pose-ref`` (TrackingThresholds(pose_opt_rounds=4, pose_opt_iters=10,
  pose_opt_reject=True)) and ``--debt 0`` (ba_debt_max=0) on the same
  20-frame sync run in both packages: the per-frame states equal, the poses
  within atol 1e-3 (the tolerance of tests/test_torch_mapping.py; measured
  1.6e-4); the tracked inlier counts equal on every frame but at most two,
  and there one apart (measured: frame 9 with --pose-ref; frames 9 and 18
  with --debt 0, which in the sync mode runs the default schedule: the
  matches that enter the pose solve differ by one at those frames, with
  poses already 1e-5 apart). Every pose solve of the port's run, handed on
  its own inputs to the JAX package's optimize_pose with the same schedule,
  gives the same inlier mask and a pose within 1e-4 (measured 3.7e-5 over
  the 40 LM iterations of --pose-ref, whose accept/reject tests compare
  float32 costs; 1.2e-7 with the default Gauss-Newton schedule).
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import accuracy as jaccuracy  # noqa: E402
import bench  # noqa: E402
from os1_tpu.features.orb import OrbConfig as JOrb  # noqa: E402
from os1_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from os1_tpu.io import realimg as jrealimg  # noqa: E402
from os1_tpu.io import synthetic as jsynthetic  # noqa: E402
from os1_tpu.map.store import MapConfig as JMap  # noqa: E402
from os1_tpu.pipeline import SlamConfig as JSlam  # noqa: E402
from os1_tpu.pipeline import System as JSystem  # noqa: E402
from os1_tpu.pipeline.config import TrackingThresholds as JTh  # noqa: E402
from os1_tpu_torch import accuracy  # noqa: E402
from os1_tpu_torch.features.orb import OrbConfig  # noqa: E402
from os1_tpu_torch.geometry.camera import Camera  # noqa: E402
from os1_tpu_torch.io import realimg, sequences, synthetic  # noqa: E402
from os1_tpu_torch.map.store import MapConfig  # noqa: E402
from os1_tpu_torch.pipeline import SlamConfig, System  # noqa: E402
from os1_tpu_torch.pipeline.config import TrackingThresholds  # noqa: E402
from test_torch_slice import ReplaySampler  # noqa: E402

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 20
ATE_ATOL = 1e-3
POSE_ATOL = 1e-3
SOLVE_ATOL = 1e-4
# Tracked inliers a frame: one apart on at most two frames of the twenty.
INLIER_ATOL, INLIER_FRAMES = 1, 2
POSE_REF = dict(pose_opt_rounds=4, pose_opt_iters=10, pose_opt_reject=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    poses = synthetic.orbit_trajectory(40, advance=0.08)[:N_FRAMES]
    return synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W), poses


def _port_build(sync=False, threaded=False, device=None, replay=False, **th):
    """The rig's system at the test size (the rig's mode mapping)."""
    cfg = SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512),
                     th=TrackingThresholds(**th))
    return System(cfg, device=device, sampler=ReplaySampler() if replay else None,
                  **sequences.mode_flags(sync, threaded))


def _jax_build(sync=False, threaded=False, **th):
    """accuracy.py's system at the test size (bench.py's mode mapping), on
    one device, its compile-only warmup() a no-op."""
    cam = JCamera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    cfg = JSlam(camera=cam, orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                map=JMap(max_keyframes=64, max_points=8192, n_features=512), th=JTh(**th))
    s = JSystem(cfg=cfg, pipelined=not sync, async_mapping=threaded,
                coop_mapping=not sync and not threaded, distributed=False)
    s.warmup = lambda include_loop=True: 0.0
    return s


# --------------------------------------------------------------------------- #
# Sequences and configuration
# --------------------------------------------------------------------------- #
def _jax_scene_and_poses(kind):
    if kind == "orbit":
        return jsynthetic.default_scene(seed=1), jsynthetic.orbit_trajectory(300, advance=0.05)
    scene = jsynthetic.room_scene(seed=3) if kind == "loop" else jrealimg.photo_room_scene()
    return scene, jsynthetic.loop_trajectory(300)


@pytest.mark.parametrize("kind", sequences.SEQUENCES)
def test_sequence_poses_and_frames_match_bench(kind):
    jscene, jposes = _jax_scene_and_poses(kind)
    _, poses = sequences.scene_and_poses(kind, 300)
    assert len(poses) == len(jposes) == 300
    for T, jT in zip(poses, jposes):
        assert T.dtype == jT.dtype and np.array_equal(T, jT)
    assert sequences.path_length(poses) == sum(
        float(np.linalg.norm((-jposes[i + 1][:3, :3].T @ jposes[i + 1][:3, 3])
                             - (-jposes[i][:3, :3].T @ jposes[i][:3, 3])))
        for i in range(len(jposes) - 1))
    scene, _ = sequences.scene_and_poses(kind, 300)
    for i in (0, 150):
        got = synthetic.render_sequence(scene, poses[i:i + 1], sequences.K, 480, 640)[0]
        want = np.clip(jsynthetic.render(jscene, jposes[i], sequences.K, 480, 640), 0,
                       255).astype(np.uint8)
        assert got.shape == want.shape == (480, 640) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1, (kind, i, diff.max())
        if kind == "photo":
            assert diff.max() == 0


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return obj._asdict()


def _same_config(cfg, jcfg):
    for name, val in _fields(jcfg).items():
        mine = getattr(cfg, name)
        if name == "camera":
            for k, v in _fields(val).items():
                assert np.array_equal(np.asarray(getattr(mine, k)), np.asarray(v)), k
        elif dataclasses.is_dataclass(val) or hasattr(val, "_asdict"):
            assert _fields(mine) == _fields(val), name
        else:
            assert mine == val, name


@pytest.mark.parametrize("sync,threaded", [(False, False), (True, False), (False, True)])
def test_build_system_equals_bench(monkeypatch, sync, threaded):
    """bench.build_system's SlamConfig and mode flags (its System recorded,
    not built) against the port's system, field by field."""
    import os1_tpu.pipeline

    seen = {}
    monkeypatch.setattr(os1_tpu.pipeline, "System", lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    bench.build_system(sync=sync, threaded=threaded, kf_view_angle_deg=7.0)
    s = sequences.build_system(sync=sync, threaded=threaded, device="cpu",
                               kf_view_angle_deg=7.0)
    try:
        _same_config(s.cfg, seen["cfg"])
        assert s.cfg.th.kf_view_angle_deg == 7.0
        for k in ("pipelined", "async_mapping", "coop_mapping"):
            assert getattr(s, k) == seen[k], k
        assert s.enable_loop_closing and s.enable_mapping
    finally:
        s.shutdown()


# --------------------------------------------------------------------------- #
# The rig
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def sync_runs(sequence):
    """(JAX accuracy.run_once, two port run_once), sync mode, draws replayed."""
    frames, poses = sequence
    saved = jaccuracy.build_system
    jaccuracy.build_system = _jax_build
    try:
        j = jaccuracy.run_once(frames, poses, sync=True, th_overrides={}, log_lost=False)
    finally:
        jaccuracy.build_system = saved
    build = functools.partial(_port_build, replay=True)
    ports = [accuracy.run_once(frames, poses, sync=True, th_overrides={}, log_lost=False,
                               device="cpu", build=build) for _ in range(2)]
    return j, ports


def test_rig_matches_jax(sync_runs):
    j, (p, _) = sync_runs
    assert set(p) == set(j)
    for k in ("n_tracked", "n_lost", "lost", "n_keyframes", "n_points", "n_loops"):
        assert p[k] == j[k], k
    assert p["n_tracked"] >= N_FRAMES - 4 and p["n_keyframes"] >= 3
    assert abs(p["ate"] - j["ate"]) <= ATE_ATOL, (p["ate"], j["ate"])
    assert len(p["traj_sha"]) == 16


def test_rig_deterministic(sync_runs, sequence):
    (_, (a, b)) = sync_runs
    assert a == b
    frames, poses = sequence
    build = functools.partial(_port_build)
    coop = [accuracy.run_once(frames, poses, sync=False, th_overrides={}, log_lost=False,
                              device="cpu", build=build) for _ in range(2)]
    assert coop[0]["traj_sha"] == coop[1]["traj_sha"] and coop[0] == coop[1]
    assert coop[0]["n_tracked"] >= N_FRAMES - 4


def test_main_flags_violation_and_missing_photos(monkeypatch, capsys):
    """The rig's exits: 1 with DETERMINISM VIOLATION when runs differ, 0
    when they agree (both printed with the spread line), 2 without the
    photographs; --pose-ref, --debt and --set reach the thresholds."""
    calls = []

    def fake(frames, poses, sync, th_overrides, threaded=False, device=None, **kw):
        calls.append(dict(n=len(frames), sync=sync, th=th_overrides, threaded=threaded,
                          device=device))
        return dict(ate=0.01 * len(calls), n_tracked=len(frames), n_lost=0, lost=[],
                    n_keyframes=2, n_points=10, n_loops=0, traj_sha=f"{len(calls):016x}")

    monkeypatch.setattr(accuracy, "run_once", fake)
    argv = ["--frames", "3", "--runs", "2", "--device", "cpu", "--pose-ref", "--debt", "0",
            "--set", "kf_view_angle_deg=7.5"]
    assert accuracy.main(argv) == 1
    out, err = capsys.readouterr()
    assert "sync: 2 distinct trajectories over 2 runs; ATE spread [0.0100, 0.0200]" in out
    assert "DETERMINISM VIOLATION: sync runs differ" in err
    assert out.count("run ") == 2 and "-unit path)  tracked 3/3" in out
    assert calls[0] == dict(n=3, sync=True, threaded=False, device="cpu",
                            th=dict(POSE_REF, ba_debt_max=0, kf_view_angle_deg=7.5))
    assert accuracy.main(["--frames", "3", "--runs", "2", "--async", "--device", "cpu"]) == 1
    assert "DETERMINISM VIOLATION: coop runs differ" in capsys.readouterr().err
    assert accuracy.main(["--frames", "3", "--runs", "2", "--threaded", "--device",
                          "cpu"]) == 0  # the threaded mode may differ
    assert "threaded: 2 distinct" in capsys.readouterr().out
    monkeypatch.setattr(accuracy, "run_once", lambda frames, poses, *a, **k: dict(
        fake(frames, poses, *a, **k), traj_sha="0" * 16, ate=0.5))
    assert accuracy.main(["--frames", "3", "--runs", "2", "--device", "cpu"]) == 0
    assert "sync: 1 distinct trajectories over 2 runs" in capsys.readouterr().out
    monkeypatch.setattr(realimg, "PHOTOS", "/nonexistent/photos.npz")
    assert accuracy.main(["--seq", "photo", "--frames", "3", "--device", "cpu"]) == 2
    assert "sequence unavailable" in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# --pose-ref and --debt 0
# --------------------------------------------------------------------------- #
def _per_frame(sys_, frames):
    out = []
    for i, img in enumerate(frames):
        state, T = sys_.track_monocular(img, timestamp=i / 30.0)
        last = sys_.tracker.last
        out.append((state.name, last.n_inliers if last is not None else -1, T))
    sys_.flush()
    return out


@pytest.mark.parametrize("th", [POSE_REF, dict(ba_debt_max=0)], ids=["pose_ref", "debt0"])
def test_threshold_overrides_match_jax(sequence, monkeypatch, th):
    import jax
    import jax.numpy as jnp

    from os1_tpu.optim import pose_opt as jpose_opt
    from os1_tpu_torch.pipeline import tracking_kernels

    frames, _ = sequence
    j = _per_frame(_jax_build(sync=True, **th), frames)
    s = _port_build(sync=True, device="cpu", replay=True, **th)
    for k, v in th.items():
        assert getattr(s.cfg.th, k) == v
    solves = []
    solve = tracking_kernels.optimize_pose

    def record(*args, **kw):
        out = solve(*args, **kw)
        solves.append((args, kw, out))
        return out

    monkeypatch.setattr(tracking_kernels, "optimize_pose", record)
    p = _per_frame(s, frames)
    assert [x[0] for x in p] == [x[0] for x in j]
    assert sum(x[0] == "OK" for x in p) >= N_FRAMES - 4
    d_inl = [abs(x[1] - y[1]) for x, y in zip(p, j)]
    assert max(d_inl) <= INLIER_ATOL and sum(d > 0 for d in d_inl) <= INLIER_FRAMES, d_inl
    for i, ((_, _, T), (_, _, jT)) in enumerate(zip(p, j)):
        assert (T is None) == (jT is None), i
        if T is not None:
            np.testing.assert_allclose(T, np.asarray(jT), atol=POSE_ATOL, err_msg=str(i))
    # The tracker's pose solves with this schedule, each on the port's own
    # inputs through the JAX package's optimize_pose: the same inliers.
    sched = dict(rounds=s.cfg.th.pose_opt_rounds, iters_per_round=s.cfg.th.pose_opt_iters,
                 accept_reject=s.cfg.th.pose_opt_reject)
    assert len(solves) >= N_FRAMES
    jsolve = jax.jit(jpose_opt.optimize_pose, static_argnames=tuple(sched))
    for args, kw, out in solves:
        assert kw == sched
        jr = jsolve(*(jnp.asarray(a.numpy()) for a in args), **kw)
        assert np.array_equal(np.asarray(jr.inlier), out.inlier.numpy())
        np.testing.assert_allclose(np.asarray(jr.Tcw), out.Tcw.numpy(), atol=SOLVE_ATOL)
