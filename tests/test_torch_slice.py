"""Port parity of the whole slice: the JAX System and the port's System, both
as System(enable_mapping=False, enable_loop_closing=False, pipelined=False),
at 240x320, 512 features, 4 levels, MapConfig(64, 8192, 512), on the first 30
frames of orbit_trajectory(60, advance=0.05) of default_scene(seed=3).

The RANSAC draws are replayed: the port's sampler reproduces the tracker's
key split and the initializer's split of the JAX package. Required: the same
state sequence, initialization frame and keyframe count; per-frame poses
within atol 1e-3 (measured ~1e-4: float32 solves summed in another order);
the port's ATE within the JAX run's ATE + 0.005.

The fused step is also held against the JAX one on the same map: the JAX
map store is handed to the port through os1_tpu_torch.convert.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.features.orb import OrbConfig as JOrb  # noqa: E402
from os1_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from os1_tpu.io import synthetic  # noqa: E402
from os1_tpu.map.store import MapConfig as JMap  # noqa: E402
from os1_tpu.pipeline import SlamConfig as JSlam  # noqa: E402
from os1_tpu.pipeline import System as JSystem  # noqa: E402
from os1_tpu.pipeline import tracking_fused as jfused  # noqa: E402
from os1_tpu.solvers.initializer import _sample_indices  # noqa: E402
from os1_tpu_torch import convert  # noqa: E402
from os1_tpu_torch.map.mirror import DeviceMirror  # noqa: E402
from os1_tpu_torch.map.store import MapConfig  # noqa: E402
from os1_tpu_torch.pipeline import SlamConfig, System  # noqa: E402
from os1_tpu_torch.pipeline import tracking_fused as tfused  # noqa: E402

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 30
SLICE = dict(enable_mapping=False, enable_loop_closing=False, pipelined=False)


class ReplaySampler:
    """Replays the JAX tracker's draws: per bootstrap attempt the tracker
    splits its key (tracking.py) and the initializer splits the subkey into
    the homography and fundamental keys (initializer.py)."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.pending = []

    def __call__(self, valid, iters, k):
        if not self.pending:
            self.key, sub = jax.random.split(self.key)
            self.pending = list(jax.random.split(sub))
        idx = _sample_indices(self.pending.pop(0), jnp.asarray(valid.numpy()), iters, k)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _jax_system():
    cam = JCamera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    cfg = JSlam(camera=cam, orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                map=JMap(max_keyframes=64, max_points=8192, n_features=512))
    return JSystem(cfg=cfg, **SLICE)


def _port_config(jcfg):
    return SlamConfig(camera=convert.camera_from_numpy(jcfg.camera, device="cpu"),
                      orb=convert.orb_config_from_fields(jcfg.orb),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def runs():
    scene = synthetic.default_scene(seed=3)
    poses = synthetic.orbit_trajectory(60, advance=0.05)
    frames = synthetic.render_sequence(scene, poses[:N_FRAMES + 1], K, H, W)
    jsys = _jax_system()
    tsys = System(_port_config(jsys.cfg), device="cpu", sampler=ReplaySampler(), **SLICE)
    js, ts = [], []
    for i in range(N_FRAMES):
        js.append(jsys.track_monocular(frames[i], timestamp=i / 30.0)[0].name)
        ts.append(tsys.track_monocular(frames[i], timestamp=i / 30.0)[0].name)
    return dict(jsys=jsys, tsys=tsys, js=js, ts=ts, poses=poses, frames=frames)


def test_slice_matches_jax(runs):
    js, ts = runs["js"], runs["ts"]
    assert ts == js
    assert js.index("OK") == 2 and js[2:] == ["OK"] * (N_FRAMES - 2)
    jsys, tsys = runs["jsys"], runs["tsys"]
    assert tsys.store.n_keyframes() == jsys.store.n_keyframes()
    assert tsys.store.n_points() == jsys.store.n_points()
    tj, tt = jsys.frame_trajectory(), tsys.frame_trajectory()
    assert [f for _, f, _ in tt] == [f for _, f, _ in tj]
    for (_, _, Tj), (_, _, Tt) in zip(tj, tt):
        np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    poses = runs["poses"]
    ate_j = synthetic.ate_rmse([T for *_, T in tj], [poses[f] for _, f, _ in tj])
    ate_t = synthetic.ate_rmse([T for *_, T in tt], [poses[f] for _, f, _ in tt])
    assert ate_t <= ate_j + 0.005
    assert ate_j < 0.2


def test_fused_step_on_the_same_map(runs):
    """One fused step in each package from the JAX tracker's state, with the
    JAX map converted into the port's store."""
    jsys = runs["jsys"]
    jt = jsys.tracker
    img = runs["frames"][N_FRAMES]
    jframe = jt._build(jnp.asarray(img), jt.cfg.camera)
    prev = jt._prev_Tcw if jt._prev_Tcw is not None else jt.last.Tcw
    has_vel = jt.velocity is not None
    out_j, local_ids = jt._dispatch_fused(
        jframe, jnp.asarray(jt.last.Tcw.astype(np.float32)), jnp.asarray(prev.astype(np.float32)),
        jnp.asarray(jt.last.bind.astype(np.int32)), jt.last.data.feats.octave, has_vel,
        jt.last.bind,
    )
    N, L = jt.cfg.orb.n_features, jt.cfg.th.max_local_points
    ids_again, local_valid = jt._local_candidates(jt.last.bind)
    np.testing.assert_array_equal(ids_again, local_ids)
    hj = jfused.unpack_result(np.asarray(out_j["packed"]), N, L)

    cfg = _port_config(jsys.cfg)
    store = convert.store_from_numpy(jsys.store)
    for name in ("kf_T", "pt_xyz", "kf_obs_point", "pt_desc", "pt_obs_kf"):
        np.testing.assert_array_equal(getattr(store, name), getattr(jsys.store, name))
    mir = DeviceMirror(store, "cpu")

    def port_frame(f):
        ft = f.feats
        return convert.frame_from_numpy(ft.xy, ft.response, ft.angle, ft.octave, ft.desc,
                                        ft.valid, f.xy_un, f.sigma2, device="cpu")

    tframe = port_frame(jframe)
    step = tfused.make_fused_tracker(cfg)
    cam = convert.camera_from_numpy(jsys.cfg.camera, device="cpu")
    t = lambda a: convert.to_torch(a, device="cpu")  # noqa: E731
    out_t = step(
        mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal, mir.pt_min_dist, mir.pt_max_dist,
        mir.kf_desc, mir.kf_angle, mir.kf_obs_point, tframe, cam,
        t(cfg.intr), t(jt.last.Tcw.astype(np.float32)), t(prev.astype(np.float32)),
        t(jt.last.bind.astype(np.int64)), t(np.asarray(jt.last.data.feats.octave)),
        max(jt.ref_kf, 0), bool(jt.ref_kf >= 0), t(local_ids), t(local_valid),
        has_vel,
    )
    ht = tfused.unpack_result(out_t["packed"].numpy(), N, L)
    assert ht["pre_ok"] == hj["pre_ok"] and ht["used_motion"] == hj["used_motion"]
    assert ht["n_pre"] == hj["n_pre"] and ht["n_inliers"] == hj["n_inliers"] > 30
    np.testing.assert_array_equal(ht["bind"], hj["bind"])
    np.testing.assert_array_equal(ht["visible"], hj["visible"])
    np.testing.assert_allclose(ht["Tcw"], hj["Tcw"], atol=1e-4)
    # The result layout itself round-trips.
    again = tfused.pack_result(torch.from_numpy(ht["Tcw"]), torch.from_numpy(ht["bind"]),
                               ht["n_inliers"], ht["pre_ok"], ht["n_pre"], ht["used_motion"],
                               torch.from_numpy(np.pad(ht["visible"], (0, (-L) % 32))))
    np.testing.assert_array_equal(again.numpy(), out_t["packed"].numpy())


def test_keyframe_trajectory_export_matches_jax(runs, tmp_path):
    """The TUM keyframe export: same keyframes and timestamps, positions and
    quaternions within atol 1e-3 (the pose tolerance above)."""
    runs["jsys"].save_keyframe_trajectory_tum(str(tmp_path / "jax.txt"))
    runs["tsys"].save_keyframe_trajectory_tum(str(tmp_path / "port.txt"))
    tj = np.loadtxt(tmp_path / "jax.txt", ndmin=2)
    tt = np.loadtxt(tmp_path / "port.txt", ndmin=2)
    assert tt.shape == tj.shape and tj.shape[0] >= 2
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:], tj[:, 1:], atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(tt[:, 4:], axis=1), 1.0, atol=1e-5)


def test_incremental_mirror_equals_full_publish(runs):
    """After the run's keyframe events, the diff-and-scatter publishes leave
    the device mirror equal to a fresh full publish of the host store."""
    tsys = runs["tsys"]
    fresh = DeviceMirror(tsys.store, "cpu")
    for name in ("pt_xyz", "pt_desc", "pt_valid", "pt_normal", "pt_min_dist", "pt_max_dist",
                 "pt_n_obs", "pt_obs_kf", "pt_obs_feat", "kf_T", "kf_valid", "kf_xy",
                 "kf_angle", "kf_octave", "kf_desc", "kf_feat_valid", "kf_obs_point"):
        assert torch.equal(getattr(tsys.mirror, name), getattr(fresh, name)), name
    assert tsys.mirror.version > 2
