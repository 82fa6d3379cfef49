"""Multi-session maps in the port (os1_tpu_torch.io.osmap_io.merge_map,
System.merge_session), on the CPU at 240x320, 512 features, 4 levels,
MapConfig(64, 8192, 512), the JAX package's merge test setting with shorter
sessions: two sync port sessions over the overlapping spans (0, 60) and
(40, 100) of loop_trajectory(100, radius=1.5, revolutions=0.6) in
room_scene(seed=5) (the JAX test's circuit, 0.9 revolutions over 150
frames, at the same step), saved as Osmap maps.

- ``merge_map`` against the JAX package's: session B merged into a store
  holding session A gives the same old-id -> slot maps and equal store
  arrays, exactly.
- A fresh system loads A and merges B: it returns True, the keyframe count
  grows, poses and points are finite, the joint keyframe trajectory's
  Sim3-aligned ATE is under 5% of the path length (the JAX merge test's
  gate), and keyframes of both spans are present.
- A merge with a session over another scene (default_scene(seed=11)) finds
  no alignment, returns False and leaves the keyframe and point counts as
  they were.
"""
import dataclasses

import numpy as np
import pytest
import torch

from os1_tpu_torch.io import osmap_io, synthetic
from os1_tpu_torch.map.store import MapStore
from os1_tpu_torch.pipeline import System

from test_torch_osmap import H, K, W, assert_stores_equal, config

SPANS = ((0, 60), (40, 100))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def session(frames, lo, hi, base):
    sys_ = System(config(), device="cpu")
    for i in range(lo, hi):
        sys_.track_monocular(frames[i], timestamp=i / 30.0)
    sys_.flush()
    assert sys_.store.n_keyframes() >= 4, f"session {lo}-{hi} built no map"
    sys_.save_map(base)
    return base


@pytest.fixture(scope="module")
def two_sessions(tmp_path_factory):
    poses = synthetic.loop_trajectory(100, radius=1.5, revolutions=0.6)
    frames = synthetic.render_sequence(synthetic.room_scene(seed=5), poses, K, H, W)
    tmp = tmp_path_factory.mktemp("merge")
    bases = [session(frames, lo, hi, str(tmp / f"session{i}")) for i, (lo, hi) in enumerate(SPANS)]
    return bases, poses


def test_merge_map_equals_the_jax_package(two_sessions):
    pytest.importorskip("google.protobuf")
    pytest.importorskip("jax")
    from os1_tpu.io import osmap_io as jio
    from os1_tpu.map.store import MapConfig as JMapConfig
    from os1_tpu.map.store import MapStore as JMapStore

    bases, _ = two_sessions
    cfg = config()
    ps = MapStore(cfg.map)
    js = JMapStore(JMapConfig(**dataclasses.asdict(cfg.map)))
    osmap_io.load_map(ps, cfg, bases[0])
    jio.load_map(js, cfg, bases[0])
    kf_p, pt_p = osmap_io.merge_map(ps, cfg, bases[1])
    kf_j, pt_j = jio.merge_map(js, cfg, bases[1])
    np.testing.assert_array_equal(kf_p, kf_j)
    np.testing.assert_array_equal(pt_p, pt_j)
    assert (kf_p >= 0).sum() > 0 and (pt_p >= 0).sum() > 0
    assert_stores_equal(ps, js)


def test_merge_two_sessions(two_sessions):
    bases, poses = two_sessions
    sys_ = System(config(), device="cpu")
    sys_.load_map(bases[0])
    n_a = sys_.store.n_keyframes()
    assert sys_.merge_session(bases[1]), "cross-session alignment not found"
    st = sys_.store
    assert st.n_keyframes() > n_a
    assert np.isfinite(st.kf_T[st.kf_valid]).all()
    assert np.isfinite(st.pt_xyz[st.pt_valid]).all()
    traj = sys_.keyframe_trajectory()
    fids = [int(round(ts * 30.0)) for ts, _ in traj]
    est = [np.linalg.inv(Twc) for _, Twc in traj]
    gt = [poses[f] for f in fids]
    ate = synthetic.ate_rmse(est, gt)
    centers = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
    path = np.linalg.norm(np.diff(centers, axis=0), axis=1).sum()
    assert ate < 0.05 * path, f"merged-map ATE {ate:.4f} over a path of {path:.2f}"
    assert min(fids) < SPANS[0][1] - 30 and max(fids) >= SPANS[1][0] + 30


def test_merge_rolls_back_without_overlap(two_sessions, tmp_path):
    bases, _ = two_sessions
    poses = synthetic.orbit_trajectory(30, advance=0.08)
    frames = synthetic.render_sequence(synthetic.default_scene(seed=11), poses, K, H, W)
    other = session(frames, 0, len(frames), str(tmp_path / "other"))
    sys_ = System(config(), device="cpu")
    sys_.load_map(bases[0])
    n_kf, n_pt = sys_.store.n_keyframes(), sys_.store.n_points()
    assert not sys_.merge_session(other), "disjoint sessions must not align"
    assert sys_.store.n_keyframes() == n_kf
    assert sys_.store.n_points() == n_pt
