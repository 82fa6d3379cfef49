"""The port's shell: settings, sequences, video, drawing and the command
line, held against the JAX package where it has a counterpart.

- ``io/config.py``: ``load_slam_config`` on a settings file in the
  reference's schema and OpenCV dialect (%YAML:1.0, a 5-coefficient
  distortion, 1000 features): the same camera, extractor and map fields as
  the JAX package's with OpenCV (exact), and the same again on the line
  reader used where OpenCV is missing. The JAX package's line reader takes
  no key with a digit, so without OpenCV it reads no distortion: the port's
  does (recorded below, a reference fault not copied). ``config_fps`` and
  ``config_rgb`` and the resolution rescale agree.
- ``io/datasets.py``: the TUM, EuRoC, KITTI and image-directory layouts of
  ``tests/test_io.py`` give the same timestamps and the same images.
- ``io/video.py``: the lossless video mode delivers every frame, the same
  frames as the JAX package's; black mode gives black frames, also without
  OpenCV.
- ``viz/``: ``draw_frame`` and ``draw_map`` are pixel-equal to the JAX
  package's for the same store state (``convert.store_from_numpy``); the
  FrameDrawer draws the three states of a port run (the initialization
  flow lines included) and inspects a point.
- ``run_slam.main`` on ``--synthetic`` (640x480, 1024 features, 8 levels) on
  the CPU: the threaded default with loop closing, writing the trajectory
  and the map, prints the reference's summary keys with ``frames`` 12; the
  synchronous mode without loop closing too; the map reloaded in
  localization mode keeps its counts; ``--warmup`` builds the host libraries
  and runs ``System.warmup()`` on the settings' configuration, and exits 0.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from os1_tpu.io import config as jconfig  # noqa: E402
from os1_tpu.io import datasets as jdatasets  # noqa: E402
from os1_tpu.io import video as jvideo  # noqa: E402
from os1_tpu.map.store import MapConfig as JMapConfig  # noqa: E402
from os1_tpu.map.store import MapStore as JMapStore  # noqa: E402
from os1_tpu.viz import draw_frame as jdraw_frame  # noqa: E402
from os1_tpu.viz import draw_map as jdraw_map  # noqa: E402
from os1_tpu_torch import convert  # noqa: E402
from os1_tpu_torch.io import config as tconfig  # noqa: E402
from os1_tpu_torch.io import datasets as tdatasets  # noqa: E402
from os1_tpu_torch.io import video as tvideo  # noqa: E402
from os1_tpu_torch.viz import draw_frame as tdraw_frame  # noqa: E402
from os1_tpu_torch.viz import draw_map as tdraw_map  # noqa: E402

SETTINGS = """%YAML:1.0

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 719.0
Camera.fy: 721.5
Camera.cx: 319.5
Camera.cy: 239.5

Camera.k1: 0.063870314171528386
Camera.k2: -0.87186285126432463
Camera.p1: 0.0012
Camera.p2: -0.0007
Camera.k3: 0.72288795670281047

Camera.width: 640
Camera.height: 480

# Camera frames per second
Camera.fps: 25.0

# Color order of the images (0: BGR, 1: RGB)
Camera.RGB: 1

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.PointSize: 2
"""
SUMMARY_KEYS = {"frames", "tracked_fraction", "fps", "keyframes", "map_points",
                "loops_closed", "final_state"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def settings(tmp_path):
    path = tmp_path / "webcam.yaml"
    path.write_text(SETTINGS)
    return str(path)


def _fields(cfg):
    cam = cfg.camera
    return dict(K=[float(np.asarray(getattr(cam, k))) for k in ("fx", "fy", "cx", "cy")],
                size=(float(np.asarray(cam.width)), float(np.asarray(cam.height))),
                dist=np.asarray(cam.dist, np.float32).tolist(),
                fisheye=bool(np.asarray(cam.fisheye)), orb=tuple(cfg.orb),
                map=(cfg.map.max_keyframes, cfg.map.max_points, cfg.map.n_features))


def _no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError


@pytest.mark.parametrize("size", [None, (1280, 960)])
def test_settings_match_jax_with_opencv(settings, size):
    kw = dict(width=size[0], height=size[1]) if size else {}
    ref, port = _fields(jconfig.load_slam_config(settings, **kw)), \
        _fields(tconfig.load_slam_config(settings, **kw))
    assert port == ref
    assert port["K"][0] == pytest.approx(719.0 * (2 if size else 1))
    assert port["orb"][2] == 1024  # 1000 rounded up to 128
    assert port["dist"][4] == pytest.approx(0.72288795670281047)
    assert tconfig.config_fps(settings) == jconfig.config_fps(settings) == 25.0
    assert tconfig.config_rgb(settings) is jconfig.config_rgb(settings) is True


def test_settings_without_opencv(settings, monkeypatch):
    with_cv2 = _fields(jconfig.load_slam_config(settings))
    _no_cv2(monkeypatch)
    port, ref = _fields(tconfig.load_slam_config(settings)), \
        _fields(jconfig.load_slam_config(settings))
    assert port == with_cv2
    # The JAX package's line reader drops the keys with digits: no distortion.
    assert ref["dist"] == [0.0] * 8 and with_cv2["dist"][0] != 0.0
    assert {k: v for k, v in ref.items() if k != "dist"} == \
        {k: v for k, v in port.items() if k != "dist"}
    assert tconfig.config_fps(settings) == jconfig.config_fps(settings) == 25.0


def _same_frames(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (ta, ia), (tb, ib) in zip(a, b):
        assert ta == tb
        assert ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)


def test_dataset_layouts_match_jax(tmp_path, rng):
    # TUM
    d = tmp_path / "tum"
    (d / "rgb").mkdir(parents=True)
    lines = ["# comment"]
    for i in range(3):
        cv2.imwrite(str(d / "rgb" / f"{i}.png"), rng.integers(0, 255, (48, 64), np.uint8))
        lines.append(f"{1234.5 + i * 0.033:.4f} rgb/{i}.png")
    (d / "rgb.txt").write_text("\n".join(lines))
    tum = list(tdatasets.tum_sequence(str(d)))
    _same_frames(tum, list(jdatasets.tum_sequence(str(d))))
    assert abs(tum[1][0] - 1234.533) < 1e-3 and tum[0][1].shape == (48, 64)
    _same_frames(list(tdatasets.open_sequence(str(d))), tum)
    # EuRoC
    e = tmp_path / "euroc" / "mav0" / "cam0" / "data"
    e.mkdir(parents=True)
    csv = ["#timestamp [ns],filename"]
    for i in range(2):
        cv2.imwrite(str(e / f"{i}.png"), rng.integers(0, 255, (32, 32), np.uint8))
        csv.append(f"{1403636579763555584 + i * 50000000},{i}.png")
    (e.parent / "data.csv").write_text("\n".join(csv))
    root = str(tmp_path / "euroc")
    euroc = list(tdatasets.euroc_sequence(root))
    _same_frames(euroc, list(jdatasets.euroc_sequence(root)))
    assert abs(euroc[0][0] - 1403636579.763555584) < 1e-3
    _same_frames(list(tdatasets.open_sequence(root)), euroc)
    # KITTI
    k = tmp_path / "kitti" / "image_0"
    k.mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(k / f"{i:06d}.png"), rng.integers(0, 255, (32, 32), np.uint8))
    (k.parent / "times.txt").write_text("0.0\n0.1\n")
    kitti = list(tdatasets.kitti_sequence(str(k.parent)))
    _same_frames(kitti, list(jdatasets.kitti_sequence(str(k.parent))))
    assert abs(kitti[1][0] - 0.1) < 1e-9
    # An image directory
    g = tmp_path / "images"
    g.mkdir()
    for i in range(3):
        cv2.imwrite(str(g / f"f{i}.png"), rng.integers(0, 255, (24, 40), np.uint8))
    imgs = list(tdatasets.open_sequence(str(g)))
    _same_frames(imgs, list(jdatasets.image_dir_sequence(str(g))))
    assert [t for t, _ in imgs] == [0.0, 1 / 30.0, 2 / 30.0]


def _video(path):
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    for i in range(10):
        wr.write(np.full((48, 64, 3), i * 20, np.uint8))
    wr.release()


def _drain(mod, path):
    src = mod.VideoSource(path, mode=mod.StreamMode.VIDEO)
    frames = []
    while (f := src.get_image(timeout=5.0)) is not None:
        frames.append(f)
    src.stop()
    return frames


def test_video_modes_match_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "test.avi")
    _video(path)
    port, ref = _drain(tvideo, path), _drain(jvideo, path)
    assert len(port) == len(ref) == 10  # lossless: every frame delivered
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    means = [f.mean() for f in port]
    assert all(b >= a - 1 for a, b in zip(means, means[1:]))
    _no_cv2(monkeypatch)
    src = tvideo.VideoSource(None, width=32, height=24)
    try:
        f = src.get_image(timeout=2.0)
    finally:
        src.stop()
    assert f is not None and f.shape == (24, 32) and (f == 0).all()
    assert src.mode == tvideo.StreamMode.NEGRO


def _jax_store():
    """Three keyframes, 200 points seen by the first two and 120 by the
    third (covisibility edges of 200 and 120), some far, some coloured."""
    rng = np.random.default_rng(5)
    st = JMapStore(JMapConfig(max_keyframes=8, max_points=512, n_features=256))
    n = 256
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.3 * i, 0.05 * i, 0.0]
        st.add_keyframe(T, rng.uniform(0, 300, (n, 2)).astype(np.float32),
                        rng.uniform(0, 6, n).astype(np.float32), np.zeros(n, np.int32),
                        rng.integers(0, 2**32, (n, 8), dtype=np.uint32), np.ones(n, bool))
    p = st.alloc_points(200)
    st.pt_xyz[p] = rng.uniform(-2, 2, (200, 3)) + [0, 0, 5]
    st.pt_far[p[::17]] = True
    st.pt_color[p[::3]] = rng.integers(0, 255, (len(p[::3]), 3))
    st.add_observations(np.concatenate([p, p, p[:120]]),
                        np.concatenate([np.zeros(200), np.ones(200), np.full(120, 2)]).astype(int),
                        np.concatenate([p, p, p[:120]]))
    return st


def test_drawing_matches_jax(rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(10, 100, (20, 2)).astype(np.float32)
    bound = rng.random(20) < 0.5
    args = (img, xy, bound, np.ones(20, bool), "OK", 5, 100, 42)
    out = tdraw_frame(*args)
    assert out.shape == (142, 160, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jdraw_frame(*args))

    jst = _jax_store()
    tst = convert.store_from_numpy(jst)
    assert tst.covisibility_weights(0)[1] >= 100  # a graph edge to draw
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, 0.0, 0.2]
    for kw in (dict(), dict(show_points=False), dict(size=(160, 120), show_graph=False)):
        m = tdraw_map(tst, T, **kw)
        np.testing.assert_array_equal(m, jdraw_map(jst, T, **kw))
    assert (tdraw_map(tst, T) != 18).any()  # something was drawn


def test_frame_drawer_states():
    """The FrameDrawer over a port run: the initialization flow lines, the
    tracked points in their classes, LOST, and a point inspected by a click
    (reference FrameDrawer.cc:52-313)."""
    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.pipeline import System
    from os1_tpu_torch.viz.frame_drawer import FrameDrawer
    from test_torch_threaded import K, H, W, _config

    s = System(_config(), device="cpu", enable_loop_closing=False)
    try:
        fd = FrameDrawer(s)
        scene = synthetic.default_scene(seed=3)
        drew_init = False
        poses = synthetic.orbit_trajectory(14, advance=0.1)
        # The first frame twice: a bootstrap attempt with no parallax fails,
        # so a NOT_INITIALIZED frame has its match to draw.
        for i, T in enumerate([poses[0]] + list(poses)):
            img = synthetic.render(scene, T, K, H, W)
            state, _ = s.track_monocular(img, timestamp=i / 30.0)
            fd.update(img, state)
            assert fd.draw().shape == (H + 22, W, 3)
            drew_init |= state.name == "NOT_INITIALIZED" and fd._init_match is not None
        assert drew_init and fd.n_tracked > 50
        tr = s.tracker
        f = np.nonzero(tr.last.bind >= 0)[0][0]
        x, y = tr.last.data.feats.xy[f].tolist()
        hits = fd.inspect(x, y, radius=1.0)
        assert hits and hits[0]["n_obs"] >= 1
        assert hits[0]["origen"] in ("normal", "umbralCosBajo", "umbralCos", "svdInf")
        fd._state_name = "LOST"
        assert fd.draw().shape == (H + 22, W, 3)
    finally:
        s.shutdown()


def _main(args, capsys):
    from os1_tpu_torch.run_slam import main

    rc = main(args + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_run_slam_synthetic(tmp_path, capsys):
    traj, base = str(tmp_path / "kf.txt"), str(tmp_path / "map")
    rc, out = _main(["--synthetic", "--frames", "12", "--save-trajectory", traj,
                     "--save-map", base], capsys)
    assert rc == 0
    assert set(out) - {"ate_rmse_vs_groundtruth"} == SUMMARY_KEYS
    assert out["frames"] == 12 and out["final_state"] == "OK"
    assert out["tracked_fraction"] >= 0.75 and out["ate_rmse_vs_groundtruth"] < 0.2
    rows = [line.split() for line in open(traj)]
    assert len(rows) == out["keyframes"] >= 2 and all(len(r) == 8 for r in rows)
    assert all(os.path.exists(base + ext)
               for ext in (".yaml", ".keyframes", ".mappoints", ".features"))

    rc, again = _main(["--synthetic", "--frames", "6", "--load-map", base + ".yaml",
                       "--localization"], capsys)
    assert rc == 0 and again["frames"] == 6 and again["final_state"] == "OK"
    assert (again["keyframes"], again["map_points"]) == (out["keyframes"], out["map_points"])


def test_run_slam_sync_without_loop_closing(capsys):
    rc, out = _main(["--synthetic", "--frames", "12", "--no-loop-closing", "--sync"], capsys)
    assert rc == 0
    assert set(out) - {"ate_rmse_vs_groundtruth"} == SUMMARY_KEYS
    assert out["frames"] == 12 and out["loops_closed"] == 0
    assert out["final_state"] == "OK"


def test_run_slam_warmup(tmp_path, capsys):
    """--warmup builds the host libraries, then runs System.warmup() on the
    settings' configuration (here at 320x240 with 512 features)."""
    from os1_tpu_torch.run_slam import main

    small = (SETTINGS.replace("Camera.width: 640", "Camera.width: 320")
             .replace("Camera.height: 480", "Camera.height: 240")
             .replace("ORBextractor.nFeatures: 1000", "ORBextractor.nFeatures: 512")
             .replace("ORBextractor.nLevels: 8", "ORBextractor.nLevels: 4"))
    path = tmp_path / "small.yaml"
    path.write_text(small)
    assert main([str(path), "--warmup", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("warmup: 2 libraries ready")
    assert out[1].startswith("warmup: System.warmup() in ")
