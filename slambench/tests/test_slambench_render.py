"""The benchmark's PyTorch renderer against its frozen numpy copy, and the
generator's trajectories against the program's formulas, at a small size."""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from slambench import render, traffic
from slambench.reference import render_np

LENSES = {
    "pinhole": dict(fx=60.0, fy=58.0, cx=40.5, cy=29.0),
    "tum1": dict(fx=80.8, fy=80.7, cx=39.8, cy=31.9, k1=0.262383, k2=-0.953104,
                 p1=-0.005358, p2=0.002628, k3=1.163314),
}


# bench.py's loop circuit, written as a mix: 1.15 turns looking outward
# inside a textured room.
TURNS = 2.0 * np.pi * 1.15
CIRCUIT = {
    "frames": 300, "pretrack": 120, "background": 10.0,
    "planes": [{"origin": o, "u": u, "v": [0.0, 5.0, 0.0], "texture": {"size": 512, "cells": c}}
               for o, u, c in (([-6.0, -2.5, 6.0], [12.0, 0.0, 0.0], 44),
                               ([6.0, -2.5, -6.0], [-12.0, 0.0, 0.0], 50),
                               ([6.0, -2.5, 6.0], [0.0, 0.0, -12.0], 56),
                               ([-6.0, -2.5, -6.0], [0.0, 0.0, 12.0], 62))],
    "trajectory": {"x": {"waves": [[1.5, TURNS, 0.0]]},
                   "y": {"waves": [[0.05, 3.0 * TURNS, 0.0]]},
                   "z": {"waves": [[1.5, TURNS, np.pi / 2]]},
                   "yaw": {"rate": TURNS}},
}


def test_resize_matches_numpy():
    base = torch.rand((12, 12), generator=torch.Generator().manual_seed(3))
    got = render.resize_cubic(base, 64, 64).numpy()
    want = render_np.resize_cubic(base.numpy(), 64, 64)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("lens", sorted(LENSES))
@pytest.mark.parametrize("mix", ["orbit", "circuit"])
def test_render_matches_numpy(lens, mix):
    m = traffic.load("orbit") if mix == "orbit" else CIRCUIT
    planes = traffic.planes(m, seed=2**31 + 5, device="cpu")
    poses = traffic.trajectory(m["trajectory"], m["frames"])[::60]
    cam = LENSES[lens]
    rays = render.undistort_grid(cam, 60, 80, "cpu")
    got = render.render(planes, torch.as_tensor(poses), rays, 60, 80).numpy()
    np_planes = [tuple(x.numpy() for x in p) for p in planes]
    want = np.stack([render_np.render(np_planes, T, cam, 60, 80) for T in poses])
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert (want != 10.0).mean() > 0.3  # the planes fill much of the view


def test_textures_follow_the_seed():
    m = traffic.load("orbit")
    a = traffic.planes(m, 7, "cpu")
    b = traffic.planes(m, 7, "cpu")
    c = traffic.planes(m, 8, "cpu")
    assert all(torch.equal(x[3], y[3]) for x, y in zip(a, b))
    assert not torch.equal(a[0][3], c[0][3])


def _orbit(n, advance):
    out = []
    for i in range(n):
        s = i / max(n - 1, 1)
        pos = np.array([advance * i, 0.04 * np.sin(2 * np.pi * s), 0.15 * np.sin(np.pi * s)])
        Rwc = Rotation.from_euler("yxz", [-0.15 * s, 0.02 * np.sin(4 * s), 0.0]).as_matrix()
        T = np.eye(4)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ pos
        out.append(T)
    return np.stack(out)


def _circle(n):
    out = []
    for i in range(n):
        th = 2.0 * np.pi * 1.15 * i / max(n - 1, 1)
        fwd = np.array([np.sin(th), 0.0, np.cos(th)])
        right = np.array([np.cos(th), 0.0, -np.sin(th)])
        Rwc = np.stack([right, np.array([0.0, 1.0, 0.0]), fwd], axis=1)
        pos = 1.5 * fwd + np.array([0.0, 0.05 * np.sin(3 * th), 0.0])
        T = np.eye(4)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ pos
        out.append(T)
    return np.stack(out)


def test_trajectories_are_bench_py_s():
    """io/synthetic.py's orbit_trajectory(300, advance=0.05) and
    loop_trajectory(300), written out here."""
    np.testing.assert_allclose(traffic.trajectory(traffic.load("orbit")["trajectory"], 300),
                               _orbit(300, 0.05), atol=1e-6)
    np.testing.assert_allclose(traffic.trajectory(CIRCUIT["trajectory"], 300), _circle(300),
                               atol=1e-6)


def test_generate_gives_uint8_frames_and_poses():
    m = dict(CIRCUIT, frames=4)
    cam = dict(LENSES["tum1"], width=80, height=60, fps=30.0)
    seq = traffic.generate(m, cam, seed=11, device="cpu")
    assert seq.frames.shape == (4, 60, 80) and seq.frames.dtype == np.uint8
    assert seq.poses.shape == (4, 4, 4) and seq.pretrack == m["pretrack"]


def test_orbit_is_bit_identical_to_the_formula():
    """The orbit's poses as the mix's channel sums give them equal, bit for
    bit, bench.py's formula evaluated in the same order."""
    def rx(a):
        return np.array([[1.0, 0.0, 0.0], [0.0, np.cos(a), -np.sin(a)], [0.0, np.sin(a), np.cos(a)]])

    def ry(a):
        return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])

    want = []
    for i in range(300):
        s = i / 299
        pos = np.array([0.05 * i, 0.04 * np.sin(2 * np.pi * s), 0.15 * np.sin(np.pi * s)])
        Rwc = rx(0.02 * np.sin(4 * s)) @ ry(-0.15 * s)
        T = np.eye(4)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ pos
        want.append(T.astype(np.float32))
    assert np.array_equal(traffic.trajectory(traffic.load("orbit")["trajectory"], 300),
                          np.stack(want))


def test_blank_frames_streams_and_the_session_cap():
    cam = dict(LENSES["tum1"], width=80, height=60, fps=30.0)
    m = dict(traffic.load("orbit"), frames=6, blank=[[2, 4]])
    a = traffic.generate(m, cam, seed=11, device="cpu")
    assert (a.frames[2:4] == 0).all() and (a.frames[[0, 1, 4, 5]] > 0).any(axis=(1, 2)).all()
    b = traffic.generate(m, cam, seed=11, device="cpu", stream=1)
    assert np.array_equal(a.poses, b.poses) and not np.array_equal(a.frames[0], b.frames[0])
    assert traffic.for_config(m, {"Sequence.frames": 4})["frames"] == 4
    assert traffic.for_config(m, {})["frames"] == 6
    with pytest.raises(ValueError):
        traffic.trajectory({"kind": "orbit"}, 3)
