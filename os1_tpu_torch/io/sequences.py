"""bench.py's configuration and sequences for the port: the system the bench
and the accuracy rig run (640x480, 1024 features, 8 levels,
``MapConfig(128, 16384)``, the fx=fy=400 pinhole camera, loop closing on)
and its three rendered sequences with their ground truth. Port of
bench.py:30-113 and the path length of accuracy.py:129-135.

The sequences are rendered in memory by the port's numpy renderer
(``io/synthetic``), which keeps no cache.
"""
from __future__ import annotations

import os

import numpy as np

N_FRAMES = 300  # bench.py:26
FPS = 30.0  # the frame rate the sequences are time-stamped at (bench.py:27)
H, W = 480, 640
K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
SEQUENCES = ("orbit", "loop", "photo")


def bench_config(**th_overrides):
    """bench.py's SlamConfig (bench.py:51-59); ``th_overrides`` patch
    TrackingThresholds fields."""
    from ..features.orb import OrbConfig
    from ..geometry.camera import Camera
    from ..map.store import MapConfig
    from ..pipeline import SlamConfig
    from ..pipeline.config import TrackingThresholds

    cam = Camera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(height=H, width=W, n_features=1024, n_levels=8),
        map=MapConfig(max_keyframes=128, max_points=16384, n_features=1024),
        th=TrackingThresholds(**th_overrides),
    )


def mode_flags(sync: bool = False, threaded: bool = False) -> dict:
    """System's mode arguments as bench.py maps them (bench.py:60-65): the
    default is the shipped mode (pipelined tracking, cooperative mapping);
    ``sync`` inline mapping without pipelining; ``threaded`` the worker
    threads."""
    return dict(pipelined=not sync, async_mapping=threaded,
                coop_mapping=not sync and not threaded)


def build_system(sync: bool = False, threaded: bool = False, device=None, **th_overrides):
    """The benchmark system on ``device`` (None: the card), loop closing on."""
    from ..pipeline import System

    return System(bench_config(**th_overrides), device=device, **mode_flags(sync, threaded))


def scene_and_poses(kind: str, n_frames: int = N_FRAMES):
    """(scene, ground-truth Tcw list) of bench.py's sequences: the orbit
    (``default_scene(seed=1)``, ``orbit_trajectory(n, advance=0.05)``), the
    loop circuit in the room (``room_scene(seed=3)``, ``loop_trajectory(n)``)
    and in the photo room (``photo_room_scene()``; scene None without the
    packaged photographs)."""
    from . import realimg, synthetic

    if kind == "orbit":
        return synthetic.default_scene(seed=1), synthetic.orbit_trajectory(n_frames, advance=0.05)
    if kind == "loop":
        return synthetic.room_scene(seed=3), synthetic.loop_trajectory(n_frames)
    if kind == "photo":
        scene = realimg.photo_room_scene() if os.path.exists(realimg.PHOTOS) else None
        return scene, synthetic.loop_trajectory(n_frames)
    raise ValueError(f"unknown sequence {kind!r}; one of {SEQUENCES}")


def frames(kind: str, n_frames: int = N_FRAMES):
    """(frames [n, 480, 640] uint8, poses) of a sequence, or (None, None)
    for the photo room without its photographs."""
    from . import synthetic

    scene, poses = scene_and_poses(kind, n_frames)
    if scene is None:
        return None, None
    return synthetic.render_sequence(scene, poses, K, H, W), poses


def orbit_frames(n_frames: int = N_FRAMES):
    return frames("orbit", n_frames)


def loop_frames(n_frames: int = N_FRAMES):
    return frames("loop", n_frames)


def photo_frames(n_frames: int = N_FRAMES):
    return frames("photo", n_frames)


def path_length(poses) -> float:
    """Length of the ground-truth camera path: the sum of the distances
    between consecutive camera centres."""
    centres = [-T[:3, :3].T @ T[:3, 3] for T in poses]
    return sum(float(np.linalg.norm(centres[i + 1] - centres[i]))
               for i in range(len(centres) - 1))
