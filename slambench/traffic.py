"""The one traffic generator. A traffic mix is a JSON file under
``slambench/traffic/`` of parameters only; this module reads every mix, and a
new mix is a new file. Its keys:

- ``planes``: the scene, textured planes (origin, u, v, texture size and
  cells); the textures are drawn from the run's seed, so the geometry, the
  trajectory and the work of every session are the same for every seed;
- ``trajectory``: the camera path (below) and its ``length``, which sets its
  pace: a session of fewer frames runs the first frames of it;
- ``frames``: the frames of a session, at most the configuration's
  ``Sequence.frames``; ``pretrack``: how many of the first session set-up
  tracks before the window opens; ``background``: the grey level no plane
  covers;
- ``blank`` (optional): [start, end) ranges of session frames delivered
  black, a camera covered for a while;
- ``streams`` (optional, default 1): camera streams served by one process,
  one system each, fed in turn; stream k draws its own textures;
- ``trace`` (optional): ``start`` and ``frames`` of the ``--trace 1`` run's
  profiled stretch, counted in frames fed in the window.

A trajectory gives each of the six channels ``x y z`` (the camera centre)
and ``yaw pitch roll`` (radians; camera-to-world rotation Rx(pitch) Ry(yaw)
Rz(roll)) as a sum of terms, each optional: ``per_frame * i + rate * s +
sum(a * sin(f * s + p) for a, f, p in waves)``, with ``i`` the frame and
``s = i / (length - 1)``. bench.py's orbit is x = 0.05 i, a sway and a lift
of one and a half waves, a slow yaw; its loop circuit is a circle looking
outward (x = r sin(th), z = r cos(th), yaw = th for th = 2 pi turns s).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import render

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    """The traffic mix ``slambench/traffic/<name>.json``."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _tcw(Rwc: np.ndarray, pos: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ pos
    return T.astype(np.float32)


CHANNELS = ("x", "y", "z", "yaw", "pitch", "roll")


def channel(spec: dict, i: int, s: float) -> float:
    """One channel's value at frame ``i`` (``s`` its share of the path)."""
    v = 0.0
    if "per_frame" in spec:
        v = v + spec["per_frame"] * i
    if "rate" in spec:
        v = v + spec["rate"] * s
    for a, f, p in spec.get("waves", []):
        v = v + a * np.sin(f * s + p)
    return v


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def trajectory(spec: dict, n: int) -> np.ndarray:
    """[n, 4, 4] float32 world-to-camera poses of a trajectory spec."""
    unknown = set(spec) - set(CHANNELS) - {"length"}
    if unknown:
        raise ValueError(f"unknown trajectory keys {sorted(unknown)}")
    out = []
    for i in range(n):
        s = i / max(n - 1, 1)
        x, y, z, yaw, pitch, roll = (channel(spec.get(c, {}), i, s) for c in CHANNELS)
        Rwc = _rot_x(pitch) @ _rot_y(yaw) @ _rot_z(roll)
        out.append(_tcw(Rwc, np.array([x, y, z])))
    return np.stack(out)


def planes(mix: dict, seed: int, device, stream: int = 0) -> list:
    """The scene's planes as render.render takes them, textures drawn from
    ``seed`` by a torch.Generator on ``device``, one draw a plane in order;
    stream k > 0 draws from a seed of its own."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + stream * 0x9E3779B97F4A7C15) % (1 << 63))
    out = []
    for p in mix["planes"]:
        tex = p["texture"]
        base = torch.rand((tex["cells"], tex["cells"]), generator=gen, device=device)
        f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=device)  # noqa: E731
        out.append((f64(p["origin"]), f64(p["u"]), f64(p["v"]),
                    render.smooth_texture(base, tex["size"])))
    return out


@dataclass
class Sequence:
    frames: np.ndarray  # [n, h, w] uint8, on the host: what a camera delivers
    poses: np.ndarray  # [n, 4, 4] float32 ground-truth Tcw
    fps: float
    pretrack: int  # frames of the first session tracked in set-up


def for_config(mix: dict, cfg: dict) -> dict:
    """The mix with its session cut to the configuration's
    ``Sequence.frames``, where the configuration states one."""
    cap = cfg.get("Sequence.frames")
    return mix if cap is None else dict(mix, frames=min(int(mix["frames"]), int(cap)))


def generate(mix: dict, cam: dict, seed: int, device, stream: int = 0) -> Sequence:
    """Render one session of ``mix`` through the camera ``cam`` (fx fy cx cy
    width height fps, optional k1 k2 p1 p2 k3) on ``device``, for the
    mix's stream ``stream``."""
    n = int(mix["frames"])
    poses = trajectory(mix["trajectory"], int(mix["trajectory"].get("length", n)))[:n]
    scene = planes(mix, seed, device, stream)
    Tcw = torch.as_tensor(poses, device=device)
    frames = render.render_sequence(scene, Tcw, cam, int(cam["height"]), int(cam["width"]),
                                    background=float(mix.get("background", 10.0)))
    for a, b in mix.get("blank", []):
        frames[a:b] = 0
    return Sequence(frames=frames.cpu().numpy(), poses=poses, fps=float(cam["fps"]),
                    pretrack=int(mix.get("pretrack", 0)))
