"""Settings loading: the reference's calibration YAML schema (webcam.yaml:
Camera.fx/fy/cx/cy/k1..k6/p1/p2/width/height/fps/RGB/modo,
ORBextractor.nFeatures/scaleFactor/nLevels/iniThFAST/minThFAST, Viewer.*),
read with OpenCV's FileStorage where OpenCV is installed, so the reference's
files in the %YAML:1.0 dialect drop in unchanged (Tracking::ChangeCalibration,
Tracking.cc:1177-1291), and line by line where it is not. Port of
os1_tpu/io/config.py.

The line reader takes keys with digits (Camera.k1, Camera.p2, ...); the JAX
package's reads letters and dots only, so without OpenCV it drops the
distortion coefficients.
"""
from __future__ import annotations

import re

from ..features.orb import OrbConfig
from ..geometry.camera import Camera
from ..map.store import MapConfig
from ..pipeline.config import SlamConfig

KEYS = (
    "Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy",
    "Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2",
    "Camera.k3", "Camera.k4", "Camera.k5", "Camera.k6",
    "Camera.width", "Camera.height", "Camera.fps", "Camera.RGB",
    "Camera.modo", "Camera.fisheye",
    "ORBextractor.nFeatures", "ORBextractor.scaleFactor",
    "ORBextractor.nLevels", "ORBextractor.iniThFAST",
    "ORBextractor.minThFAST",
    "Viewer.KeyFrameSize", "Viewer.GraphLineWidth", "Viewer.PointSize",
    "Viewer.CameraSize", "Viewer.CameraLineWidth", "Viewer.ViewpointX",
    "Viewer.ViewpointY", "Viewer.ViewpointZ", "Viewer.ViewpointF",
)
_LINE = re.compile(r"\s*([A-Za-z0-9_.]+)\s*:\s*([-+0-9.eE]+)")


def _read_yaml(path: str) -> dict:
    """Flat key -> float dict of an OpenCV-dialect YAML settings file."""
    out = {}
    try:
        import cv2
    except ImportError:
        with open(path) as f:
            for line in f:
                m = _LINE.match(line)
                if m and m.group(1) in KEYS:
                    out[m.group(1)] = float(m.group(2))
        return out
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    if not fs.isOpened():
        raise IOError(f"cannot open settings file {path}")
    for k in KEYS:
        node = fs.getNode(k)
        if not node.empty():
            out[k] = node.real()
    fs.release()
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_slam_config(path: str, width: int | None = None, height: int | None = None,
                     max_keyframes: int = 256, max_points: int = 16384) -> SlamConfig:
    """A SlamConfig from a reference-style settings file.

    ``width``/``height`` override the capture resolution; K scales when it
    differs from Camera.width, as the reference does (Tracking.cc:1193-1205).
    """
    y = _read_yaml(path)
    fx = y.get("Camera.fx", 500.0)
    fy = y.get("Camera.fy", fx)
    cx = y.get("Camera.cx", 320.0)
    cy = y.get("Camera.cy", 240.0)
    cfg_w = int(y.get("Camera.width", 640))
    cfg_h = int(y.get("Camera.height", int(round(cfg_w * 0.75))))
    w = width or cfg_w
    h = height or cfg_h
    if w != cfg_w:
        s = w / cfg_w
        fx, fy, cx, cy = fx * s, fy * s, cx * s, cy * s
    # Distortion in the fixed 8-slot layout (k1 k2 p1 p2 k3 k4 k5 k6), which
    # holds the reference's 4-, 5- and 8-coefficient vectors (Tracking.cc:1231-1242).
    dist = [y.get(f"Camera.{k}", 0.0) for k in ("k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6")]
    cam = Camera.make(fx=fx, fy=fy, cx=cx, cy=cy, dist=dist,
                      fisheye=bool(y.get("Camera.fisheye", 0.0)), width=w, height=h)
    n_feat = round_up(int(y.get("ORBextractor.nFeatures", 1000)), 128)
    orb = OrbConfig(height=h, width=w, n_features=n_feat,
                    n_levels=int(y.get("ORBextractor.nLevels", 8)),
                    scale_factor=float(y.get("ORBextractor.scaleFactor", 1.2)),
                    fast_hi=float(y.get("ORBextractor.iniThFAST", 20)),
                    fast_lo=float(y.get("ORBextractor.minThFAST", 7)))
    return SlamConfig(camera=cam, orb=orb,
                      map=MapConfig(max_keyframes=max_keyframes, max_points=max_points,
                                    n_features=n_feat))


def config_fps(path: str) -> float:
    return float(_read_yaml(path).get("Camera.fps", 30.0))


def config_rgb(path: str) -> bool:
    return bool(_read_yaml(path).get("Camera.RGB", 0.0))
