"""Dataset readers for the monocular SLAM benchmarks the reference targets
(TUM fr1/desk, EuRoC MH_01, KITTI odometry), plus image directories and video
files. Port of os1_tpu/io/datasets.py.

Each reader yields (timestamp: float, gray_image: float32 [H, W]). OpenCV is
imported only when an image or a video is read.
"""
from __future__ import annotations

import glob
import os


def _imread_gray(path: str):
    import cv2
    import numpy as np

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img.astype(np.float32)


def tum_sequence(root: str):
    """TUM RGB-D monocular: reads rgb.txt ('timestamp filename' lines)."""
    index = os.path.join(root, "rgb.txt")
    with open(index) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            yield float(ts), _imread_gray(os.path.join(root, rel))


def tum_groundtruth(root: str):
    """TUM groundtruth.txt -> [(t, tx, ty, tz, qx, qy, qz, qw)]."""
    out = []
    with open(os.path.join(root, "groundtruth.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            out.append(tuple(vals[:8]))
    return out


def euroc_sequence(root: str, cam: str = "cam0"):
    """EuRoC MAV: mav0/cam0/data.csv ('#timestamp [ns],filename')."""
    base = os.path.join(root, "mav0", cam)
    if not os.path.isdir(base):
        base = os.path.join(root, cam)  # already inside mav0
    index = os.path.join(base, "data.csv")
    with open(index) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, name = line.split(",")[:2]
            yield float(ts_ns) * 1e-9, _imread_gray(
                os.path.join(base, "data", name.strip())
            )


def kitti_sequence(root: str):
    """KITTI odometry grayscale: image_0/*.png + times.txt."""
    times_file = os.path.join(root, "times.txt")
    times = None
    if os.path.exists(times_file):
        times = [float(x) for x in open(times_file)]
    images = sorted(glob.glob(os.path.join(root, "image_0", "*.png")))
    for i, path in enumerate(images):
        ts = times[i] if times and i < len(times) else i / 10.0
        yield ts, _imread_gray(path)


def image_dir_sequence(root: str, fps: float = 30.0, pattern: str = "*"):
    """Generic sorted image directory."""
    exts = (".png", ".jpg", ".jpeg", ".pgm", ".bmp", ".tif")
    files = sorted(
        p for p in glob.glob(os.path.join(root, pattern))
        if p.lower().endswith(exts)
    )
    for i, path in enumerate(files):
        yield i / fps, _imread_gray(path)


def video_sequence(path: str):
    """Video file via OpenCV, yielding frame-timestamped grayscale images."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        yield i / fps, frame.astype("float32")
        i += 1
    cap.release()


def open_sequence(path: str):
    """Auto-detect the sequence type from the path layout."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "rgb.txt")):
            return tum_sequence(path)
        if os.path.exists(os.path.join(path, "mav0")) or os.path.exists(
            os.path.join(path, "cam0", "data.csv")
        ):
            return euroc_sequence(path)
        if os.path.isdir(os.path.join(path, "image_0")):
            return kitti_sequence(path)
        return image_dir_sequence(path)
    return video_sequence(path)
