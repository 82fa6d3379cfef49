"""Real-photograph scenes: rendered sequences with the statistics of real
images. Port of os1_tpu/io/realimg.py.

A known trajectory rendered over real photographs keeps exact ground truth
while the textures bring natural spectra, edges, corners and illumination
gradients, so the extractor, the matcher gates and the vocabulary see real
descriptor distributions rather than the band-limited synthetic textures of
``io/synthetic.py``. bench.py's third sequence, the photo room, runs
:func:`photo_room_scene` along the loop circuit.

The photographs are data in the package, ``data/photos.npz`` (attribution in
``data/PHOTOS.txt``): sklearn's ``china.jpg`` and ``flower.jpg`` as their
[427, 640, 3] uint8 RGB pixels, and matplotlib's ``grace_hopper.jpg`` as the
[600, 512] uint8 grey image OpenCV's ``IMREAD_GRAYSCALE`` decodes, the
arrays the JAX package reads from those packages.
"""
from __future__ import annotations

import os

import numpy as np

from .synthetic import TexturedPlane

PHOTOS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                      "photos.npz")
NAMES = ("china", "flower", "grace_hopper")


def _to_gray(img: np.ndarray) -> np.ndarray:
    """BT.601 luma in float64, then float32, as the reference converts."""
    if img.ndim == 3:
        img = img[..., :3] @ np.array([0.299, 0.587, 0.114])
    return img.astype(np.float32)


def load_photos() -> list[np.ndarray]:
    """The packaged photographs as float32 grey arrays, in the reference's
    order (china, flower, grace_hopper)."""
    with np.load(PHOTOS) as z:
        return [_to_gray(z[name]) for name in NAMES]


def _tile_to(tex: np.ndarray, h: int, w: int, flip: bool = False) -> np.ndarray:
    """Tile and crop a photo to [h, w], mirror-tiled so the seams stay
    continuous."""
    if flip:
        tex = tex[:, ::-1]
    th, tw = tex.shape
    ry = -(-h // th)
    rx = -(-w // tw)
    rows = []
    for i in range(ry):
        row = tex if i % 2 == 0 else tex[::-1]
        cells = [row if j % 2 == 0 else row[:, ::-1] for j in range(rx)]
        rows.append(np.concatenate(cells, axis=1))
    return np.concatenate(rows, axis=0)[:h, :w].copy()


def photo_room_scene(half_size: float = 6.0, half_h: float = 2.5) -> list[TexturedPlane]:
    """Four inward-facing walls textured with the photographs: the
    real-imagery counterpart of ``synthetic.room_scene`` for the loop
    circuit."""
    photos = load_photos()
    S, hh = half_size, half_h
    specs = [
        (np.array([-S, -hh, S]), np.array([2 * S, 0.0, 0.0])),  # z = +S
        (np.array([S, -hh, -S]), np.array([-2 * S, 0.0, 0.0])),  # z = -S
        (np.array([S, -hh, S]), np.array([0.0, 0.0, -2 * S])),  # x = +S
        (np.array([-S, -hh, -S]), np.array([0.0, 0.0, 2 * S])),  # x = -S
    ]
    return [TexturedPlane(origin=origin, u_axis=u, v_axis=np.array([0.0, 2 * hh, 0.0]),
                          texture=_tile_to(photos[i % len(photos)], 512, 1024,
                                           flip=i >= len(photos)))
            for i, (origin, u) in enumerate(specs)]


def photo_scene() -> list[TexturedPlane]:
    """Two photo planes at different depths and a photo floor (the layout of
    ``synthetic.default_scene`` with real textures), for forward and orbit
    sequences."""
    p = load_photos()
    return [
        TexturedPlane(origin=np.array([-4.0, -3.0, 8.0]), u_axis=np.array([8.0, 0.0, 0.0]),
                      v_axis=np.array([0.0, 6.0, 0.0]), texture=_tile_to(p[0], 512, 768)),
        TexturedPlane(origin=np.array([-5.0, -3.5, 12.0]), u_axis=np.array([10.0, 0.0, 0.0]),
                      v_axis=np.array([0.0, 7.0, 0.0]),
                      texture=_tile_to(p[1], 512, 768, flip=True)),
        TexturedPlane(origin=np.array([-5.0, 2.0, 4.0]), u_axis=np.array([10.0, 0.0, 0.0]),
                      v_axis=np.array([0.0, 0.5, 9.0]), texture=_tile_to(p[2], 512, 768)),
    ]
