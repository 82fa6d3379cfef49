"""Port parity of the real-photograph scenes (os1_tpu_torch.io.realimg)
against the JAX package's os1_tpu.io.realimg, which reads the photographs
from sklearn, matplotlib and OpenCV where the port reads its packaged
``data/photos.npz``.

Every comparison is exact (tolerance 0): the grey float32 photographs; the
mirror tiling; the textures and the geometry of ``photo_room_scene`` and
``photo_scene``; two frames of bench.py's photo room (the loop circuit at
640x480, bench K) rendered by both packages' renderers.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("sklearn")
pytest.importorskip("matplotlib")
pytest.importorskip("cv2")

from os1_tpu.io import realimg as jrealimg  # noqa: E402
from os1_tpu.io import synthetic as jsynthetic  # noqa: E402
from os1_tpu_torch.io import realimg, synthetic  # noqa: E402

BENCH_K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def jax_photos():
    return jrealimg.load_photos()


def test_packaged_pixels():
    """The file holds the source pixels: two RGB photographs and one grey."""
    with np.load(realimg.PHOTOS) as z:
        shapes = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert shapes == {"china": (np.uint8, (427, 640, 3)), "flower": (np.uint8, (427, 640, 3)),
                      "grace_hopper": (np.uint8, (600, 512))}


def test_load_photos_equal_jax(jax_photos):
    got = realimg.load_photos()
    assert len(got) == len(jax_photos) == 3
    for a, b in zip(got, jax_photos):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("h,w,flip", [(512, 1024, False), (512, 1024, True), (300, 200, False),
                                      (1000, 1400, True)])
def test_tile_to_equals_jax(jax_photos, h, w, flip):
    for p in jax_photos:
        assert np.array_equal(realimg._tile_to(p, h, w, flip), jrealimg._tile_to(p, h, w, flip))


@pytest.mark.parametrize("fn", ["photo_room_scene", "photo_scene"])
def test_scenes_equal_jax(fn):
    got, want = getattr(realimg, fn)(), getattr(jrealimg, fn)()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.texture.dtype == b.texture.dtype and np.array_equal(a.texture, b.texture)
        for k in ("origin", "u_axis", "v_axis"):
            assert np.array_equal(getattr(a, k), getattr(b, k))


def test_photo_room_frames_equal_jax():
    """Frames 0 and 150 of bench.py's photo room, rendered by each package
    from its own scene."""
    poses = synthetic.loop_trajectory(300)
    assert np.array_equal(poses, jsynthetic.loop_trajectory(300))
    scene, jscene = realimg.photo_room_scene(), jrealimg.photo_room_scene()
    for f in (0, 150):
        got = synthetic.render(scene, poses[f], BENCH_K, 480, 640)
        want = jsynthetic.render(jscene, poses[f], BENCH_K, 480, 640)
        assert got.dtype == want.dtype and np.array_equal(got, want)
