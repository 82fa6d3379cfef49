"""The port's host helpers (``os1_tpu_torch/native.py`` over
``csrc/native.cpp``) against the JAX package's (``os1_tpu/native``):

- ``point_distinctive_desc`` gives the JAX package's native slot and its own
  numpy form's (``distinctive_plain``) exactly, on seeded descriptors with
  even and odd live counts, one live observation and none, and on
  descriptors with tied medians; ``MapStore.update_point_derived`` picks the
  same descriptors as the numpy form, through the C++ helper;
- ``rgb_to_gray`` equals the JAX package's native conversion bit for bit;
- the ring buffer passes ``tests/test_native.py``'s cases: lossless order
  across threads, realtime drops the oldest, a pop times out; a closed
  buffer refuses a push and drains;
- the library builds from the port's own source, and a failed build raises.
"""
import threading
import time

import numpy as np
import pytest

from os1_tpu_torch import native
from os1_tpu_torch.map.store import MapConfig, MapStore
from os1_tpu_torch.ops import cuda_build

M = 16


def _jax_native():
    from os1_tpu import native as jn

    if not jn.available():
        pytest.skip("the JAX package's native library could not be built")
    return jn


def _descriptors(seed, n):
    """[n, M, 8] descriptors and a live mask covering every live count from 0
    to M (even and odd), with near-duplicate descriptors so that medians
    differ by little and tie."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (n, 1, 8), dtype=np.uint64).astype(np.uint32)
    flips = rng.random((n, M, 256)) < rng.uniform(0.02, 0.5, (n, 1, 1))
    words = np.packbits(flips, axis=-1, bitorder="little").view(np.uint32)
    descs = base ^ words
    counts = np.arange(n) % (M + 1)  # 0 .. M live observations
    live = np.zeros((n, M), bool)
    for p, c in enumerate(counts):
        live[p, rng.permutation(M)[:c]] = True
    return descs, live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distinctive_desc_matches_jax_and_plain(seed):
    jn = _jax_native()
    descs, live = _descriptors(seed, 340)
    got = native.point_distinctive_desc(descs, live)
    np.testing.assert_array_equal(got, jn.point_distinctive_desc_native(descs, live))
    np.testing.assert_array_equal(got, native.distinctive_plain(descs, live))
    n_live = live.sum(1)
    assert (got[n_live == 0] == -1).all()
    one = n_live == 1
    np.testing.assert_array_equal(got[one], np.argmax(live[one], axis=1))
    assert live[np.arange(len(got))[n_live > 0], got[n_live > 0]].all()


def test_distinctive_desc_breaks_ties_to_the_first_slot():
    jn = _jax_native()
    d = np.zeros((2, M, 8), np.uint32)
    d[:, 1, 0] = 0b1  # every live descriptor at the same median distance
    d[:, 2, 0] = 0b10
    d[:, 3, 0] = 0b100
    live = np.zeros((2, M), bool)
    live[0, 1:4] = True  # three live: medians all 2
    live[1, 1:3] = True  # two live: medians all 1
    got = native.point_distinctive_desc(d, live)
    np.testing.assert_array_equal(got, [1, 1])
    np.testing.assert_array_equal(got, jn.point_distinctive_desc_native(d, live))
    np.testing.assert_array_equal(got, native.distinctive_plain(d, live))


def test_store_takes_the_helpers_descriptor():
    """update_point_derived through the C++ helper keeps the descriptor the
    numpy form picks."""
    cfg = MapConfig(max_keyframes=8, max_points=64, n_features=32)
    st = MapStore(cfg)
    rng = np.random.default_rng(4)
    for k in range(6):
        st.add_keyframe(np.eye(4, dtype=np.float32),
                        rng.uniform(0, 100, (32, 2)).astype(np.float32),
                        np.zeros(32, np.float32), np.zeros(32, np.int32),
                        rng.integers(0, 2**32, (32, 8), dtype=np.uint64).astype(np.uint32),
                        np.ones(32, bool), frame_id=k)
    ids = st.alloc_points(20)
    st.pt_xyz[ids] = rng.uniform(-1, 1, (20, 3)) + [0, 0, 5]
    for i, p in enumerate(ids):
        ks = rng.permutation(6)[: 1 + i % 6]
        st.add_observations(np.full(len(ks), p), ks, np.full(len(ks), i))
    st.update_point_derived(ids, 1.2, 8)
    descs = st.kf_desc[np.clip(st.pt_obs_kf[ids], 0, None), np.clip(st.pt_obs_feat[ids], 0, None)]
    live = st.pt_obs_kf[ids] >= 0
    want = descs[np.arange(len(ids)), native.distinctive_plain(descs, live)]
    np.testing.assert_array_equal(st.pt_desc[ids], want)


def test_rgb_to_gray_matches_jax():
    jn = _jax_native()
    rgb = np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    got = native.rgb_to_gray(rgb)
    assert got.dtype == np.float32 and got.shape == (48, 64)
    np.testing.assert_array_equal(got, jn.rgb_to_gray_native(rgb))
    expected = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    np.testing.assert_allclose(got, expected, atol=1e-3)


def test_ring_lossless_ordering():
    rb = native.NativeRingBuffer(4, (8, 8), realtime=False)
    frames = [np.full((8, 8), i, np.uint8) for i in range(20)]
    pushed = []

    def producer():
        for f in frames:
            pushed.append(rb.push(f, timeout_ms=2000))
        rb.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while (f := rb.pop(timeout_ms=2000)) is not None:
        got.append(int(f[0, 0]))
    t.join()
    assert all(pushed)
    assert got == list(range(20))  # lossless: every frame, in order


def test_ring_realtime_drops_oldest():
    rb = native.NativeRingBuffer(2, (4, 4), realtime=True)
    for i in range(10):
        assert rb.push(np.full((4, 4), i, np.uint8))
    assert len(rb) == 2
    assert int(rb.pop()[0, 0]) == 8  # the oldest surviving frame
    assert int(rb.pop()[0, 0]) == 9 and len(rb) == 0


def test_ring_pop_timeout():
    rb = native.NativeRingBuffer(2, (4, 4))
    t0 = time.time()
    assert rb.pop(timeout_ms=100) is None
    assert 0.05 < time.time() - t0 < 1.0


def test_ring_closed_refuses_push_and_drains():
    rb = native.NativeRingBuffer(2, (3,), dtype=np.float32)
    assert rb.push(np.arange(3, dtype=np.float32))
    rb.close()
    assert not rb.push(np.zeros(3, np.float32), timeout_ms=100)
    np.testing.assert_array_equal(rb.pop(timeout_ms=100), np.arange(3, dtype=np.float32))
    assert rb.pop(timeout_ms=100) is None
    with pytest.raises(ValueError):
        rb.push(np.zeros(4, np.float32))


def test_library_builds_from_the_port_and_a_failed_build_raises(monkeypatch, tmp_path):
    assert native.LIBRARY.source.endswith("os1_tpu_torch/csrc/native.cpp")
    assert native.LIBRARY.load() is not None
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    broken = cuda_build.KernelLibrary("native.cpp", native.LIBRARY.functions,
                                      compiler=lambda: "false", flags=cuda_build.GXX_FLAGS)
    with pytest.raises(RuntimeError, match="failed"):
        broken.load()
    missing = cuda_build.KernelLibrary("native.cpp", native.LIBRARY.functions,
                                       compiler=cuda_build._gxx, flags=cuda_build.GXX_FLAGS)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        missing.load()
