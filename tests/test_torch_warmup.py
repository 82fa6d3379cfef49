"""``System.warmup()`` and ``LocalMapper.warmup()`` of the port, on the CPU
at 240x320, 512 features, 4 levels, MapConfig(64, 8192, 512), in the shipped
mode with loop closing on (``System(cfg, pipelined=True,
coop_mapping=True)``):

- the state after ``warmup()`` equals a fresh system's: the store, every
  mirror tensor and its pending rows, the database, the tracker, the
  samplers' generators, the host-read count, the mapper's ``ba_iters`` and
  the kernel launch counters (the launches inside are reported apart, in
  ``warmup_launches``); it returns its seconds;
- the first 30 frames of the JAX package's pipeline test sequence
  (orbit_trajectory(40, advance=0.08) of default_scene(seed=3)) tracked after
  ``warmup()`` are bit-identical (states and SHA-256 of the poses) to the
  same frames on a system without it.
"""
import hashlib

import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import synthetic
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda
from os1_tpu_torch.ops.patches import extract_patches_cuda, sample_patches_cuda
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 30


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system():
    cfg = SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H,
                                        device="cpu"),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    return System(cfg, pipelined=True, coop_mapping=True, device="cpu")


@pytest.fixture(scope="module")
def warmed():
    s = _system()
    seconds = s.warmup()
    return s, seconds


def _state(s):
    """Everything a run reads that warmup() could have changed."""
    st, mir, tr = s.store, s.mirror, s.tracker
    out = {f"store.{k}": v for k, v in vars(st).items() if k != "cfg"}
    out.update({f"mirror.{k}": v for k, v in vars(mir).items()
                if isinstance(v, torch.Tensor)})
    out.update({"mirror.pending": sorted(mir._pending_rows), "mirror.shadow": mir._shadow,
                "mirror.pt_gen": mir.pt_gen,
                "db.active": s.db.active, "db.inverted": s.db.inverted,
                "db.bows": [b is None for b in s.db.bows],
                "tracker": (tr.state, tr.last, tr.init_ref, tr.velocity, tr.ref_kf, tr.frame_id,
                            tr.trajectory, tr._pending, tr._chain, tr._dropped, tr._prev_Tcw,
                            tr.stale_binds, tr._init_match_dev),
                "reads": s.reads.count, "ba_iters": s.mapper.ba_iters,
                "timer": dict(s.timer.totals),
                "samplers": [x.sampler.generator.get_state() for x in
                             (tr, s.relocalizer, s.loop_closer)],
                "launches": [(f.launches, f.launches_by_thread) for f in
                             (gated_match_cuda, extract_patches_cuda, sample_patches_cuda)]})
    return out


def _equal(a, b) -> bool:
    if isinstance(a, (torch.Tensor, np.ndarray)):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_warmup_leaves_a_fresh_systems_state(warmed):
    s, seconds = warmed
    assert seconds > 0
    assert set(s.warmup_launches) >= {"gated_match_cuda", "extract_patches_cuda",
                                      "sample_patches_cuda"}
    assert not any(s.warmup_launches.values())  # no kernel on the CPU
    fresh = _state(_system())
    got = _state(s)
    assert got.keys() == fresh.keys()
    differ = [k for k in fresh if not _equal(got[k], fresh[k])]
    assert not differ, differ
    assert s.tracker.state == TrackingState.NO_IMAGES_YET
    assert s.store.n_keyframes() == 0 and s.store.n_points() == 0 and not s.db.active.any()


def _run(s, frames):
    states = [s.track_monocular(f, timestamp=i / 30.0)[0].name for i, f in enumerate(frames)]
    s.flush()
    poses = np.stack([T for *_, T in s.frame_trajectory()])
    return states, hashlib.sha256(np.ascontiguousarray(poses).tobytes()).hexdigest()


def test_run_after_warmup_is_bit_identical(warmed):
    poses = synthetic.orbit_trajectory(40, advance=0.08)[:N_FRAMES]
    frames = synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)
    s, _ = warmed
    states, sha = _run(s, frames)
    ref_states, ref_sha = _run(_system(), frames)
    assert states.count("OK") > N_FRAMES // 2
    assert states == ref_states and sha == ref_sha
    assert s.mapper.ba_iters > 0
