"""The stage spans inside the port's fused tracking step and the timed host
reads, on the CPU at 240x320, 512 features, 4 levels, MapConfig(64, 8192,
512), in the shipped mode (``System(cfg, pipelined=True,
coop_mapping=True)``), over the first frames of the JAX package's pipeline
test sequence (orbit_trajectory(40, advance=0.08) of default_scene(seed=3)):

- ``System.set_timer`` reaches the fused step and the one ``HostReads`` the
  tracker, mapper, relocalizer and loop closer share;
- the fused step opens ``trk.motion``, ``trk.localmap`` and ``trk.pose_opt``
  inside ``trk.track``, each inside its parent's interval; a failed motion
  search opens a second ``trk.motion`` and the fallback ``trk.refkf``;
- every host read is one ``host.read`` span;
- relocalization's pose solves open no ``trk.pose_opt``;
- ``System.warmup()`` leaves no span in the system's timer;
- no new span name starts with ``lm.`` (the mapper's metrics sum ``lm.*``).
"""
import contextlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import synthetic
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState
from os1_tpu_torch.pipeline import local_mapping, relocalization, system
from os1_tpu_torch.pipeline import tracking_kernels as tk
from os1_tpu_torch.pipeline.tracking_fused import unpack_result
from os1_tpu_torch.utils import transfer
from os1_tpu_torch.utils.profiling import HostReads, StageTimer

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 24
NEW = ("trk.motion", "trk.refkf", "trk.localmap", "trk.pose_opt", "host.read")
PARENTS = {"trk.motion": ("trk.track",), "trk.refkf": ("trk.track",),
           "trk.localmap": ("trk.track",),
           "trk.pose_opt": ("trk.motion", "trk.refkf", "trk.localmap")}


class RecordingTimer(StageTimer):
    """The program's stage timer, keeping each span's host interval."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter_ns()
        with super().__call__(name):
            yield
        with self._lock:
            self.spans.append((name, t0, time.perf_counter_ns()))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    return SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H,
                                         device="cpu"),
                      orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(40, advance=0.08)[:N_FRAMES]
    return synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)


@pytest.fixture(scope="module")
def tracked(frames):
    """A shipped system that tracked the frames under a recording timer:
    (system, timer, its states, the host reads made)."""
    s = System(_config(), pipelined=True, coop_mapping=True, device="cpu")
    timer = RecordingTimer()
    s.set_timer(timer)
    reads0 = s.reads.count
    states = [s.track_monocular(f, timestamp=i / 30.0)[0] for i, f in enumerate(frames)]
    s.flush()
    return s, timer, states, s.reads.count - reads0


def _inside(child, parents) -> bool:
    _, c0, c1 = child
    return any(p0 <= c0 and c1 <= p1 for _, p0, p1 in parents)


def _check_nesting(spans):
    for name, parents in PARENTS.items():
        outer = [sp for sp in spans if sp[0] in parents]
        for sp in spans:
            if sp[0] == name:
                assert _inside(sp, outer), (name, parents)


def test_set_timer_reaches_the_step_and_the_shared_reads(tracked):
    s, timer, _, _ = tracked
    assert s.tracker._fused.timer is timer and s.reads.timer is timer
    assert s.tracker.timer is s.mapper.timer is s.loop_closer.timer is timer
    assert s.mapper.reads is s.relocalizer.reads is s.loop_closer.reads is s.reads
    other = StageTimer()
    s.set_timer(other)
    assert s.tracker._fused.timer is other and s.reads.timer is other
    s.set_timer(timer)


def test_fused_step_opens_its_stages_inside_trk_track(tracked):
    s, timer, states, _ = tracked
    assert states.count(TrackingState.OK) >= N_FRAMES // 2
    c = timer.counts
    assert c["trk.track"] > 0
    assert c["trk.localmap"] == c["trk.track"]
    assert c["trk.motion"] >= c["trk.track"]
    # One solve a motion attempt, one a fallback, one a local-map search.
    assert c["trk.pose_opt"] == c["trk.motion"] + c.get("trk.refkf", 0) + c["trk.localmap"]
    _check_nesting(timer.spans)
    # The motion attempt holds its inlier read.
    reads = [sp for sp in timer.spans if sp[0] == "host.read"]
    for sp in timer.spans:
        if sp[0] == "trk.motion":
            assert any(sp[1] <= r0 and r1 <= sp[2] for _, r0, r1 in reads)


def test_every_host_read_is_one_span(tracked):
    _, timer, _, n_reads = tracked
    assert n_reads > 0
    assert timer.counts["host.read"] == n_reads
    assert len([sp for sp in timer.spans if sp[0] == "host.read"]) == n_reads


def test_failed_motion_search_retries_then_falls_back(tracked):
    """A step whose chain binds no point: both motion attempts find no
    inlier, so the reference-keyframe fallback runs."""
    s, _, _, _ = tracked
    tr = s.tracker
    timer = RecordingTimer()
    s.set_timer(timer)
    try:
        N = s.cfg.orb.n_features
        T = torch.as_tensor(tr.last.Tcw.astype(np.float32))
        with timer("trk.track"):
            out, _ = tr._dispatch_fused(tr.last.data, T, T, torch.full((N,), -1),
                                        tr.last.data.feats.octave, False,
                                        tr._fused_snapshot(tr.last.bind))
    finally:
        s.set_timer(tracked[1])
    assert {k: timer.counts[k] for k in ("trk.motion", "trk.refkf", "trk.localmap",
                                         "trk.pose_opt", "host.read")} == {
        "trk.motion": 2, "trk.refkf": 1, "trk.localmap": 1, "trk.pose_opt": 4, "host.read": 2}
    host = unpack_result(out["packed"].numpy(), s.cfg.orb.n_features, s.cfg.th.max_local_points)
    assert not host["used_motion"]
    _check_nesting(timer.spans)


def test_relocalization_opens_no_pose_opt(tracked, frames, monkeypatch):
    s, _, _, _ = tracked
    solves = []

    def counted(fn):
        def run(*a, **kw):
            solves.append(fn.__module__)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(relocalization, "optimize_pose", counted(relocalization.optimize_pose))
    monkeypatch.setattr(tk, "optimize_pose", counted(tk.optimize_pose))
    timer = RecordingTimer()
    s.set_timer(timer)
    try:
        black = np.zeros((H, W), np.float32)
        for j in range(3):
            s.track_monocular(black, timestamp=(N_FRAMES + j) / 30.0)
        assert s.state == TrackingState.LOST
        for i, f in enumerate(frames[-4:]):
            state, _ = s.track_monocular(f, timestamp=(N_FRAMES + 3 + i) / 30.0)
            if state == TrackingState.OK:
                break
    finally:
        s.set_timer(tracked[1])
    relocs = [sp for sp in timer.spans if sp[0] == "trk.relocalize"]
    assert state == TrackingState.OK and relocs and solves, "no relocalization solve ran"
    assert timer.counts["trk.relocalize"] >= 1
    assert not any(_inside(sp, relocs) for sp in timer.spans if sp[0] == "trk.pose_opt")
    _check_nesting(timer.spans)


def test_warmup_leaves_no_span():
    s = System(_config(), pipelined=True, coop_mapping=True, device="cpu")
    timer = RecordingTimer()
    s.set_timer(timer)
    reads0 = s.reads.count
    s.warmup(include_loop=False)
    assert not timer.spans and not timer.counts and not s.timer.counts
    assert s.reads.count == reads0
    assert s.tracker._fused.timer is timer and s.reads.timer is timer


def test_host_reads_time_their_waits():
    timer = RecordingTimer()
    reads = HostReads(timer)
    t = torch.arange(4)
    assert reads.item(t[1]) == 1
    assert reads.numpy(t).tolist() == [0, 1, 2, 3]
    assert [a.tolist() for a in reads.numpy_all((t, t[:2]))] == [[0, 1, 2, 3], [0, 1]]
    assert transfer.fetch(transfer.announce(t), reads).tolist() == [0, 1, 2, 3]
    reads.tick()
    assert reads.count == timer.counts["host.read"] == 5
    assert [sp[0] for sp in timer.spans] == ["host.read"] * 5
    reads.timer = None
    reads.tick()
    assert reads.count == 6 and timer.counts["host.read"] == 5


def test_counted_and_timed_under_threads():
    timer = StageTimer()
    reads = HostReads(timer)
    threads = [threading.Thread(target=lambda: [reads.tick() for _ in range(500)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert reads.count == timer.counts["host.read"] == 2000


def test_no_new_span_name_starts_with_lm(tracked):
    _, timer, _, _ = tracked
    assert not any(n.startswith("lm.") for n in NEW)
    # Every lm.* stage is one the mapper or the system opens.
    mapper_stages = set()
    for mod in (local_mapping, system):
        with open(mod.__file__) as f:
            mapper_stages |= set(re.findall(r'timer\("(lm\.[a-z_.]+)"\)', f.read()))
    assert {n for n in timer.counts if n.startswith("lm.")} <= mapper_stages
