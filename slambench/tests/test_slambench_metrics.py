"""The metric arithmetic and bench.py's OK-stretch rule for ``failed``."""
import numpy as np
import pytest

from slambench import cells, harness, traffic
from slambench.trace import Stretch


def window(**kw):
    base = dict(seconds=10.0, frames=60, failed=0, setup_s=30.0,
                latencies=[0.1] * 60, stages={}, reads=180, ba_iters=50)
    base.update(kw)
    return harness.Window(**base)


def read(name, w):
    return cells.load_metric(name).read(w)


def test_rate_is_all_frames_over_all_time():
    # The window's time includes resets and the final flush: the rate is not
    # the mean of per-call rates (the calls here sum to 6 s of 10).
    w = window(seconds=10.0, frames=60, latencies=[0.1] * 60)
    assert read("frames_per_s", w) == pytest.approx(6.0)
    assert read("setup_s", w) == 30.0


def test_p95_is_over_all_calls():
    lat = [0.1] * 95 + [1.0] * 5
    w = window(frames=100, latencies=lat)
    assert read("frame_ms_p95", w) == pytest.approx(np.percentile(np.array(lat) * 1e3, 95))
    w = window(frames=100, latencies=[0.001 * i for i in range(100)])
    assert read("frame_ms_p95", w) == pytest.approx(94.05)


def test_stage_readers():
    stages = {"trk.extract": (1.0, 60), "trk.track": (2.0, 60), "trk.create_kf": (0.1, 4),
              "lm.materialize": (0.2, 4), "lm.ba.dispatch": (0.3, 8), "lm.local_ba": (0.2, 4)}
    w = window(stages=stages)
    assert read("track_stage_ms", w) == pytest.approx(50.0)
    assert read("lm_ms_per_keyframe", w) == pytest.approx(700.0 / 4)
    assert read("local_ba_iters_per_s", w) == pytest.approx(50 / 0.5)
    assert read("host_reads_per_frame", w) == pytest.approx(3.0)
    assert read("lm_ms_per_keyframe", window()) is None  # nothing to read


def test_per_frame_readers_leave_out_the_profiled_stretch():
    # 60 frames fed, 20 of them profiled: the host numbers cover the 40 others.
    w = window(frames=60, timed_frames=40, latencies=[0.1] * 40, reads=120,
               stages={"trk.extract": (1.0, 40), "trk.track": (3.0, 40)})
    assert read("host_reads_per_frame", w) == pytest.approx(3.0)
    assert read("track_stage_ms", w) == pytest.approx(100.0)
    assert read("frames_per_s", w) == pytest.approx(6.0)  # the rate counts every frame


def test_feeder_keeps_profiled_frames_out_of_the_latencies():
    seq = traffic.Sequence(frames=np.zeros((10, 2, 2), np.uint8), poses=np.zeros((10, 4, 4)),
                           fps=10.0, pretrack=0)
    states = ["NOT_INITIALIZED", "NOT_INITIALIZED", "OK", "OK", "OK", "OK"]
    drv = harness.Feeder(FakeSystem(states), seq, stream=1)
    drv.open_window()
    for k in range(6):
        drv.feed(profiled=2 <= k < 4)
    assert drv.fed == 6 and len(drv.latencies) == 4
    assert [w[2] for w in drv.where] == [0, 1, 4, 5]
    assert [s[3] for s in drv.states] == [False, False, True, True, True, True]
    assert all(s[0] == 1 for s in drv.states)


def test_trace_readers():
    s = Stretch(frames=30, window_s=2.0, busy_s=0.5, launches=3000, kernel_s={},
                bounds={"gated_match": (1e-4, 60), "patch_gather": (0.0, 0),
                        "sample_gather": (2e-5, 30)},
                device_s={"gated_match": (1e-3, 60), "patch_gather": (0.0, 0),
                          "sample_gather": (1e-4, 30)},
                idle_gaps=[], device_ops=[])
    w = window(trace=s)
    assert read("device_idle_pct", w) == pytest.approx(75.0)
    assert read("launches_per_frame", w) == pytest.approx(100.0)
    assert read("gated_match_roofline", w) == pytest.approx(10.0)
    assert read("sample_gather_roofline", w) == pytest.approx(20.0)
    assert read("patch_gather_roofline", w) is None  # no launch: no share, never 0
    assert read("device_idle_pct", window()) is None


class FakeSystem:
    """Reports scripted tracking states; counts flushes and resets."""

    def __init__(self, states):
        from os1_tpu_torch.pipeline.tracking import TrackingState

        self.states = [getattr(TrackingState, s) for s in states]
        self.calls = self.flushes = self.resets = 0
        self.tracker = type("T", (), {"frame_id": 0})()

    def track_monocular(self, img, ts):
        st = self.states[self.calls]
        self.calls += 1
        self.tracker.frame_id += 1
        return st, None

    def flush(self):
        self.flushes += 1

    def reset(self):
        self.resets += 1


def test_failed_follows_the_ok_stretch_rule(monkeypatch):
    monkeypatch.setattr(harness, "snapshot", lambda *a: None)
    # Two sessions of 5 frames: the bootstrap (NOT_INITIALIZED) is attempted
    # but not failed; a LOST frame after the first OK one is failed.
    states = ["NOT_INITIALIZED", "NOT_INITIALIZED", "OK", "LOST", "OK",
              "NOT_INITIALIZED", "OK", "OK", "LOST", "LOST", "NOT_INITIALIZED"]
    seq = traffic.Sequence(frames=np.zeros((5, 2, 2), np.uint8), poses=None, fps=30.0,
                           pretrack=0)
    sys_ = FakeSystem(states)
    drv = harness.Feeder(sys_, seq)
    drv.open_window()
    for _ in range(11):
        drv.feed()
    assert drv.fed == 11 and drv.failed == 3
    assert sys_.resets == 2 and sys_.flushes == 2 and len(drv.latencies) == 11


def test_pretracked_frames_are_not_counted(monkeypatch):
    monkeypatch.setattr(harness, "snapshot", lambda *a: None)
    seq = traffic.Sequence(frames=np.zeros((6, 2, 2), np.uint8), poses=None, fps=30.0,
                           pretrack=2)
    drv = harness.Feeder(FakeSystem(["NOT_INITIALIZED", "OK", "LOST", "OK", "OK", "OK"]), seq)
    drv.feed()
    drv.feed()
    drv.open_window()
    for _ in range(4):
        drv.feed()
    assert drv.fed == 4 and drv.failed == 1 and len(drv.latencies) == 4


def test_nested_stages_flatten_to_the_innermost():
    from slambench.trace import flatten

    spans = [("trk.track", 0, 10), ("trk.readback", 2, 4), ("trk.create_kf", 5, 6),
             ("lm.ba.dispatch", 12, 15), ("lm.ba.assemble", 13, 14)]
    assert flatten(spans) == [(0, 2, "trk.track"), (2, 4, "trk.readback"), (4, 5, "trk.track"),
                              (5, 6, "trk.create_kf"), (6, 10, "trk.track"),
                              (12, 13, "lm.ba.dispatch"), (13, 14, "lm.ba.assemble"),
                              (14, 15, "lm.ba.dispatch")]
    assert flatten([]) == []
