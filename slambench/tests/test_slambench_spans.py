"""The readers of the fused step's spans and of the host reads' wait:
``motion_ms_per_frame``, ``localmap_ms_per_frame``, ``pose_opt_ms_per_frame``
and ``read_wait_ms_per_frame``, on hand-built windows; a program without
those spans gives them nothing to read, and the readers that were there read
as before beside them."""
import pytest

from slambench import cells, harness
from slambench.trace import flatten

NEW = {"motion_ms_per_frame": "trk.motion", "localmap_ms_per_frame": "trk.localmap",
       "pose_opt_ms_per_frame": "trk.pose_opt", "read_wait_ms_per_frame": "host.read"}
STAGES = {"trk.extract": (1.0, 40), "trk.track": (3.0, 40), "trk.motion": (0.8, 44),
          "trk.refkf": (0.1, 1), "trk.localmap": (1.2, 40), "trk.pose_opt": (1.6, 85),
          "host.read": (0.4, 104), "trk.create_kf": (0.1, 4), "lm.materialize": (0.2, 4),
          "lm.ba.dispatch": (0.3, 8), "lm.local_ba": (0.2, 4)}


def window(**kw):
    base = dict(seconds=10.0, frames=60, failed=0, setup_s=30.0, latencies=[0.1] * 40,
                stages=STAGES, reads=104, ba_iters=50, timed_frames=40)
    base.update(kw)
    return harness.Window(**base)


def read(name, w):
    return cells.load_metric(name).read(w)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reads_its_span_per_timed_frame(name):
    # 60 frames fed, 20 of them profiled: the spans cover the 40 others.
    assert read(name, window()) == pytest.approx(STAGES[NEW[name]][0] * 1e3 / 40)


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_to_read_without_the_span(name):
    # The parent program opens none of these spans.
    parent = {k: v for k, v in STAGES.items() if k not in NEW.values()}
    assert read(name, window(stages=parent)) is None
    assert read(name, window(timed_frames=0, latencies=[])) is None


def test_existing_readers_keep_their_meaning():
    w = window()
    assert read("track_stage_ms", w) == pytest.approx(4.0 * 1e3 / 40)
    assert read("lm_ms_per_keyframe", w) == pytest.approx(700.0 / 4)
    assert read("local_ba_iters_per_s", w) == pytest.approx(50 / 0.5)
    assert read("host_reads_per_frame", w) == pytest.approx(104 / 40)
    assert not any(n.startswith("lm.") for n in NEW.values())


def test_metrics_are_declared_for_every_cell():
    bench = cells.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert "workloads" not in m and m["moves"] == "frames_per_s"
        for cell in bench["workloads"]:
            assert name in {x["name"] for x in cells.metrics_of(bench, cell, trace=True)}


def test_idle_goes_to_the_innermost_sub_span():
    # trk.track > trk.motion > (trk.pose_opt, host.read), then trk.localmap
    # > trk.pose_opt, then the step's own tail.
    spans = [("trk.track", 0, 100), ("trk.motion", 10, 40), ("trk.pose_opt", 12, 30),
             ("host.read", 31, 39), ("trk.localmap", 50, 90), ("trk.pose_opt", 60, 85)]
    assert flatten(spans) == [
        (0, 10, "trk.track"), (10, 12, "trk.motion"), (12, 30, "trk.pose_opt"),
        (30, 31, "trk.motion"), (31, 39, "host.read"), (39, 40, "trk.motion"),
        (40, 50, "trk.track"), (50, 60, "trk.localmap"), (60, 85, "trk.pose_opt"),
        (85, 90, "trk.localmap"), (90, 100, "trk.track")]
