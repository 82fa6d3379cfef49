"""The reader of ``pose_graph_share``: the fused step's graph replays
(``trk.pose_graph``) over its pose solves (``trk.pose_opt``), in per cent,
on hand-built windows; a program that opens no ``trk.pose_graph`` gives it
nothing to read."""
import pytest

from slambench import cells, harness

STAGES = {"trk.extract": (1.0, 40), "trk.track": (3.0, 40), "trk.motion": (0.8, 44),
          "trk.localmap": (1.2, 40), "trk.pose_opt": (0.1, 84), "trk.pose_graph": (0.05, 84),
          "host.read": (0.4, 104)}


def window(stages):
    return harness.Window(seconds=10.0, frames=60, failed=0, setup_s=30.0,
                          latencies=[0.1] * 40, stages=stages, reads=104, ba_iters=50,
                          timed_frames=40)


def read(w):
    return cells.load_metric("pose_graph_share").read(w)


@pytest.mark.parametrize("graphs,share", [(84, 100.0), (63, 75.0), (1, 100.0 / 84)])
def test_reads_replays_over_solves(graphs, share):
    assert read(window(dict(STAGES, **{"trk.pose_graph": (0.05, graphs)}))) == pytest.approx(share)


def test_nothing_to_read_without_the_span():
    # The parent program opens no trk.pose_graph; a run on the CPU neither.
    parent = {k: v for k, v in STAGES.items() if k != "trk.pose_graph"}
    assert read(window(parent)) is None
    assert read(window({k: v for k, v in parent.items() if k != "trk.pose_opt"})) is None


def test_declared_for_every_cell():
    bench = cells.load_benchmark()
    m = bench["per_layer"][-1]
    assert m["name"] == "pose_graph_share" and "workloads" not in m
    assert m["moves"] == "frames_per_s" and m["layer"] == "Extractor and fused step"
    for cell in bench["workloads"]:
        assert "pose_graph_share" in {x["name"] for x in cells.metrics_of(bench, cell, trace=True)}
