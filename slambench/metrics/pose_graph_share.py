"""Extractor and fused step: the share of the fused step's pose solves
(``trk.pose_opt``) that replayed a captured CUDA graph (``trk.pose_graph``,
one span a replay), in per cent, over the window's frames before the
profiled stretch opens (``harness.Window``). Nothing to read where the
program opens neither span."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Extractor and fused step", "%", "higher",
                                      "program_span", "frames_per_s")


def read(w):
    _, graphs = w.stages.get("trk.pose_graph", (0.0, 0))
    _, solves = w.stages.get("trk.pose_opt", (0.0, 0))
    return 100.0 * graphs / solves if graphs and solves else None
