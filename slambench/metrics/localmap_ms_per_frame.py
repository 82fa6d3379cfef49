"""Extractor and fused step: host ms a frame in the fused step's local-map
search (``trk.localmap``: the local points' gather, the frustum-gated
projection match and its pose solve), over the window's frames before the
profiled stretch opens (``harness.Window``). Nothing to read where the
program has no such stage."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Extractor and fused step", "ms/frame", "lower",
                                      "program_span", "frames_per_s")


def read(w):
    t, n = w.stages.get("trk.localmap", (0.0, 0))
    return t * 1e3 / w.timed_frames if n and w.timed_frames else None
