"""Extractor and fused step: host ms a frame in the ``trk.extract`` and
``trk.track`` stages of the program's stage timer, over the window's
frames before the profiled stretch opens (``harness.Window``)."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Extractor and fused step", "ms/frame", "lower",
                                      "program_span", "frames_per_s")


def read(w):
    s = sum(w.stages.get(k, (0.0, 0))[0] for k in ("trk.extract", "trk.track"))
    return s * 1e3 / w.timed_frames if w.timed_frames else None
