"""Entry point: the 95th percentile of the host time of every
``track_monocular`` call in the window before the profiled stretch
opens (``harness.Window``)."""
import numpy as np

LAYER, UNIT, BETTER, SOURCE, MOVES = "Entry point", "ms", "lower", "host_clock", "frames_per_s"


def read(w):
    return float(np.percentile(np.asarray(w.latencies) * 1e3, 95)) if w.latencies else None
