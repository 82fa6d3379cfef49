"""Device: the share of the traced stretch in which no operation ran on the
card (the union of the trace's kernel, copy and set intervals)."""
LAYER, UNIT, BETTER, SOURCE, MOVES = "Device", "%", "lower", "device_trace", "frames_per_s"


def read(w):
    s = w.trace
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s is not None and s.window_s > 0 else None
