"""Device: kernel launches in the traced stretch, a frame fed in it."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Device", "launches/frame", "lower", "device_trace",
                                      "frames_per_s")


def read(w):
    s = w.trace
    return s.launches / s.frames if s is not None and s.frames else None
