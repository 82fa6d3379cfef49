"""End to end: every frame fed in the window over the window's wall time,
session resets and the flush of the last frame in flight included."""
UNIT, BETTER, SOURCE = "frames/s", "higher", "host_clock"


def read(w):
    return w.frames / w.seconds if w.frames and w.seconds > 0 else None
