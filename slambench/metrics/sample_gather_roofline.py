"""Kernels: P2, the BRIEF-sample gather (``csrc/patches.cu``): the sum of its
launches' lower-bound times (``slambench/kernels.py``, from the shapes the
benchmark's wrapper recorded) over its device time in the traced stretch."""
LAYER, UNIT, BETTER, SOURCE, MOVES = "Kernels", "%", "higher", "device_trace", "frames_per_s"
STEM = "sample_gather"


def read(w):
    s = w.trace
    if s is None:
        return None
    bound, launches = s.bounds[STEM]
    device, events = s.device_s[STEM]
    return 100.0 * bound / device if launches and device > 0 else None
