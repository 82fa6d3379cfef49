"""End to end: process start to the first timed frame (imports, the kernel
libraries, rendering, the system, ``System.warmup()``, the pre-tracked
frames the traffic needs)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(w):
    return w.setup_s
