"""Tracker FSM: host ms a frame spent waiting in the program's host reads
(``host.read``, one span a read that ``System.reads`` counts), over the
window's frames before the profiled stretch opens (``harness.Window``): the
wait beside ``host_reads_per_frame``'s count. Nothing to read where the
program has no such stage."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Tracker FSM", "ms/frame", "lower", "program_span",
                                      "frames_per_s")


def read(w):
    t, n = w.stages.get("host.read", (0.0, 0))
    return t * 1e3 / w.timed_frames if n and w.timed_frames else None
