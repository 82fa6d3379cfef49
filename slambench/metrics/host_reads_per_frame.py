"""Tracker FSM: the program's host reads (``System.reads``, each one a wait
for the card) over the window's frames before the profiled stretch opens
(``harness.Window``), a frame."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Tracker FSM", "reads/frame", "lower", "program_counter",
                                      "frames_per_s")


def read(w):
    return w.reads / w.timed_frames if w.timed_frames else None
