"""Local mapping: host ms of the ``lm.*`` stages over the window, a keyframe
the tracker inserted in it (``trk.create_kf``)."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Local mapping", "ms/kf", "lower", "program_span",
                                      "frames_per_s")


def read(w):
    kfs = w.stages.get("trk.create_kf", (0.0, 0))[1]
    lm = sum(t for k, (t, _) in w.stages.items() if k.startswith("lm."))
    return lm * 1e3 / kfs if kfs else None
