"""Local mapping: local-BA LM iterations (``LocalMapper.ba_iters``) over the
host seconds of the local-BA stages, bench.py's third metric."""
LAYER, UNIT, BETTER, SOURCE, MOVES = ("Local mapping", "iters/s", "higher", "program_span",
                                      "frames_per_s")


def read(w):
    s = sum(t for k, (t, _) in w.stages.items() if k.startswith("lm.ba.") or k == "lm.local_ba")
    return w.ba_iters / s if w.ba_iters and s > 0 else None
