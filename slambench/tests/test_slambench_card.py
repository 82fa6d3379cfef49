"""The harness on the card at the small size: a traced run reads every
per-layer metric of its stretch and comes out correct. Skips without a card;
on the card: ``python -m pytest --noconftest -m cuda slambench/tests``."""
import time

import pytest

from slambench import cells, harness
from slambench.tests.small import CONFIG, LIMITS, mix


@pytest.mark.cuda
def test_traced_small_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    small = dict(mix(40), trace={"start": 2, "frames": 10})
    win, res, dev = harness.run_cell({"name": "small"}, CONFIG, small, 2**31 + 3, 8.0, True,
                                     "cuda", time.time(), log=lambda m: None, limits=LIMITS)
    assert res.values["feat_mismatch_pct"] == 0.0, res.values
    s = win.trace
    assert s is not None and s.frames == 10 and 0 < s.busy_s < s.window_s
    for stem in ("gated_match", "patch_gather", "sample_gather"):
        assert s.bounds[stem][1] > 0 and s.device_s[stem][1] >= s.bounds[stem][1], stem
        share = cells.load_metric(f"{stem}_roofline").read(win)
        assert 0.0 < share <= 105.0, (stem, share)
    assert dev["memory_peak_bytes"] > 0 and dev["platform"] == "gpu"
