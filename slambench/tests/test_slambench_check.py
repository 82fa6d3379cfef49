"""``correct`` at a small size on the CPU: a sound run of the program passes;
the control (the plain extractor one precision down, the state in
bfloat16) fails; and a run driven through the harness with the timed path
broken underneath comes out not correct, once for each fault these
one-card cells can have (the exchange between chips has no place in them)."""
import time

import numpy as np
import pytest
import torch

from slambench import check, control, harness, traffic
from slambench.tests.small import CONFIG, LIMITS, mix


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(seed=5):
    win, res, _ = harness.run_cell({"name": "small"}, CONFIG, mix(36), seed, 25.0, False, "cpu",
                                   time.time(), log=lambda m: None, limits=LIMITS)
    assert win.frames >= 30
    return res


@pytest.fixture
def broken_extractor(monkeypatch):
    """Plants ``fault`` (FrameFeatures -> FrameFeatures) in the extractor the
    tracker builds its frames with."""
    from os1_tpu_torch.pipeline import frame

    make = frame.make_extractor

    def plant(fault):
        def make_broken(cfg, device):
            ex = make(cfg, device)
            return lambda img: fault(ex(img))
        monkeypatch.setattr(frame, "make_extractor", make_broken)
        frame.make_frame_builder.cache_clear()

    yield plant
    frame.make_frame_builder.cache_clear()


def test_sound_run_is_correct():
    res = run()
    assert res.correct, res.values
    assert res.values["feat_mismatch_pct"] == 0.0


def test_streams_are_fed_in_turn_and_each_checked():
    """A mix of two streams: two systems, one frame of each in turn, and
    the sessions of both judged."""
    two = dict(mix(24), streams=2)
    win, res, _ = harness.run_cell({"name": "small"}, CONFIG, two, 5, 20.0, False, "cpu",
                                   time.time(), log=lambda m: None, limits=LIMITS)
    per_stream = [sum(s[0] == k for s in win.states) for k in (0, 1)]
    assert abs(per_stream[0] - per_stream[1]) <= 1
    # Each stream ended its first session, whose keyframes and poses were judged.
    assert all(max(s[1] for s in win.states if s[0] == k) >= 1 for k in (0, 1))
    assert res.values["feat_mismatch_pct"] == 0.0 and res.values["frame_ate_pct"] is not None


def test_control_is_not_correct():
    from slambench import cells

    seq = traffic.generate(mix(36), cells.camera(CONFIG), 6, "cpu")
    sys_ = cells.build_system(CONFIG, "cpu")
    sn, _ = control.session(sys_, seq)
    sound = check.Result(check.numbers([(sn, seq)], CONFIG, "cpu"), LIMITS)
    low = check.Result(check.numbers([(sn, seq)], CONFIG, "cpu", "bfloat16",
                                     state=control.bf16), LIMITS)
    assert sound.correct, sound.values
    assert not low.correct and low.values["feat_mismatch_pct"] > 10.0, low.values


def test_state_returned_unchanged_is_not_correct(monkeypatch):
    """The tracker's step hands back the pose it started the session with."""
    from os1_tpu_torch.pipeline.tracking import Tracker

    record = Tracker._record_trajectory
    first = {}

    def unchanged(self, timestamp, fid, Tcw):
        if timestamp == 0.0 or id(self) not in first:
            first[id(self)] = Tcw.copy()
        return record(self, timestamp, fid, first[id(self)])

    monkeypatch.setattr(Tracker, "_record_trajectory", unchanged)
    res = run()
    assert not res.correct and res.values["frame_ate_pct"] > LIMITS["frame_ate_pct"], res.values


def test_local_ba_returning_its_input_is_not_correct():
    """The mapper's local BA hands back the poses and points it was given:
    the keyframe poses keep tracking's drift."""
    with control.local_ba_skipped():
        res = run()
    assert not res.correct and res.values["kf_ate_pct"] > LIMITS["kf_ate_pct"], res.values


def test_half_the_batch_left_out_is_not_correct(broken_extractor):
    def half(f):
        valid = f.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return f._replace(valid=valid)

    broken_extractor(half)
    res = run()
    assert not res.correct and res.values["feat_mismatch_pct"] > 20.0, res.values


def test_answer_altered_is_not_correct(broken_extractor):
    broken_extractor(lambda f: f._replace(desc=f.desc ^ 1))
    res = run()
    assert not res.correct and res.values["feat_mismatch_pct"] > 50.0, res.values


def test_snapshot_faults_read_high():
    """The faults control.py reads on the card, applied to a sound session."""
    from slambench import cells

    seq = traffic.generate(mix(36), cells.camera(CONFIG), 7, "cpu")
    sn, _ = control.session(cells.build_system(CONFIG, "cpu"), seq)
    for fault, number in ((control.frozen, "frame_ate_pct"), (control.frozen, "kf_ate_pct"),
                          (control.half, "feat_mismatch_pct"),
                          (control.altered, "feat_mismatch_pct")):
        vals = check.numbers([(fault(sn), seq)], CONFIG, "cpu")
        assert vals[number] > LIMITS[number], (fault.__name__, vals)
    assert np.isfinite(check.numbers([(sn, seq)], CONFIG, "cpu")["map_reproj_px"])
