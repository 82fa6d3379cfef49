"""The comparison that decides ``correct``: what the window produced, held
against the plain reference under ``slambench/reference/`` and the
rendered ground truth.

Each session the window ran is judged once it was flushed (the tracked
frames' poses, the live keyframes and the map; ``harness.Snapshot``). Four
numbers are compared, each with its limit from ``slambench/limits/<cell>.json``:

- ``feat_mismatch_pct``: of the live keyframes' feature lanes, the share in
  % where the program's keypoint (undistorted position, octave, angle),
  descriptor or validity differs from the plain extractor's on the same
  image (``reference/orb.py``);
- ``map_reproj_px``: the median over the map's observations in those
  keyframes of the distance in pixels between the map point projected with
  the keyframe's pose and the plain extractor's keypoint, in units of the
  keypoint's octave scale (local mapping's and the loop correction's output);
- ``frame_ate_pct``: the tracked frames' camera centres aligned to the
  ground truth by a similarity (Umeyama), their RMS error in % of the ground
  truth's path over those frames, the worst session's (the tracker's poses);
- ``kf_ate_pct``: the same over the live keyframes (local BA's and the loop
  correction's keyframe poses).

A session that tracked fewer than half of the mix's frames, such as the
stretch the window's end cuts off, carries no pose number (an alignment over
a short stretch says little); its keyframes are still checked.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from . import cells
from .reference import geometry, orb

HERE = os.path.dirname(os.path.abspath(__file__))
MIN_SHARE = 0.5  # of a session's frames tracked, for its pose numbers
XY_TOL_PX = 0.01  # float32 against float64 undistortion: about 1e-4 px
ANGLE_TOL = 1e-3  # rad
NUMBERS = ("feat_mismatch_pct", "map_reproj_px", "frame_ate_pct", "kf_ate_pct")


def load_limits(cell: str) -> dict:
    """The limits of a cell's numbers (``slambench/limits/<cell>.json``, which
    also keeps the readings each was set from)."""
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


@dataclass
class Result:
    values: dict  # number -> value (None: nothing to compare)
    limits: dict  # number -> limit

    @property
    def correct(self) -> bool:
        """Every number read, and none above its limit."""
        vals = [self.values.get(k) for k in NUMBERS]
        return all(v is not None and np.isfinite(v) and v <= self.limits[k]
                   for k, v in zip(NUMBERS, vals))

    def report(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]} for k in NUMBERS}

    def lines(self) -> list:
        return [f"[check] {k} {self.values.get(k)} limit {self.limits[k]}" for k in NUMBERS]


def numbers(sessions, cfg: dict, device, precision: str = "float32", state=None) -> dict:
    """The four numbers of a run's ``sessions``, (harness.Snapshot,
    traffic.Sequence) pairs. ``precision`` picks the plain extractor's
    (``"bfloat16"`` is the control); ``state`` maps the program's poses and
    points before they are judged (the control's rounding, a planted fault)."""
    state = state or (lambda a: a)
    cam, o = cells.camera(cfg), cells.orb(cfg)
    ex = orb.extractor(o["h"], o["w"], o["n_features"], o["n_levels"], o["scale"],
                       o["fast_hi"], o["fast_lo"], str(device), precision)
    scale = np.asarray([o["scale"] ** l for l in range(o["n_levels"])])
    lanes = bad = 0
    errs, frame_ate, kf_ate = [], [], []
    for sn, seq in sessions:
        kf_T, pt_xyz = state(sn.kf_T), state(sn.pt_xyz)
        for k in range(len(sn.kf_frame)):
            ref = ex(seq.frames[sn.kf_frame[k]])
            xy_un = orb.undistort_pixels(ref["xy"], cam)
            differs = ((ref["valid"] != sn.kf_valid[k]) | (ref["octave"] != sn.kf_octave[k])
                       | (ref["desc"] != sn.kf_desc[k]).any(1)
                       | (np.abs(xy_un - sn.kf_xy[k]).max(1) > XY_TOL_PX)
                       | (np.abs(ref["angle"] - sn.kf_angle[k]) > ANGLE_TOL))
            seen = ref["valid"] | sn.kf_valid[k]
            lanes += int(seen.sum())
            bad += int((differs & seen).sum())
            obs = sn.kf_obs[k]
            ok = (obs >= 0) & ref["valid"]
            ok[ok] &= sn.pt_valid[obs[ok]]
            uv = geometry.project(kf_T[k], pt_xyz[obs[ok]], cam)
            errs.append(np.linalg.norm(uv - xy_un[ok], axis=1) / scale[ref["octave"][ok]])
        ids = sorted(sn.frame_T)
        if len(ids) >= MIN_SHARE * len(seq.frames):
            frame_ate.append(geometry.ate_pct(state(np.stack([sn.frame_T[i] for i in ids])),
                                              seq.poses[ids]))
            order = np.argsort(sn.kf_frame)
            if len(order) >= 3:
                kf_ate.append(geometry.ate_pct(kf_T[order], seq.poses[sn.kf_frame[order]]))
    errs = np.concatenate(errs) if errs else np.zeros(0)
    return dict(feat_mismatch_pct=100.0 * bad / lanes if lanes else None,
                map_reproj_px=float(np.median(errs)) if len(errs) else None,
                frame_ate_pct=max(frame_ate) if frame_ate else None,
                kf_ate_pct=max(kf_ate) if kf_ate else None)
