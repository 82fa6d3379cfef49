"""Matcher variants: compositions of the core gated matcher that reproduce the
candidate rules of the reference's ORBmatcher. Port of the three front-end
entry points of os1_tpu/matching/matchers.py; the mapping-side variants are
not ported yet.
"""
from __future__ import annotations

import torch

from ..features.orb import FrameFeatures
from . import core


def search_for_initialization(f1: FrameFeatures, f2: FrameFeatures,
                              window: float = 100.0, ratio: float = 0.9,
                              max_dist: int = core.TH_LOW) -> core.MatchResult:
    """Window search between the two bootstrap frames
    (ORBmatcher::SearchForInitialization, ORBmatcher.cc:400-515)."""
    gate = core.window_gate(f1.xy, f2.xy, window, f1.valid, f2.valid)
    gate &= (f1.octave[:, None] == 0) & (f2.octave[None, :] == 0)
    res = core.match_with_gate(f1.desc, f2.desc, gate, max_dist, ratio)
    res = core.mutual_best(res, f2.desc.shape[0])
    return core.rotation_consistency(f1.angle, f2.angle, res)


def search_by_projection(point_desc, point_uv, point_valid, point_octave,
                         feats: FrameFeatures, radius, ratio: float = 0.8,
                         max_dist: int = core.TH_HIGH, octave_lo: int = -1,
                         octave_hi: int = 1, unique: bool = True) -> core.MatchResult:
    """Project-and-match: points with predicted pixels and octaves matched to
    frame features inside a per-point window and octave band
    (ORBmatcher::SearchByProjection, ORBmatcher.cc:45-125 and 1292-1423)."""
    gate = core.window_gate(point_uv, feats.xy, radius, point_valid, feats.valid)
    gate &= core.octave_gate(point_octave, feats.octave, octave_lo, octave_hi)
    res = core.match_with_gate(point_desc, feats.desc, gate, max_dist, ratio)
    if unique:
        res = core.mutual_best(res, feats.desc.shape[0])
    return res


def predicted_octave(dist, max_dist_point, scale_factor: float, n_levels: int):
    """Predicted detection octave of a map point from its current distance
    (MapPoint::PredictScale, MapPoint.cc:370-379)."""
    ratio = torch.clamp(max_dist_point / torch.clamp(dist, min=1e-6), min=1e-6)
    # log of the float32 scale, as jnp.log(scale_factor) computes it.
    log_s = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=dist.device))
    lvl = torch.ceil(torch.log(ratio) / log_s).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)
