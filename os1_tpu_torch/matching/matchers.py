"""Matcher variants: compositions of the core gated matcher that reproduce the
candidate rules of the reference's ORBmatcher. Port of
os1_tpu/matching/matchers.py.

The mapping-side variants take leading batch dimensions where the reference
``vmap``-ed them: one problem per covisible neighbour (triangulation) or per
(target, source) keyframe pair (fusion).
"""
from __future__ import annotations

import torch

from ..features.orb import FrameFeatures
from ..geometry import se3
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


def compute_f12(T1w, T2w, K1, K2):
    """Fundamental matrix between two views from their world poses
    (LocalMapping::ComputeF12, LocalMapping.cc:449-477):
    F = K1^-T [t12]x R12 K2^-1 with T12 = T1w * T2w^-1. Batches over the
    leading dimensions of either pose."""
    R1, t1 = T1w[..., :3, :3], T1w[..., :3, 3]
    R2, t2 = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -(R12 @ t2[..., None])[..., 0] + t1
    K1invT = torch.linalg.inv(K1).transpose(-1, -2)
    K2inv = torch.linalg.inv(K2)
    return K1invT @ se3.hat(t12) @ R12 @ K2inv


def epipolar_gate(xy1, xy2, F12, sigma2_2, epipole2=None, sigma2_1=None,
                  chi2: float = 3.84):
    """[..., N1, N2] gate: feature pairs consistent with the epipolar geometry
    (ORBmatcher::CheckDistEpipolarLine, ORBmatcher.cc:135-152: squared
    point-line distance < 3.84 * sigma2 of the second feature's octave), and
    optionally not too close to the epipole in image 2
    (LocalMapping::CreateNewMapPoints, LocalMapping.cc:243+)."""
    x1h = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)  # [..., N1, 3]
    lines = x1h @ F12  # [..., N1, 3]: the line in image 2 is F12^T x1
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    den = a * a + b * b
    dsq = (num * num) / torch.clamp(den, min=1e-12)
    ok = dsq < chi2 * sigma2_2[..., None, :]
    if epipole2 is not None and sigma2_1 is not None:
        de = torch.sum((xy2 - epipole2[..., None, :]) ** 2, dim=-1)
        ok &= de[..., None, :] > 100.0 * sigma2_1[..., :, None]
    return ok


def search_for_triangulation(f1: FrameFeatures, f2: FrameFeatures, F12, sigma2_per_octave,
                             epipole2=None, ratio: float = 0.75,
                             max_dist: int = core.TH_LOW) -> core.MatchResult:
    """Epipolar-constrained matching between two keyframes for new-point
    triangulation (ORBmatcher::SearchForTriangulation, ORBmatcher.cc:652-804;
    the reference's BoW bucket pruning is a CPU speed device, the gated table
    is the same candidate set). ``valid`` masks carry the features not yet
    bound to a map point."""
    s2_1 = sigma2_per_octave[f1.octave.long()]
    s2_2 = sigma2_per_octave[f2.octave.long()]
    gate = f1.valid[..., :, None] & f2.valid[..., None, :]
    gate &= epipolar_gate(f1.xy, f2.xy, F12, s2_2, epipole2, s2_1)
    res = core.match_with_gate(f1.desc, f2.desc, gate, max_dist, ratio)
    res = core.mutual_best(res, f2.desc.shape[-2])
    return core.rotation_consistency(f1.angle, f2.angle, res)


def fuse_candidates(point_desc, point_uv, point_valid, point_octave, feats: FrameFeatures,
                    radius_scale, max_dist: int = core.TH_LOW) -> core.MatchResult:
    """For each projected map point, a duplicate feature in a target keyframe
    (ORBmatcher::Fuse, ORBmatcher.cc:806-1064: radius 3 * scale of the
    predicted octave, best distance <= TH_LOW, no ratio test)."""
    gate = core.window_gate(point_uv, feats.xy, 3.0 * radius_scale, point_valid, feats.valid)
    gate &= core.octave_gate(point_octave, feats.octave, -1, 1)
    res = core.match_with_gate(point_desc, feats.desc, gate, max_dist, ratio=1.0)
    return core.mutual_best(res, feats.desc.shape[-2])
