"""Device programs of the tracking front end. Port of the front-end half of
os1_tpu/pipeline/tracking_kernels.py: feature binding, projection tracking,
reference-keyframe tracking, the two-view bootstrap and the median depth.

Gathers clip their indices explicitly: JAX clamps out-of-range gather
indices, torch raises on the CPU and reads out of bounds on CUDA.
"""
from __future__ import annotations

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3, triangulation
from ..matching import core as mcore
from ..matching import matchers
from ..optim import optimize_pose
from ..solvers.initializer import initialize_two_view
from .frame import FrameData

NEG = -1


def _bind_features(n_feat: int, match: mcore.MatchResult, pt_slots: torch.Tensor) -> torch.Tensor:
    """Invert a point->feature match into a per-feature binding [n_feat]
    (local point slot per feature, -1 unbound). Unmatched rows write to a
    scratch lane past the end, which is dropped."""
    bind = torch.full((n_feat + 1,), NEG, dtype=torch.int64, device=pt_slots.device)
    tgt = torch.where(match.ok, match.idx, torch.full_like(match.idx, n_feat))
    bind[tgt] = torch.where(match.ok, pt_slots, torch.full_like(pt_slots, NEG))
    return bind[:n_feat]


def _track_points_core(T0, pt_xyz, pt_desc, pt_valid, pt_octave, pt_normal,
                       pt_min_dist, pt_max_dist, exclude_feat, prev_xyz, prev_bound,
                       frame: FrameData, cam: cam_mod.Camera, intr, base_radius,
                       scale_factor: float = 1.2, n_levels: int = 8,
                       use_frustum: bool = False, ratio: float = 0.8,
                       max_dist: int = mcore.TH_HIGH,
                       pose_opt_cfg: tuple = (4, 10, True)):
    """Project candidate points into the frame, match, and pose-optimize
    (TrackWithMotionModel with use_frustum=False; TrackLocalMap's
    SearchLocalPoints with use_frustum=True).

    Returns (T_opt, bind [N] local slot per feature, inlier [N], n_inliers,
    visible [P])."""
    n_feat = frame.xy_un.shape[0]
    pc = se3.transform(T0, pt_xyz)
    uv = cam_mod.project_ideal(cam, pc)
    visible = pt_valid & (pc[..., 2] > 0.05) & cam_mod.in_image(cam, uv, margin=1.0)

    if use_frustum:
        Ow = se3.camera_center(T0)
        po = pt_xyz - Ow
        dist = torch.linalg.norm(po, dim=-1)
        visible &= (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
        viewcos = torch.sum(po * pt_normal, dim=-1) / torch.clamp(
            dist * torch.linalg.norm(pt_normal, dim=-1), min=1e-8)
        visible &= viewcos > 0.5
        octave = matchers.predicted_octave(dist, pt_max_dist, scale_factor, n_levels)
        # Reference: radius 2.5 when viewcos > 0.998 else 4.0 (ORBmatcher.cc:67).
        radius = torch.where(viewcos > 0.998, 2.5 / 4.0, 1.0) * base_radius
    else:
        octave = pt_octave
        radius = base_radius

    scale = torch.tensor(scale_factor, dtype=torch.float32, device=pt_xyz.device)
    radius_px = radius * scale ** octave.to(torch.float32)
    feats = frame.feats._replace(xy=frame.xy_un, valid=frame.feats.valid & ~exclude_feat)
    res = matchers.search_by_projection(
        point_desc=pt_desc, point_uv=uv, point_valid=visible, point_octave=octave,
        feats=feats, radius=radius_px, ratio=ratio, max_dist=max_dist,
        octave_lo=-1 if use_frustum else 0, octave_hi=1,
    )
    slots = torch.arange(pt_xyz.shape[0], dtype=torch.int64, device=pt_xyz.device)
    bind = _bind_features(n_feat, res, slots)
    new_bound = (bind >= 0) & ~prev_bound
    bound = new_bound | prev_bound
    pts_for_feat = torch.where(new_bound[:, None], pt_xyz[torch.clamp(bind, min=0)], prev_xyz)
    rounds, iters, ar = pose_opt_cfg
    opt = optimize_pose(T0, pts_for_feat, frame.xy_un, frame.sigma2, bound, intr,
                        rounds=rounds, iters_per_round=iters, accept_reject=ar)
    inlier = opt.inlier & bound
    bind = torch.where(inlier & new_bound, bind, torch.full_like(bind, NEG))
    return opt.Tcw, bind, inlier, torch.sum(inlier), visible


def _track_reference_kf_core(T0, kf_desc, kf_bound, kf_pt_xyz, kf_angle,
                             frame: FrameData, intr, pose_opt_cfg: tuple = (4, 10, True)):
    """Descriptor-only matching against the reference keyframe + pose opt
    (TrackReferenceKeyFrame, Tracking.cc:540-582). Returns (T_opt, bind
    [N_frame] -> keyframe feature index, inlier, n_inliers)."""
    gate = frame.feats.valid[:, None] & kf_bound[None, :]
    res = mcore.match_with_gate(frame.feats.desc, kf_desc, gate, max_dist=mcore.TH_LOW, ratio=0.7)
    res = mcore.mutual_best(res, kf_desc.shape[0])
    res = mcore.rotation_consistency(frame.feats.angle, kf_angle, res)
    bound = res.ok
    pts_for_feat = kf_pt_xyz[torch.clamp(res.idx, min=0)]
    rounds, iters, ar = pose_opt_cfg
    opt = optimize_pose(T0, pts_for_feat, frame.xy_un, frame.sigma2, bound, intr,
                        rounds=rounds, iters_per_round=iters, accept_reject=ar)
    inlier = opt.inlier & bound
    bind = torch.where(inlier, res.idx, torch.full_like(res.idx, NEG))
    return opt.Tcw, bind, inlier, torch.sum(inlier)


def bootstrap(f1: FrameData, f2: FrameData, K: torch.Tensor, sampler):
    """Initialization attempt between two frames: window match + two-view
    RANSAC reconstruction (MonocularInitialization, Tracking.cc:344-419).

    Returns (match f1->f2, InitResult, head [4] float32: feature counts of
    both frames, match count, success) — the host reads only the head."""
    match = matchers.search_for_initialization(
        f1.feats._replace(xy=f1.xy_un), f2.feats._replace(xy=f2.xy_un))
    xy2 = f2.xy_un[torch.clamp(match.idx, min=0)]
    init = initialize_two_view(f1.xy_un, xy2, match.ok, K, sampler)
    head = torch.stack([
        torch.sum(f1.feats.valid).to(torch.float32),
        torch.sum(f2.feats.valid).to(torch.float32),
        torch.sum(match.ok).to(torch.float32),
        init.success.to(torch.float32),
    ])
    return match, init, head


def compute_median_depth(T, pt_xyz, mask):
    return triangulation.median_depth(T, pt_xyz, mask)
