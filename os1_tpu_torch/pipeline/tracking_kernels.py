"""Device programs of tracking and local mapping. Port of
os1_tpu/pipeline/tracking_kernels.py: feature binding, projection tracking,
reference-keyframe tracking, the two-view bootstrap and the median depth; and
for local mapping, triangulation against the covisible neighbours (K8),
duplicate fusion per keyframe pair (K9) and the local BA's observation tables
(K10), each gathering its keyframe rows and points from the device mirror.

Where the reference ``vmap``-s over neighbours or keyframe pairs, the port
writes the batch dimension out. The host-upload variants
(``triangulate_with_neighbors_batch``, ``fuse_batch``) are not ported: the
system always builds the mirror.

Gathers clip their indices explicitly: JAX clamps out-of-range gather
indices, torch raises on the CPU and reads out of bounds on CUDA.
"""
from __future__ import annotations

import functools

import torch

from ..features.orb import FrameFeatures
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


def _pinhole(K, pc):
    """Undistorted pixel of camera-frame points (..., 3) under intrinsics K."""
    z = pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([K[0, 0] * pc[..., 0] / z + K[0, 2],
                        K[1, 1] * pc[..., 1] / z + K[1, 2]], dim=-1)


def _triangulate_with_neighbors(T_new, T_nb, new_xy, new_desc, new_angle, new_octave,
                                new_unbound, nb_xy, nb_desc, nb_angle, nb_octave, nb_unbound,
                                K, sigma2_table, median_depth_new, enable_far: bool = False):
    """Epipolar-matched triangulation of new map points between the new
    keyframe ([N] arrays) and each of NB covisible neighbours ([NB, N]
    arrays) (LocalMapping::CreateNewMapPoints, LocalMapping.cc:188-367).

    With enable_far, low-parallax candidates that pass every other check are
    routed to quasi-infinity along the new keyframe's ray (the os1 far-point
    experiment, LocalMapping.cc:259-291).

    Returns [NB, N] (neighbour feature per new feature or -1, points [.., 3],
    accepted, far, parallax cosine)."""
    NB, n = nb_xy.shape[0], new_xy.shape[0]
    T_new_b = T_new.expand(NB, 4, 4)
    # Baseline/depth gate (LocalMapping.cc:219-223).
    baseline = torch.linalg.norm(se3.camera_center(T_nb) - se3.camera_center(T_new), dim=-1)
    baseline_ok = (baseline / torch.clamp(median_depth_new, min=1e-6) > 0.01)[:, None]

    F12 = matchers.compute_f12(T_new, T_nb, K, K)  # [NB, 3, 3]
    epi2 = _pinhole(K, se3.transform(T_nb, se3.camera_center(T_new)))  # [NB, 2]
    dummy = torch.zeros_like(new_angle)
    f_new = FrameFeatures(new_xy, dummy, new_angle, new_octave, new_desc, new_unbound)
    f_nb = FrameFeatures(nb_xy, torch.zeros_like(nb_angle), nb_angle, nb_octave, nb_desc,
                         nb_unbound)
    match = matchers.search_for_triangulation(f_new, f_nb, F12, sigma2_table, epipole2=epi2)
    idx = torch.clamp(match.idx, min=0)

    P1 = (K @ T_new[:3, :]).expand(NB, n, 3, 4)
    P2 = (K @ T_nb[:, :3, :])[:, None].expand(NB, n, 3, 4)
    xy2 = torch.gather(nb_xy, 1, idx[..., None].expand(NB, n, 2))
    xy1 = new_xy.expand(NB, n, 2)
    X = triangulation.triangulate_dlt(P1, P2, xy1, xy2)
    X = torch.where(torch.isfinite(X), X, torch.zeros_like(X))

    rays1 = None
    if enable_far:
        d_cam = torch.cat([new_xy, torch.ones_like(new_xy[:, :1])], dim=1) @ torch.linalg.inv(K).T
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
        rays1 = d_cam @ T_new[:3, :3]  # R^T d: the camera ray in the world frame

    proj = functools.partial(_pinhole, K)
    check = triangulation.validate(
        T_new_b, T_nb, X, xy1, xy2, proj, proj,
        sigma2_table[new_octave.long()].expand(NB, n),
        sigma2_table[torch.gather(nb_octave, 1, idx).long()],
        rays1=rays1, enable_far_points=enable_far)
    far = match.ok & check.far & baseline_ok
    accepted = (match.ok & check.valid & baseline_ok) | far
    nb_idx = torch.where(accepted, match.idx, torch.full_like(match.idx, NEG))
    return nb_idx, check.points, accepted, far, check.parallax_cos


TRI_TOP = 1024  # max accepted triangulations read back per keyframe event


def _pack_tri(nb_idx, pts3, accepted, far, cosp):
    """Compact the [NB, N] triangulation outputs to the first TRI_TOP accepted
    entries: (code [TRI_TOP] int32 = flat nb * N + feat or -1, points
    [TRI_TOP, 3], far, neighbour feature, parallax cosine).

    Only the first accepting neighbour of each feature survives (neighbours
    are covisibility-sorted), so at most N entries can be accepted."""
    NB, N = accepted.shape
    j_first = torch.argmax(accepted.to(torch.int8), dim=0)  # first accepting neighbour
    accepted = accepted & (torch.arange(NB, device=accepted.device)[:, None] == j_first[None, :])
    flat_ok = accepted.reshape(-1)
    order = torch.argsort((~flat_ok).to(torch.int8), stable=True)[:TRI_TOP]  # accepted first
    ok_c = flat_ok[order]
    code = torch.where(ok_c, order.to(torch.int32), torch.full_like(order, NEG, dtype=torch.int32))
    return (code, pts3.reshape(-1, 3)[order], far.reshape(-1)[order] & ok_c,
            nb_idx.reshape(-1)[order], cosp.reshape(-1)[order])


def triangulate_mirror_batch(T_new, T_nb, kf_idx: int, all_nb, kf_xy, kf_angle, kf_octave,
                             kf_desc, new_unbound, nb_unbound, K, sigma2_table,
                             median_depth_new, enable_far: bool = False):
    """K8: triangulation of the new keyframe ``kf_idx`` against the NB
    neighbour rows ``all_nb``, keyframe features gathered from the mirror by
    index; poses and unbound masks come from the host snapshot. Returns the
    compacted outputs of :func:`_pack_tri`."""
    out = _triangulate_with_neighbors(
        T_new, T_nb, kf_xy[kf_idx], kf_desc[kf_idx], kf_angle[kf_idx], kf_octave[kf_idx],
        new_unbound, kf_xy[all_nb], kf_desc[all_nb], kf_angle[all_nb], kf_octave[all_nb],
        nb_unbound, K, sigma2_table, median_depth_new, enable_far=enable_far)
    return _pack_tri(*out)


FUSE_PAIR_TOP = 128  # max fuse matches read back per (target, source) pair


def fuse_pairs_mirror(tgt_T, tgt_rows, src_rows, kf_xy, kf_angle, kf_octave, kf_desc,
                      kf_feat_valid, kf_obs_point, pt_xyz, pt_desc, pt_max_dist, pt_valid,
                      pt_obs_kf, intr, width: float, height: float, scale_factor: float,
                      n_levels: int = 8):
    """K9: SearchInNeighbors fusion, one lane per (target, source) keyframe
    pair (LocalMapping.cc:369-447): the source row's bound points, gathered
    from the mirror, are projected into the target and matched against its
    features (ORBmatcher::Fuse). Points already observed in the target are
    skipped. Returns [L, FUSE_PAIR_TOP] int32 codes (src_feat << 12 |
    tgt_feat, -1 pad), ok lanes first in feature order."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pid = kf_obs_point[src_rows]  # [L, N] candidate point per source feature
    pidc = torch.clamp(pid, min=0).long()
    valid = (pid >= 0) & pt_valid[pidc]
    valid &= ~torch.any(pt_obs_kf[pidc] == tgt_rows[:, None, None], dim=-1)
    X = pt_xyz[pidc]  # [L, N, 3]
    pc = se3.transform(tgt_T, X)
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, torch.full_like(pc[..., 2], 1e-8), pc[..., 2])
    uv = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)
    valid &= pc[..., 2] > 0.05
    valid &= (uv[..., 0] > 0) & (uv[..., 0] < width)
    valid &= (uv[..., 1] > 0) & (uv[..., 1] < height)
    dist = torch.linalg.norm(X - se3.camera_center(tgt_T)[:, None, :], dim=-1)
    maxd = torch.nan_to_num(pt_max_dist[pidc], posinf=1e9)
    octv = matchers.predicted_octave(dist, maxd, scale_factor, n_levels)
    tr = tgt_rows.long()
    feats = FrameFeatures(xy=kf_xy[tr], response=torch.zeros_like(kf_angle[tr]),
                          angle=kf_angle[tr], octave=kf_octave[tr], desc=kf_desc[tr],
                          valid=kf_feat_valid[tr])
    scale = torch.tensor(scale_factor, dtype=torch.float32, device=pt_xyz.device)
    res = matchers.fuse_candidates(point_desc=pt_desc[pidc], point_uv=uv, point_valid=valid,
                                   point_octave=octv, radius_scale=scale ** octv.to(torch.float32),
                                   feats=feats)
    ok = res.ok & valid
    order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :FUSE_PAIR_TOP]
    ok_c = torch.gather(ok, 1, order)
    idx_c = torch.gather(res.idx, 1, order)
    code = torch.where(ok_c, (order << 12) | torch.clamp(idx_c, 0, (1 << 12) - 1),
                       torch.full_like(order, NEG))
    return code.to(torch.int32)


def assemble_ba_mirror(pt_xyz, pt_obs_kf, pt_obs_feat, kf_xy, kf_octave, kf_feat_valid,
                       pts_idx, pvalid, cam_lookup, sigma2_table):
    """K10's assembly: the observation tables of a local BA problem gathered
    from the mirror by point slot. Observations in keyframes whose features
    are not materialized (kf_feat_valid False) are excluded. Returns
    (obs_cam, obs_uv, obs_sigma2, obs_valid, points)."""
    okf = pt_obs_kf[pts_idx]  # [P_BA, M]
    oft = pt_obs_feat[pts_idx]
    okf_c = torch.clamp(okf, 0, kf_xy.shape[0] - 1).long()
    oft_c = torch.clamp(oft, 0, kf_xy.shape[1] - 1).long()
    slots = cam_lookup[okf_c]
    valid = (okf >= 0) & (slots >= 0) & pvalid[:, None] & kf_feat_valid[okf_c, oft_c]
    obs_cam = torch.where(valid, slots, torch.zeros_like(slots)).long()
    obs_uv = torch.where(valid[..., None], kf_xy[okf_c, oft_c], torch.zeros_like(kf_xy[okf_c, oft_c]))
    s2 = sigma2_table[kf_octave[okf_c, oft_c].long()]
    obs_s2 = torch.where(valid, s2, torch.ones_like(s2))
    points = pt_xyz[pts_idx] * pvalid[:, None]
    return obs_cam, obs_uv, obs_s2, valid, points
