"""Fused per-frame tracking against the device-resident map mirror.
Port of os1_tpu/pipeline/tracking_fused.py (reference Tracking.cc:231-342):

  1. TrackWithMotionModel with the double-radius retry (Tracking.cc:617);
  2. TrackReferenceKeyFrame fallback when motion tracking fails;
  3. TrackLocalMap: frustum-gated projection matching of the local point
     set + the frame's third pose optimization.

The reference runs the retry as a ``lax.while_loop`` and the fallback as a
``lax.cond`` inside one device program. Here both are host control flow on
one 0-d value read back after each motion attempt: one or two reads per
frame, plus the read of the packed result. Predicated or graph forms are
later work. The host reads the packed result only, in the reference's int32
layout.

Given a stage timer (``step.timer``), the step times each motion-search
attempt with its inlier read (``trk.motion``), the fallback (``trk.refkf``),
the local-map search (``trk.localmap``) and, inside them, each pose solve
(``trk.pose_opt``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera as cam_mod
from ..ops.hamming import _to_i32
from ..utils.profiling import HostReads, StageTimer, span
from .config import SlamConfig
from .frame import FrameData
from .tracking_kernels import NEG, _track_points_core, _track_reference_kf_core


def pack_result(Tcw, bind, n_inliers, pre_ok, n_pre, used_motion, visible) -> torch.Tensor:
    """Pack the step's outputs into ONE int32 vector. Layout:
      [0:16]   Tcw float32 bits
      [16]     n_inliers | [17] n_pre | [18] pre_ok | [19] used_motion
      [20:20+N]          bind
      [20+N : 20+N+L/32] visible bitmask (bit i of word w = lane w*32+i)
    """
    L = visible.shape[0]
    dev = visible.device
    bits = visible.reshape(L // 32, 32).to(torch.int64) << torch.arange(32, device=dev)
    vis_words = _to_i32(bits.sum(-1))
    head = Tcw.reshape(-1).to(torch.float32).contiguous().view(torch.int32)
    scalars = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                           for v in (n_inliers, n_pre, pre_ok, used_motion)])
    return torch.cat([head, scalars, bind.to(torch.int32), vis_words])


def unpack_result(arr, n_feat: int, n_local: int) -> dict:
    """Host-side inverse of :func:`pack_result` (numpy)."""
    arr = np.asarray(arr)
    Tcw = arr[:16].view(np.float32).reshape(4, 4)
    words = arr[20 + n_feat:].view(np.uint32)
    visible = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).reshape(-1)
    return dict(
        Tcw=Tcw, n_inliers=int(arr[16]), n_pre=int(arr[17]), pre_ok=bool(arr[18]),
        used_motion=bool(arr[19]), bind=arr[20:20 + n_feat], visible=visible[:n_local],
    )


def _orthonormalize_se3(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Gram-Schmidt on rows):
    keeps the device pose chain exactly rigid."""
    R = T[:3, :3]
    r0 = R[0] / torch.linalg.norm(R[0])
    r1 = R[1] - torch.dot(R[1], r0) * r0
    r1 = r1 / torch.linalg.norm(r1)
    r2 = torch.linalg.cross(r0, r1)
    out = T.clone()
    out[:3, :3] = torch.stack([r0, r1, r2])
    return out


def make_fused_tracker(cfg: SlamConfig, reads: HostReads | None = None,
                       timer: StageTimer | None = None):
    """Build the fused step for a fixed config; ``reads`` counts the step's
    device-to-host reads, ``timer`` (kept as ``step.timer``) times its
    stages."""
    th = cfg.th
    scale_factor = cfg.orb.scale_factor
    n_levels = cfg.orb.n_levels
    pose_cfg = (th.pose_opt_rounds, th.pose_opt_iters, th.pose_opt_reject)
    reads = reads if reads is not None else HostReads()

    def step(pt_xyz, pt_desc, pt_valid, pt_normal, pt_min_dist, pt_max_dist,
             kf_desc, kf_angle, kf_obs_point,
             frame: FrameData, cam: cam_mod.Camera, intr,
             last_T, prev_T, last_bind, last_octave, ref_kf: int, ref_ok: bool,
             local_ids, local_valid, has_velocity: bool):
        P = pt_xyz.shape[0]
        n_feat = frame.xy_un.shape[0]
        dev = pt_xyz.device
        timer = step.timer

        # Constant-velocity prediction (Tracking.cc:278-283).
        if has_velocity:
            Rp, tp = prev_T[:3, :3], prev_T[:3, 3]
            prev_inv = torch.eye(4, dtype=last_T.dtype, device=dev)
            prev_inv[:3, :3] = Rp.T
            prev_inv[:3, 3] = -Rp.T @ tp
            pred_T = (last_T @ prev_inv) @ last_T
        else:
            pred_T = last_T

        # ---------------- stage 1: motion-model tracking ---------------- #
        m_ids = torch.clamp(last_bind, 0, P - 1)
        m_live = (last_bind >= 0) & pt_valid[m_ids]
        no_prev = torch.zeros(n_feat, dtype=torch.bool, device=dev)
        zeros3 = torch.zeros((n_feat, 3), dtype=torch.float32, device=dev)
        m_pts = (pt_xyz[m_ids], pt_desc[m_ids], m_live, last_octave, pt_normal[m_ids],
                 pt_min_dist[m_ids], pt_max_dist[m_ids])

        def run_motion(radius):
            with span(timer, "trk.motion"):
                r = _track_points_core(
                    pred_T, *m_pts, no_prev, zeros3, no_prev, frame, cam, intr, radius,
                    scale_factor=scale_factor, n_levels=n_levels,
                    use_frustum=False, ratio=0.9, pose_opt_cfg=pose_cfg, timer=timer,
                )
                return r[0], r[1], reads.item(r[3])

        # Radius-escalation retry (Tracking.cc:617: th -> 2*th when weak).
        T1, b1, n1 = run_motion(th.motion_search_radius)
        if n1 < th.min_motion_inliers + 10:
            T1, b1, n1 = run_motion(th.motion_search_radius_retry)
        g1 = torch.where(b1 >= 0, last_bind[torch.clamp(b1, 0, n_feat - 1)],
                         torch.full_like(b1, NEG))
        ok1 = n1 >= th.min_motion_inliers

        # -------------- stage 2: reference-KF fallback ------------------ #
        if ok1:
            T_pre, g_pre, n_pre, ok_pre = T1, g1, n1, True
        else:
            with span(timer, "trk.refkf"):
                obs = kf_obs_point[ref_kf].long()
                obs_c = torch.clamp(obs, 0, P - 1)
                has_pt = (obs >= 0) & pt_valid[obs_c]
                T2, b2, _, n2 = _track_reference_kf_core(
                    last_T, kf_desc[ref_kf], has_pt, pt_xyz[obs_c], kf_angle[ref_kf],
                    frame, intr, pose_opt_cfg=pose_cfg, timer=timer,
                )
                g_pre = torch.where(b2 >= 0, obs[torch.clamp(b2, 0, n_feat - 1)],
                                    torch.full_like(b2, NEG))
                T_pre, n_pre = T2, n2
                ok_pre = (n2 >= th.min_refkf_inliers) & ref_ok

        # ---------------- stage 3: local-map tracking ------------------- #
        with span(timer, "trk.localmap"):
            local_ids = local_ids.long()
            l_ids = torch.clamp(local_ids, 0, P - 1)
            prev_bound = g_pre >= 0
            g_pre_c = torch.clamp(g_pre, 0, P - 1)
            # Scatter-max, as the reference's .at[].max: no boolean indexing,
            # which would read a count back to the host.
            bound_now = torch.zeros(P, dtype=torch.int32, device=dev).scatter_reduce(
                0, g_pre_c, prev_bound.to(torch.int32), reduce="amax") > 0
            cand = local_valid & pt_valid[l_ids] & ~bound_now[l_ids]
            L = local_ids.shape[0]
            T3, lb, inlier, n3, visible = _track_points_core(
                T_pre, pt_xyz[l_ids], pt_desc[l_ids], cand,
                torch.zeros(L, dtype=torch.int32, device=dev),
                pt_normal[l_ids], pt_min_dist[l_ids], pt_max_dist[l_ids],
                prev_bound, pt_xyz[g_pre_c], prev_bound,
                frame, cam, intr, th.localmap_search_radius,
                scale_factor=scale_factor, n_levels=n_levels,
                use_frustum=True, ratio=0.8, pose_opt_cfg=pose_cfg, timer=timer,
            )
        g3 = torch.where(lb >= 0, local_ids[torch.clamp(lb, 0, L - 1)],
                         torch.where(prev_bound & inlier, g_pre, torch.full_like(g_pre, NEG)))
        T_final = _orthonormalize_se3(T3)
        return dict(Tcw=T_final, bind=g3,
                    packed=pack_result(T_final, g3, n3, ok_pre, n_pre, ok1, visible & cand))

    step.reads = reads
    step.timer = timer
    return step
