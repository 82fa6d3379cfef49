"""Tracking front-end state machine (host orchestration of device work).
Port of the synchronous paths of os1_tpu/pipeline/tracking.py (reference
Tracking.cc:123-342): two-view initialization with its initial BA, the fused
per-frame step against the device mirror, the keyframe decision and keyframe
creation.

Not ported yet: pipelined tracking, the unfused host path and
relocalization. In the LOST state the tracker stays lost, as the reference
tracker does without a relocalizer; a map with <= 5 keyframes resets.

States mirror the reference enum: NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from ..map.mirror import to_device
from ..map.store import MapStore
from ..optim import BAProblem, ba_begin, ba_iterate, ba_result
from ..optim.ba_core import C_BUCKETS, P_BUCKETS
from ..solvers.initializer import GumbelSampler
from ..utils.profiling import HostReads, StageTimer
from . import tracking_fused
from . import tracking_kernels as tk
from .config import SlamConfig
from .frame import FrameData, make_frame_builder, unpack_host


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class TrackedFrame:
    """Host-side record of the last processed frame."""

    data: FrameData
    Tcw: np.ndarray
    bind: np.ndarray  # [N] global map-point id per feature (-1 unbound)
    frame_id: int
    timestamp: float
    n_inliers: int = 0


@dataclass
class Tracker:
    cfg: SlamConfig
    store: MapStore
    device: torch.device | str = "cuda"
    # sampler(valid, iters, k) -> [iters, k] RANSAC hypothesis indices, called
    # twice per bootstrap attempt (homography, then fundamental). None: a
    # Gumbel top-k from a torch.Generator seeded with 0 on ``device``.
    sampler: object = None
    mirror: object = None  # DeviceMirror, wired by System
    state: TrackingState = TrackingState.NO_IMAGES_YET
    last: TrackedFrame | None = None
    init_ref: TrackedFrame | None = None
    velocity: np.ndarray | None = None
    ref_kf: int = -1
    frame_id: int = 0
    last_kf_frame_id: int = 0
    on_new_keyframe = None  # callback(kf, bootstrap=False, frame=None), wired by System
    on_reset = None  # callback(), wired by System
    trajectory: list = field(default_factory=list)
    loss_log: list = field(default_factory=list)  # (frame_id, reason) per loss
    timer: StageTimer = field(default_factory=StageTimer)
    reads: HostReads = field(default_factory=HostReads)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.camera = self.cfg.camera.to(self.device)
        self._build = make_frame_builder(self.cfg.orb, self.device)
        self._fused = tracking_fused.make_fused_tracker(self.cfg, self.reads)
        self._prev_Tcw = None  # pose two frames back
        if self.sampler is None:
            self.sampler = GumbelSampler(seed=0, device=self.device)
        self._intr = torch.as_tensor(self.cfg.intr, device=self.device)
        i = self.cfg.intr
        self._K = torch.tensor([[i[0], 0, i[2]], [0, i[1], i[3]], [0, 0, 1]],
                               dtype=torch.float32, device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    # ------------------------------------------------------------------ #
    def track(self, img, timestamp: float = 0.0):
        """Process one grayscale image. Returns (state, Tcw or None)."""
        with self.timer("trk.extract"):
            img_t = torch.as_tensor(np.asarray(img)).to(self.device)
            frame = self._build(img_t, self.camera)
        fid = self.frame_id
        self.frame_id += 1
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            with self.timer("trk.initialize"):
                self._monocular_initialization(frame, fid, timestamp)
        elif self.state == TrackingState.OK:
            with self.timer("trk.track"):
                self._track_frame(frame, fid, timestamp)
        # LOST: no relocalizer in this port yet — stay lost.
        Tcw = self.last.Tcw if self.last is not None and self.state == TrackingState.OK else None
        return self.state, Tcw

    def _record_trajectory(self, timestamp, fid, Tcw):
        """Record the frame pose relative to the current reference keyframe."""
        st = self.store
        ref = self.ref_kf
        if ref >= 0 and st.kf_valid[ref]:
            T_rel = (Tcw @ np.linalg.inv(st.kf_T[ref])).astype(np.float32)
            self.trajectory.append((timestamp, fid, int(ref), int(st.kf_seq[ref]), T_rel,
                                    Tcw.copy()))
        else:
            self.trajectory.append((timestamp, fid, -1, -1, None, Tcw.copy()))

    def frame_trajectory(self):
        """[(timestamp, frame_id, Tcw)] re-anchored through each reference
        keyframe's current pose. A culled reference is walked to a live
        ancestor through the relative poses saved at its cull (the reference's
        SaveTrajectoryTUM ``while (pKF->isBad()) Trw *= mTcp`` walk); only a
        fully dead chain falls back to the pose as it was recorded."""
        st = self.store
        out = []
        for ts, fid, ref, seq, T_rel, T_abs in self.trajectory:
            T = None
            if ref >= 0:
                T_acc, r, s = T_rel, ref, seq
                for _ in range(256):  # bounded ancestor walk
                    if st.kf_valid[r] and st.kf_seq[r] == s:
                        T = T_acc @ st.kf_T[r]
                        break
                    link = st.culled_links.get((r, s))
                    if link is None:
                        break
                    r, s, T_cp = link
                    T_acc = T_acc @ T_cp
            out.append((ts, fid, T if T is not None else T_abs))
        return out

    # ------------------------------------------------------------------ #
    # initialization (Tracking.cc:344-521)
    # ------------------------------------------------------------------ #
    def _monocular_initialization(self, frame, fid, timestamp):
        """Two-view bootstrap with one host read per attempt (the bootstrap
        head: both frames' feature counts, the match count, success). The
        reference frame is adopted optimistically and replaced if the head
        shows it was feature-poor."""

        def adopt_ref():
            self.init_ref = TrackedFrame(
                data=frame, Tcw=np.eye(4, dtype=np.float32),
                bind=np.full(self.cfg.orb.n_features, -1, np.int64),
                frame_id=fid, timestamp=timestamp,
            )
            self.state = TrackingState.NOT_INITIALIZED

        if self.init_ref is None:
            adopt_ref()
            return
        match, init, head = tk.bootstrap(self.init_ref.data, frame, self._K, self.sampler)
        head = self.reads.numpy(head)
        min_m = self.cfg.th.min_init_matches
        if head[0] <= min_m:  # reference frame was feature-poor: replace
            if head[1] > min_m:
                adopt_ref()
            else:
                self.init_ref = None
            return
        if head[1] <= min_m:  # current frame feature-poor: keep waiting
            return
        if int(head[2]) < min_m:  # n_matches
            self.init_ref = None
            return
        if head[3] < 0.5:  # init.success
            return
        self._create_initial_map(frame, fid, timestamp, match, init)

    def _create_initial_map(self, frame, fid, timestamp, match, init):
        st = self.store
        f1, f2 = self.init_ref.data, frame
        rd = self.reads.numpy
        T21, good, m_idx, pts3d = rd(init.T21), rd(init.good), rd(match.idx), rd(init.points)
        p1, p2 = rd(f1.host_pack), rd(f2.host_pack)
        k1 = st.add_keyframe(np.eye(4, dtype=np.float32), *unpack_host(p1),
                             frame_id=self.init_ref.frame_id, timestamp=self.init_ref.timestamp)
        k2 = st.add_keyframe(T21, *unpack_host(p2), frame_id=fid, timestamp=timestamp)
        st.kf_parent[k2] = k1
        feat1_ids = np.nonzero(good)[0]
        pt_ids = st.alloc_points(len(feat1_ids))
        st.pt_xyz[pt_ids] = pts3d[feat1_ids]
        st.pt_first_seq[pt_ids] = st.kf_seq[k2]
        n_new = len(pt_ids)
        st.add_observations(
            np.concatenate([pt_ids, pt_ids]),
            np.concatenate([np.full(n_new, k1), np.full(n_new, k2)]),
            np.concatenate([feat1_ids, m_idx[feat1_ids]]),
        )
        st.update_point_derived(pt_ids, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

        # Global BA over the initial two-view map (Tracking.cc:470).
        self._initial_ba(k1, k2, pt_ids)

        # Median-depth normalization to 1.0 (Tracking.cc:473-497).
        md = self.reads.item(tk.compute_median_depth(
            self._dev(st.kf_T[k1]), self._dev(st.pt_xyz), self._dev(st.pt_valid)))
        if md < 1e-6 or int(st.pt_n_obs[pt_ids].sum()) < 2 * self.cfg.th.min_init_triangulated:
            self.reset()
            return
        st.pt_xyz[st.pt_valid] /= md
        st.kf_T[k2, :3, 3] /= md
        st.update_point_derived(pt_ids, self.cfg.orb.scale_factor, self.cfg.orb.n_levels)

        bind = np.full(self.cfg.orb.n_features, -1, np.int64)
        bind[m_idx[feat1_ids]] = pt_ids
        self.last = TrackedFrame(data=frame, Tcw=st.kf_T[k2].copy(), bind=bind, frame_id=fid,
                                 timestamp=timestamp, n_inliers=len(pt_ids))
        self.ref_kf = k2
        self.last_kf_frame_id = fid
        self.velocity = None
        self._prev_Tcw = None
        self.state = TrackingState.OK
        self._record_trajectory(timestamp, fid, self.last.Tcw)
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k1, bootstrap=True)
            self.on_new_keyframe(k2, bootstrap=True)

    def _initial_ba(self, k1, k2, pt_ids):
        """Initial two-view BA (Tracking.cc:470) on the padded (P, C) bucket
        shapes of the local mapper, 20 LM iterations in chunks of 5."""
        st = self.store
        P = len(pt_ids)
        P_pad = next(b for b in P_BUCKETS if b >= P)
        C_pad = C_BUCKETS[0]
        M = st.cfg.max_obs_per_point
        okf = st.pt_obs_kf[pt_ids]
        oft = st.pt_obs_feat[pt_ids]
        okf_c = np.clip(okf, 0, None)
        oft_c = np.clip(oft, 0, None)
        obs_valid = np.zeros((P_pad, M), bool)
        obs_cam = np.zeros((P_pad, M), np.int64)
        obs_uv = np.zeros((P_pad, M, 2), np.float32)
        obs_s2 = np.ones((P_pad, M), np.float32)
        obs_valid[:P] = okf >= 0
        obs_cam[:P] = np.where(okf_c == k2, 1, 0)
        obs_uv[:P] = st.kf_xy[okf_c, oft_c]
        obs_s2[:P] = self.cfg.sigma2_table[st.kf_octave[okf_c, oft_c]]
        cam_T = np.tile(np.eye(4, dtype=np.float32), (C_pad, 1, 1))
        cam_T[0], cam_T[1] = st.kf_T[k1], st.kf_T[k2]
        fixed = np.ones(C_pad, bool)
        fixed[1] = False
        points = np.zeros((P_pad, 3), np.float32)
        points[:P] = st.pt_xyz[pt_ids]
        pvalid = np.zeros(P_pad, bool)
        pvalid[:P] = True
        d = self._dev
        prob = BAProblem(cam_T=d(cam_T), cam_fixed=d(fixed), points=d(points),
                         point_valid=d(pvalid), obs_cam=d(obs_cam), obs_uv=d(obs_uv),
                         obs_sigma2=d(obs_s2), obs_valid=d(obs_valid), intr=self._intr)
        state = ba_begin(prob)
        for _ in range(4):  # 20 LM iterations (GlobalBundleAdjustemnt(20))
            state = ba_iterate(prob, state, n=5)
        res = ba_result(prob, state)
        st.kf_T[k2] = self.reads.numpy(res.cam_T[1])
        st.pt_xyz[pt_ids] = self.reads.numpy(res.points)[:P]

    # ------------------------------------------------------------------ #
    # steady-state tracking (Tracking.cc:231-342)
    # ------------------------------------------------------------------ #
    def _track_frame(self, frame, fid, timestamp):
        ok, Tcw, bind, n_inl = self._track_frame_device(frame)
        if not ok:
            self._mark_lost(frame, fid, timestamp, self.last.Tcw, info="pre_fail")
            return
        self._finish_frame(frame, fid, timestamp, Tcw, bind, n_inl)

    def _mark_lost(self, frame, fid, timestamp, Tcw, info=""):
        self.loss_log.append((fid, info))
        self.state = TrackingState.LOST
        self.last = TrackedFrame(data=frame, Tcw=Tcw,
                                 bind=np.full(self.cfg.orb.n_features, -1, np.int64),
                                 frame_id=fid, timestamp=timestamp)
        # Lost right after initialization: reset (Tracking.cc:327-335).
        if self.store.n_keyframes() <= 5:
            self.reset()

    def _finish_frame(self, frame, fid, timestamp, Tcw, bind, n_inl):
        """Post-local-map tail: accept/lose, motion model, keyframe decision."""
        if n_inl < self.cfg.th.min_localmap_inliers:
            self._mark_lost(frame, fid, timestamp, Tcw, info=f"localmap n_inl={n_inl}")
            return
        if self.last is not None:  # motion model (Tracking.cc:278-283)
            self.velocity = Tcw @ np.linalg.inv(self.last.Tcw)
            self._prev_Tcw = self.last.Tcw
        self.last = TrackedFrame(data=frame, Tcw=Tcw, bind=bind, frame_id=fid,
                                 timestamp=timestamp, n_inliers=n_inl)
        self._record_trajectory(timestamp, fid, Tcw)
        if self._need_new_keyframe(n_inl, fid):
            self._create_new_keyframe(frame, fid, timestamp, bind)

    def _track_frame_device(self, frame):
        """One fused step and one read of its packed result. Returns
        (pre_ok, Tcw, bind, n_localmap_inliers)."""
        has_vel = self.velocity is not None and self.last is not None
        prev = self._prev_Tcw if self._prev_Tcw is not None else self.last.Tcw
        with self.timer("trk.local_select"):
            local_ids, local_valid = self._local_candidates(self.last.bind)
        mir = self.mirror
        ref_ok = self.ref_kf >= 0 and bool(self.store.kf_valid[self.ref_kf])
        out = self._fused(
            mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal,
            mir.pt_min_dist, mir.pt_max_dist, mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            frame, self.camera, self._intr,
            self._dev(self.last.Tcw.astype(np.float32)), self._dev(prev.astype(np.float32)),
            self._dev(self.last.bind.astype(np.int64)), self.last.data.feats.octave,
            max(self.ref_kf, 0), ref_ok, self._dev(local_ids), self._dev(local_valid), has_vel,
        )
        host = tracking_fused.unpack_result(self.reads.numpy(out["packed"]),
                                            self.cfg.orb.n_features, self.cfg.th.max_local_points)
        if not host["pre_ok"]:
            return False, None, None, 0
        bind = host["bind"].astype(np.int64)
        st = self.store
        st.pt_visible[local_ids[host["visible"]]] += 1
        st.pt_found[bind[bind >= 0]] += 1
        return True, host["Tcw"].astype(np.float32), bind, int(host["n_inliers"])

    def _local_candidates(self, bind):
        """Padded local-map candidate ids: points of the covisibility
        neighborhood of the previous frame's bindings, unioned with the
        reference keyframe's own points."""
        st = self.store
        pts, _ = self._local_point_ids(bind)
        if self.ref_kf >= 0:
            rp = st.kf_obs_point[self.ref_kf]
            rp = rp[rp >= 0]
            rp = rp[st.pt_valid[rp]]
            pts = np.union1d(pts, rp)
        L = self.cfg.th.max_local_points
        ids = np.zeros(L, np.int32)
        valid = np.zeros(L, bool)
        m = min(len(pts), L)
        ids[:m] = pts[:m]
        valid[:m] = True
        return ids, valid

    def _local_point_ids(self, bind):
        """Local map = points seen by keyframes sharing points with the
        current frame + their best covisible neighbors (Tracking.cc:838-967)."""
        st = self.store
        th = self.cfg.th
        tracked = np.unique(bind[bind >= 0])
        if len(tracked) == 0:
            return np.empty(0, np.int64), []
        obs_kf = st.pt_obs_kf[tracked]
        kf_counts = np.bincount(obs_kf[obs_kf >= 0], minlength=st.cfg.max_keyframes)
        k1 = np.nonzero(kf_counts)[0]
        k1 = k1[np.argsort(-kf_counts[k1], kind="stable")][: th.max_local_keyframes]
        local_kfs = set(int(k) for k in k1)
        if len(k1) > 0:
            for nb in st.covisible_keyframes(int(k1[0]), top=10):
                local_kfs.add(int(nb))
        pts = st.kf_obs_point[sorted(local_kfs)]
        pts = np.unique(pts[pts >= 0])
        pts = pts[st.pt_valid[pts]]
        return pts[: th.max_local_points], sorted(local_kfs)

    # ------------------------------------------------------------------ #
    # keyframe decision / creation (Tracking.cc:697-779)
    # ------------------------------------------------------------------ #
    def _need_new_keyframe(self, n_inl, fid):
        th = self.cfg.th
        st = self.store
        if self.ref_kf < 0:
            return False
        # Reference matches count points with >= 3 observations when the map
        # has > 2 keyframes (Tracking.cc:711-714).
        min_obs = 3 if st.n_keyframes() > 2 else 2
        obs = st.kf_obs_point[self.ref_kf]
        oc = np.clip(obs, 0, None)
        n_ref = int(((obs >= 0) & st.pt_valid[oc] & (st.pt_n_obs[oc] >= min_obs)).sum())
        c1 = fid >= self.last_kf_frame_id + th.kf_max_frames
        c2 = (n_inl < n_ref * th.kf_ref_ratio) and n_inl > th.kf_min_tracked
        # Baseline-over-depth staleness (see the reference package).
        c3 = False
        if n_inl > th.kf_min_tracked:
            ids = self.last.bind
            ids = ids[ids >= 0]
            if len(ids) > 10:
                Tcw = self.last.Tcw
                pc_z = (st.pt_xyz[ids] @ Tcw[:3, :3].T + Tcw[:3, 3])[:, 2]
                md = float(np.median(pc_z[pc_z > 0])) if (pc_z > 0).any() else 0.0
                Ow_cur = -Tcw[:3, :3].T @ Tcw[:3, 3]
                Tkf = st.kf_T[self.ref_kf]
                Ow_kf = -Tkf[:3, :3].T @ Tkf[:3, 3]
                baseline = float(np.linalg.norm(Ow_cur - Ow_kf))
                c3 = md > 1e-6 and baseline / md > th.kf_baseline_depth_ratio
        # Rotation staleness (cfg.th.kf_view_angle_deg).
        c4 = False
        if n_inl > th.kf_min_tracked and self.ref_kf >= 0:
            z_cur = self.last.Tcw[2, :3]
            z_ref = st.kf_T[self.ref_kf][2, :3]
            c4 = float(np.dot(z_cur, z_ref)) < float(np.cos(np.deg2rad(th.kf_view_angle_deg)))
        return bool(c1 or c2 or c3 or c4)

    def _create_new_keyframe(self, frame, fid, timestamp, bind):
        st = self.store
        if int((~st.kf_valid).sum()) == 0:
            return
        with self.timer("trk.create_kf"):
            # Pose + bindings now; the feature arrays follow when the system
            # materializes the keyframe (LocalMapping::ProcessNewKeyFrame).
            k = st.add_keyframe_pending(self.last.Tcw, frame_id=fid, timestamp=timestamp)
            f_idx = np.nonzero(bind >= 0)[0]
            p_ids = bind[f_idx]
            live = st.pt_valid[p_ids]
            st.add_observations(p_ids[live], np.full(int(live.sum()), k), f_idx[live])
            self.ref_kf = k
            self.last_kf_frame_id = fid
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k, frame=frame)

    def reset(self):
        """Full tracker reset (Tracking::Reset, Tracking.cc:1133-1175)."""
        self.state = TrackingState.NO_IMAGES_YET
        self.last = None
        self.init_ref = None
        self.velocity = None
        self._prev_Tcw = None
        self.ref_kf = -1
        self.last_kf_frame_id = 0
        self.store.__post_init__()  # clear all map arrays
        if self.on_reset is not None:
            self.on_reset()
