"""Tracking front-end state machine (host orchestration of device work).
Port of the mirror paths of os1_tpu/pipeline/tracking.py (reference
Tracking.cc:123-342): two-view initialization with its initial BA, the fused
per-frame step against the device mirror, synchronous or pipelined, the
keyframe decision and keyframe creation, and relocalization from LOST.

Pipelined tracking keeps up to ``PIPELINE_DEPTH`` frames in flight: frame N's
fused step is dispatched against a device-resident chain of (bind, T, prevT,
octave) while the host applies frame N - depth's result, so the state and
pose ``track`` returns lag by the depth. The port's fused step still reads
its motion-search retry decision on the host (``tracking_fused.py``), so a
dispatch waits for its own retry read; the packed result is copied to the
host from dispatch (``utils/transfer.py``) and read at apply.

The map lock (``lock``, shared with the mapper, the loop closer and the
System) is held over initialization, relocalization and a synchronous frame,
as in the reference; a pipelined frame takes it to snapshot its inputs and
again to extend the chain, runs its fused step between the two, and a
result's host tail takes it after the result's read. A loop correction
(on another thread, or in the cooperative scheduler's step) drops the frames
in flight (:meth:`Tracker.drop_in_flight`), since their pose chain is
anchored in the old world, and so does a frame dispatched, or a result read,
across the drop; the frames are kept and tracked again, oldest first, on a
new chain from the remapped pose before the next frame, so no frame is
skipped (:meth:`Tracker._replay_dropped`). A point culled while a frame is
in flight may have its slot refilled before the frame is read: each binding
is checked against the slot's allocation count (``MapStore.pt_gen``) the
step saw, and a refilled slot is dropped from the result
(``stale_binds`` counts them) and from the device chain.

Not ported: the unfused host path (the system always builds the mirror).

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
from ..utils import transfer
from ..utils.profiling import HostReads, StageTimer
from . import tracking_fused
from . import tracking_kernels as tk
from .config import SlamConfig
from .frame import FrameData, make_frame_builder, unpack_host
from .workers import MapLock


# Frames in flight when pipelined; the state the tracker returns lags this
# many frames (a young map tracks at depth 1, see _track_frame_pipelined).
PIPELINE_DEPTH = 2


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
    gen: np.ndarray | None = None  # the store's pt_gen when ``bind`` was checked


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
    pipelined: bool = False  # frame pipelining over the device chain
    state: TrackingState = TrackingState.NO_IMAGES_YET
    last: TrackedFrame | None = None
    init_ref: TrackedFrame | None = None
    velocity: np.ndarray | None = None
    ref_kf: int = -1
    frame_id: int = 0
    last_kf_frame_id: int = 0
    last_reloc_frame_id: int = -10**9
    on_new_keyframe = None  # callback(kf, bootstrap=False, frame=None), wired by System
    on_reset = None  # callback(), wired by System
    relocalizer = None  # callable(frame) -> (ok, Tcw, bind), wired by System
    # Backpressure hooks, wired by System in cooperative mode (the reference's
    # SetAcceptKeyFrames / InterruptBA protocol, Tracking.cc:719,755).
    mapping_idle = None  # callable() -> bool; None: always idle
    interrupt_ba = None  # callable() -> None
    # callable() -> bool: True while a loop closure is in flight, which pauses
    # keyframe insertion (the reference's mapper-stopped gate, Tracking.cc:719).
    # Wired by System to LoopCloser.closing_active, which, as in the reference
    # package, nothing raises yet.
    loop_closing_active = None
    # Localization-only mode (mbOnlyTracking): no keyframes, observations or
    # point statistics are written (Tracking.cc:699-700).
    only_tracking: bool = False
    trajectory: list = field(default_factory=list)
    loss_log: list = field(default_factory=list)  # (frame_id, reason) per loss
    timer: StageTimer = field(default_factory=StageTimer)
    reads: HostReads = field(default_factory=HostReads)
    lock: MapLock = field(default_factory=MapLock)  # the map lock, wired by System
    # The viewer's view of the last bootstrap attempt: its match (device
    # tensors, read only when drawn) and its current frame.
    _init_match_dev: object = None
    _init_cur_frame: object = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.camera = self.cfg.camera.to(self.device)
        self._build = make_frame_builder(self.cfg.orb, self.device)
        self._fused = tracking_fused.make_fused_tracker(self.cfg, self.reads, self.timer)
        self.reads.timer = self.timer
        self._prev_Tcw = None  # pose two frames back
        self._chain = None  # device-resident (bind, T, prevT, octave) chain
        # In flight: [(frame, fid, timestamp, announced packed, local_ids, anchor,
        # the mirror's pt_gen at dispatch)].
        self._pending = []
        self._anchor = 0  # raised by drop_in_flight: older results are stale
        # Frames a re-anchoring dropped, (frame, fid, timestamp), tracked
        # again before the next frame; _replay: whether the last drop keeps them.
        self._dropped = []
        self._replay = False
        self.stale_binds = 0  # bindings dropped because their slot held a new point
        # The last keyframe decision: (frame id, c1, c2, c3, c4, verdict), the
        # verdict one of "hold", "not_needed", "loop_closing", "refused", "insert".
        self.kf_check = None
        if self.sampler is None:
            self.sampler = GumbelSampler(seed=0, device=self.device)
        self._intr = torch.as_tensor(self.cfg.intr, device=self.device)
        i = self.cfg.intr
        self._K = torch.tensor([[i[0], 0, i[2]], [0, i[1], i[3]], [0, 0, 1]],
                               dtype=torch.float32, device=self.device)

    def set_timer(self, timer: StageTimer) -> None:
        """Use ``timer`` for the tracker's stages, the fused step's and the
        tracker's host reads (``host.read``)."""
        self.timer = self._fused.timer = self.reads.timer = timer

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
        self._replay_dropped()
        self._step(frame, fid, timestamp)
        self._replay_dropped()  # this frame, if a correction dropped it
        # Trajectory entries are recorded once per accepted frame, with the
        # frame's own timestamp, by the success paths; pipelined results lag.
        Tcw = self.last.Tcw if self.last is not None and self.state == TrackingState.OK else None
        return self.state, Tcw

    def _step(self, frame, fid, timestamp):
        """Run one frame through the state machine."""
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            with self.timer("trk.initialize"), self.lock:
                self._monocular_initialization(frame, fid, timestamp)
        elif self.state == TrackingState.OK:
            with self.timer("trk.track"):
                self._track_frame(frame, fid, timestamp)
        else:
            with self.timer("trk.relocalize"), self.lock:
                self._relocalize(frame, fid, timestamp)

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

    @property
    def last_init_match(self):
        """[N] init-reference feature -> current feature (-1 unmatched) of the
        last bootstrap attempt, read from the device when asked for (the
        viewer's initialization flow lines)."""
        if self._init_match_dev is None:
            return None
        ok, idx = (t.detach().cpu().numpy() for t in self._init_match_dev)
        return np.where(ok, idx, -1)

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
        self._init_match_dev = (match.ok, match.idx)
        self._init_cur_frame = frame
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
                                 timestamp=timestamp, n_inliers=len(pt_ids),
                                 gen=st.pt_gen.copy())
        self.ref_kf = k2
        self.last_kf_frame_id = fid
        self.velocity = None
        self._prev_Tcw = None
        self._chain = None
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
        if self.pipelined:
            self._track_frame_pipelined(frame, fid, timestamp)  # locks inside
            return
        with self.lock:
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
                                 timestamp=timestamp, n_inliers=n_inl,
                                 gen=self.store.pt_gen.copy())
        self._record_trajectory(timestamp, fid, Tcw)
        if self._need_new_keyframe(n_inl, fid):
            self._create_new_keyframe(frame, fid, timestamp, bind)

    def _fused_snapshot(self, host_bind):
        """The map state a fused step reads (under the map lock): the mirror's
        tensors, the reference keyframe and the local-map candidates chosen
        from ``host_bind``, the newest applied binding."""
        with self.timer("trk.local_select"):
            local_ids, local_valid = self._local_candidates(host_bind)
        mir = self.mirror
        mirror = (mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal, mir.pt_min_dist,
                  mir.pt_max_dist, mir.kf_desc, mir.kf_angle, mir.kf_obs_point)
        ref_ok = self.ref_kf >= 0 and bool(self.store.kf_valid[self.ref_kf])
        return mirror, max(self.ref_kf, 0), ref_ok, local_ids, local_valid

    def _dispatch_fused(self, frame, last_T, prev_T, last_bind, last_octave, has_vel, snap):
        """Run the fused step on a snapshot (:meth:`_fused_snapshot`). The
        chain inputs are device tensors."""
        mirror, ref, ref_ok, local_ids, local_valid = snap
        out = self._fused(*mirror, frame, self.camera, self._intr, last_T, prev_T, last_bind,
                          last_octave, ref, ref_ok, self._dev(local_ids), self._dev(local_valid),
                          has_vel)
        return out, local_ids

    def _fresh(self, ids: np.ndarray, gen: np.ndarray):
        """Point ids taken when the slots' allocation counts were ``gen``:
        True where the slot still holds that point (a culled slot may since
        hold a new point; the reference's MapPoint pointers cannot alias)."""
        c = np.clip(ids, 0, None)
        return (ids < 0) | (self.store.pt_gen[c] == gen[c])

    def _host_result(self, packed: np.ndarray, local_ids, gen=None):
        """Unpack a fused result and count its point statistics. Returns
        (pre_ok, Tcw, bind, n_localmap_inliers, unpacked). ``gen``: the
        mirror's pt_gen the step ran on, for a result read after the map
        moved on."""
        host = tracking_fused.unpack_result(packed, self.cfg.orb.n_features,
                                            self.cfg.th.max_local_points)
        if not host["pre_ok"]:
            return False, None, None, 0, host
        st = self.store
        bind = host["bind"].astype(np.int64)
        visible = local_ids[host["visible"]]
        if gen is not None:  # points culled and their slots refilled since the dispatch
            fresh = self._fresh(bind, gen)
            self.stale_binds += int((~fresh).sum())
            bind = np.where(fresh, bind, -1)
            visible = visible[self._fresh(visible, gen)]
        # Binds may reference points culled since the dispatch.
        bind = np.where((bind >= 0) & st.pt_valid[np.clip(bind, 0, None)], bind, -1)
        if not self.only_tracking:  # MapPoint::IncreaseVisible/Found
            st.pt_visible[visible] += 1
            st.pt_found[bind[bind >= 0]] += 1
        return True, host["Tcw"].astype(np.float32), bind, int(host["n_inliers"]), host

    def _track_frame_device(self, frame):
        """One fused step and one read of its packed result. Returns
        (pre_ok, Tcw, bind, n_localmap_inliers)."""
        has_vel = self.velocity is not None and self.last is not None
        prev = self._prev_Tcw if self._prev_Tcw is not None else self.last.Tcw
        out, local_ids = self._dispatch_fused(
            frame, self._dev(self.last.Tcw.astype(np.float32)),
            self._dev(prev.astype(np.float32)), self._dev(self.last.bind.astype(np.int64)),
            self.last.data.feats.octave, has_vel, self._fused_snapshot(self.last.bind))
        return self._host_result(self.reads.numpy(out["packed"]), local_ids)[:4]

    # ------------------------------------------------------------------ #
    # pipelined frame path: dispatch frame N, apply frame N - depth
    # ------------------------------------------------------------------ #
    def _track_frame_pipelined(self, frame, fid, timestamp):
        """Dispatch this frame's fused step on the device chain, then apply
        the results that fall out of the pipeline's depth. The step's inputs
        are taken under the map lock and the step runs outside it (its
        motion-search retry reads the device); a re-anchoring meanwhile
        drops the frame with the chain it extended."""
        with self.lock:
            anchor = self._anchor
            ch = self._chain
            gen = self.mirror.pt_gen  # the point slots' allocations this step sees
            bind = self.last.bind
            if self.last.gen is not None:
                bind = np.where(self._fresh(bind, self.last.gen), bind, -1)
            if ch is None:  # first pipelined frame after initialization or relocalization
                prev = self._prev_Tcw if self._prev_Tcw is not None else self.last.Tcw
                ch = dict(bind=self._dev(bind.astype(np.int64)),
                          T=self._dev(self.last.Tcw.astype(np.float32)),
                          prevT=self._dev(prev.astype(np.float32)),
                          octave=self.last.data.feats.octave, has_vel=self.velocity is not None)
            else:
                # The chain's binding was made on an older mirror: drop the
                # points whose slots were refilled since.
                refilled = (gen != ch["gen"]) & (ch["gen"] > 0)
                if refilled.any():
                    b = ch["bind"]
                    hit = self._dev(refilled)[b.clamp(min=0)] & (b >= 0)
                    ch = dict(ch, bind=torch.where(hit, torch.full_like(b, -1), b))
            snap = self._fused_snapshot(bind)
        out, local_ids = self._dispatch_fused(frame, ch["T"], ch["prevT"], ch["bind"],
                                              ch["octave"], ch["has_vel"], snap)
        packed = transfer.announce(out["packed"])
        with self.lock:
            if anchor != self._anchor:
                self._keep_dropped(frame, fid, timestamp)
                return
            self._chain = dict(bind=out["bind"], T=out["Tcw"], prevT=ch["T"],
                               octave=frame.feats.octave, has_vel=True, gen=gen)
            self._pending.append((frame, fid, timestamp, packed, local_ids, anchor, gen))
            # Young maps track on a short leash: right after initialization the
            # map covers a narrow view cone and every frame of lag delays the
            # keyframes that extend it. Full depth once the map has 8 keyframes.
            depth = PIPELINE_DEPTH if self.store.n_keyframes() >= 8 else 1
        # Drain to the target depth, so a shrinking depth contracts the backlog.
        while (entry := self._pop_pending(max(1, depth))) is not None:
            self._apply_result(*entry)
            if self.state != TrackingState.OK:
                # The chain is poisoned: every frame in flight tracked against
                # a lost pose. Discard them and let the state machine recover
                # (the frames waiting to be tracked again stay queued).
                self._discard_in_flight()
                break

    def _apply_result(self, frame, fid, timestamp, packed, local_ids, anchor, gen):
        """Read one announced fused result, then, under the map lock, run the
        state machine's tail for its frame (a stale result is discarded)."""
        with self.timer("trk.readback"):
            packed = transfer.fetch(packed, self.reads)
        with self.lock:
            if anchor != self._anchor:  # the frames in flight were dropped while this one was read
                self._keep_dropped(frame, fid, timestamp)
                return
            ok, Tcw, bind, n_inl, host = self._host_result(packed, local_ids, gen)
            if not ok:
                self._mark_lost(frame, fid, timestamp, self.last.Tcw,
                                info=f"pre_fail n_pre={host['n_pre']} "
                                     f"motion={host['used_motion']}")
                return
            self._finish_frame(frame, fid, timestamp, Tcw, bind, n_inl)

    def _pop_pending(self, keep: int = 0):
        """The oldest frame in flight while more than ``keep`` are, else None."""
        with self.lock:
            return self._pending.pop(0) if len(self._pending) > keep else None

    def drop_in_flight(self, replay: bool = False):
        """Discard the frames in flight and the device chain: the next frame
        starts a new chain from the last applied pose. With ``replay`` (a
        loop correction's re-anchoring) the dropped frames, and a frame whose
        dispatch or read straddles the drop, are kept and tracked again from
        the remapped pose before the next frame (:meth:`_replay_dropped`);
        without it, the frames kept by an earlier drop are forgotten too."""
        with self.lock:
            self._dropped = self._dropped + [e[:3] for e in self._pending] if replay else []
            self._replay = replay
            self._discard_in_flight()

    def _discard_in_flight(self):
        """Discard the frames in flight and the device chain, keeping the
        frames queued to be tracked again."""
        with self.lock:
            self._pending.clear()
            self._chain = None
            self._anchor += 1

    def _keep_dropped(self, frame, fid, timestamp):
        """A frame the last drop caught between its dispatch and its tail
        (under the map lock): kept for the replay if the drop keeps frames."""
        if self._replay:
            self._dropped.append((frame, fid, timestamp))

    def _replay_dropped(self):
        """Track the frames a re-anchoring dropped, oldest first, each through
        the state machine as a new frame would go: while tracking holds, each
        is dispatched on the new chain from the remapped pose, so that the
        first of them is predicted one frame ahead of the last one applied;
        once one is lost, the rest relocalize. The reference's tracker never
        skips a frame: it waits on the map mutex over CorrectLoop."""
        while True:
            with self.lock:
                if not self._dropped:
                    return
                self._dropped.sort(key=lambda e: e[1])
                frame, fid, timestamp = self._dropped.pop(0)
            self._step(frame, fid, timestamp)

    def flush(self):
        """Apply the frames in flight (end of stream, mode switch), the
        frames a re-anchoring dropped included."""
        while True:
            self._replay_dropped()
            while (entry := self._pop_pending()) is not None:
                self._apply_result(*entry)
                if self.state != TrackingState.OK:
                    self._discard_in_flight()
            with self.lock:
                if not self._dropped:
                    self._chain = None
                    return

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

    def _track_local_map(self, frame, Tcw, bind):
        """TrackLocalMap against a host-chosen local point set (after a
        relocalization): one unfused search and solve, one read."""
        st = self.store
        th = self.cfg.th
        local_pts, _ = self._local_point_ids(bind)
        P = th.max_local_points
        ids = np.zeros(P, np.int64)
        valid = np.zeros(P, bool)
        m = min(len(local_pts), P)
        ids[:m] = local_pts[:m]
        # Points already bound to this frame are skipped (Tracking.cc:795).
        valid[:m] = ~np.isin(ids[:m], bind[bind >= 0])
        prev_bound = bind >= 0
        d = self._dev
        T, lbind, inlier, n, visible = tk.track_points(
            d(Tcw.astype(np.float32)), d(st.pt_xyz[ids]), d(st.pt_desc[ids]),
            d(valid & st.pt_valid[ids]), torch.zeros(P, dtype=torch.int32, device=self.device),
            d(st.pt_normal[ids]), d(st.pt_min_dist[ids]), d(st.pt_max_dist[ids]), d(prev_bound),
            d(st.pt_xyz[np.clip(bind, 0, None)].astype(np.float32)), d(prev_bound),
            frame, self.camera, self._intr, th.localmap_search_radius,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            use_frustum=True, ratio=0.8)
        T, lbind, inlier, n, visible = self.reads.numpy_all((T, lbind, inlier, n, visible))
        new_bind = np.where(lbind >= 0, ids[np.clip(lbind, 0, None)],
                            np.where(prev_bound & inlier, bind, -1))
        if not self.only_tracking:  # MapPoint::IncreaseVisible/Found
            st.pt_visible[ids[visible & valid]] += 1
            st.pt_found[new_bind[new_bind >= 0]] += 1
        return T, new_bind, int(n)

    # ------------------------------------------------------------------ #
    # keyframe decision / creation (Tracking.cc:697-779)
    # ------------------------------------------------------------------ #
    def _need_new_keyframe(self, n_inl, fid):
        th = self.cfg.th
        st = self.store
        if self.only_tracking or self.ref_kf < 0:
            return False
        # Fresh relocalization: hold off insertion for one max-frames window
        # once the map is mature (Tracking.cc:709-710).
        if fid < self.last_reloc_frame_id + th.kf_max_frames and st.n_keyframes() > th.kf_max_frames:
            self.kf_check = (fid, False, False, False, False, "hold")
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
        flags = (fid, bool(c1), bool(c2), bool(c3), bool(c4))
        if not (c1 or c2 or c3 or c4):
            self.kf_check = (*flags, "not_needed")
            return False
        if self.loop_closing_active is not None and self.loop_closing_active():
            self.kf_check = (*flags, "loop_closing")
            return False
        # Backpressure (Tracking.cc:719,749-760): a keyframe goes in only while
        # local mapping accepts one; otherwise interrupt its BA and retry.
        if self.mapping_idle is None or self.mapping_idle():
            self.kf_check = (*flags, "insert")
            return True
        self.kf_check = (*flags, "refused")
        if self.interrupt_ba is not None:
            self.interrupt_ba()
        return False

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

    # ------------------------------------------------------------------ #
    def _relocalize(self, frame, fid, timestamp):
        """LOST: relocalize against the keyframe database (Tracking.cc:969),
        then track the local map from the recovered pose."""
        if self.relocalizer is None:
            return
        ok, Tcw, bind = self.relocalizer(frame)
        if not ok:
            return
        self.last = TrackedFrame(data=frame, Tcw=Tcw, bind=bind, frame_id=fid,
                                 timestamp=timestamp, gen=self.store.pt_gen.copy())
        Tcw2, bind2, n = self._track_local_map(frame, Tcw, bind)
        if n < self.cfg.th.min_localmap_inliers:
            return
        self.last.Tcw, self.last.bind = Tcw2, bind2
        self.velocity = None
        self._prev_Tcw = None
        self._chain = None
        self.last_reloc_frame_id = fid
        # The matched keyframe becomes the reference: the fallback path
        # tracks against ref_kf, and a stale pre-loss reference makes the
        # next frames fail and re-lose.
        rk = self.relocalizer.last_reloc_kf
        if rk >= 0 and self.store.kf_valid[rk]:
            self.ref_kf = int(rk)
        self.state = TrackingState.OK
        self._record_trajectory(timestamp, fid, self.last.Tcw)

    def reset(self):
        """Full tracker reset (Tracking::Reset, Tracking.cc:1133-1175)."""
        with self.lock:
            self.state = TrackingState.NO_IMAGES_YET
            self.last = None
            self.init_ref = None
            self.velocity = None
            self._prev_Tcw = None
            self.drop_in_flight()
            self.ref_kf = -1
            self.last_kf_frame_id = 0
            self.store.__post_init__()  # clear all map arrays
            if self.on_reset is not None:
                self.on_reset()
