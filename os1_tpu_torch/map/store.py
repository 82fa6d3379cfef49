"""Struct-of-arrays map store, host numpy. Port (a copy) of
os1_tpu/map/store.py, the replacement for the reference's pointer-graph map
model (Map / KeyFrame / MapPoint, reference Map.h:153-156).

  * keyframes  -> slots [K]: pose, per-feature arrays [K, N], liveness mask
  * map points -> slots [P]: position, distinctive descriptor, normal,
                  scale-invariance range, tracking stats, liveness mask
  * observations (KF, feature) <-> point are stored both ways:
    kf_obs_point [K, N] and pt_obs_kf / pt_obs_feat [P, M].
  * covisibility is recomputed on demand from the observation table.

Descriptors are held as uint32 here, as in the reference; the device mirror
(map/mirror.py) views them as int32. The store stays on the host; per-frame
device programs read the mirror.

Every method that tracking and synchronous local mapping call is ported:
allocation, observations both ways, point and keyframe culling, point
replacement, the spanning tree and its repair, covisibility and the derived
point state.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native


@dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    n_features: int = 1024  # feature slots per keyframe (== OrbConfig.n_features)
    max_obs_per_point: int = 16


@dataclass
class MapStore:
    cfg: MapConfig

    # --- keyframes ---
    kf_T: np.ndarray = field(init=False)  # [K, 4, 4] Tcw
    kf_valid: np.ndarray = field(init=False)  # [K] bool
    kf_frame_id: np.ndarray = field(init=False)  # [K] int64 source frame id
    kf_timestamp: np.ndarray = field(init=False)  # [K] float64
    kf_xy: np.ndarray = field(init=False)  # [K, N, 2] undistorted keypoint coords
    kf_angle: np.ndarray = field(init=False)  # [K, N]
    kf_octave: np.ndarray = field(init=False)  # [K, N] int32
    kf_desc: np.ndarray = field(init=False)  # [K, N, 8] uint32
    kf_feat_valid: np.ndarray = field(init=False)  # [K, N] bool
    kf_obs_point: np.ndarray = field(init=False)  # [K, N] int32, -1 = unbound
    # Monotonic insertion sequence number per keyframe slot (the reference's
    # ever-increasing KeyFrame::mnId): slot ids recycle after culls, so any
    # "how many keyframes ago" arithmetic must use this, not the slot id.
    kf_seq: np.ndarray = field(init=False)  # [K] int64
    # Spanning tree (KeyFrame::mpParent/mspChildrens, KeyFrame.h:862,887):
    # parent keyframe id per keyframe, -1 for roots. Children are derived
    # (kf_parent == k). Maintained by local mapping on first covisibility
    # update and repaired on culling (SetBadFlag reparenting).
    kf_parent: np.ndarray = field(init=False)  # [K] int32

    # --- map points ---
    pt_xyz: np.ndarray = field(init=False)  # [P, 3]
    pt_valid: np.ndarray = field(init=False)  # [P] bool
    pt_desc: np.ndarray = field(init=False)  # [P, 8] distinctive descriptor
    pt_normal: np.ndarray = field(init=False)  # [P, 3] mean viewing direction
    pt_min_dist: np.ndarray = field(init=False)  # [P] scale-invariance range
    pt_max_dist: np.ndarray = field(init=False)
    pt_obs_kf: np.ndarray = field(init=False)  # [P, M] int32, -1 pad
    pt_obs_feat: np.ndarray = field(init=False)  # [P, M] int32
    pt_n_obs: np.ndarray = field(init=False)  # [P] int32
    pt_visible: np.ndarray = field(init=False)  # [P] int32 (frustum appearances)
    pt_found: np.ndarray = field(init=False)  # [P] int32 (tracked appearances)
    # Creation age as the creating keyframe's monotonic kf_seq (NOT its slot
    # id: keyframe slots recycle, and dereferencing kf_seq through a
    # recycled slot would reclassify mature points as "recent" — the
    # found/visible cull would then kill them).
    pt_first_seq: np.ndarray = field(init=False)  # [P] int64 creating kf_seq
    pt_color: np.ndarray = field(init=False)  # [P, 3] uint8 (os1 colored points)
    pt_far: np.ndarray = field(init=False)  # [P] bool quasi-infinity flag
    # Far-point origin taxonomy (reference MapPoint::plOrigen,
    # MapPoint.h:404-444): 0 normal, 1 umbralCosBajo (low-parallax finite),
    # 2 umbralCos (quasi-infinity via the parallax gate), 3 svdInf.
    pt_far_class: np.ndarray = field(init=False)  # [P] uint8

    def __post_init__(self):
        # Epoch counter: bumped every time the store is cleared (reset). A
        # mapping stage snapshots it with its inputs and drops a writeback
        # whose epoch no longer matches.
        self.epoch = getattr(self, "epoch", -1) + 1
        K, P, N, M = (
            self.cfg.max_keyframes,
            self.cfg.max_points,
            self.cfg.n_features,
            self.cfg.max_obs_per_point,
        )
        self.kf_T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_id = np.zeros(K, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_obs_point = np.full((K, N), -1, np.int32)
        self.kf_seq = np.zeros(K, np.int64)
        self._kf_seq_next = 0
        self.kf_parent = np.full(K, -1, np.int32)

        # Trajectory-anchor links for culled keyframes (the reference's
        # KeyFrame::mTcp saved at SetBadFlag, KeyFrame.cc:595): (slot, seq) ->
        # (parent_slot, parent_seq, T_child_wrt_parent), so a frame whose
        # reference keyframe was culled is walked to a live ancestor.
        self.culled_links = {}

        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_desc = np.zeros((P, 8), np.uint32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.full(P, np.inf, np.float32)
        self.pt_obs_kf = np.full((P, M), -1, np.int32)
        self.pt_obs_feat = np.full((P, M), -1, np.int32)
        self.pt_n_obs = np.zeros(P, np.int32)
        self.pt_visible = np.zeros(P, np.int32)
        self.pt_found = np.zeros(P, np.int32)
        self.pt_first_seq = np.zeros(P, np.int64)
        self.pt_color = np.zeros((P, 3), np.uint8)
        self.pt_far = np.zeros(P, bool)
        self.pt_far_class = np.zeros(P, np.uint8)
        # Allocations per slot: a slot id with its generation names one point,
        # so a binding taken before a cull can tell the slot's next point
        # from its own (the tracker's frames in flight, tracking.py).
        self.pt_gen = np.zeros(P, np.int64)

    # ------------------------------------------------------------------ #
    # allocation / lifecycle
    # ------------------------------------------------------------------ #
    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def alloc_keyframe(self) -> int:
        # Keyframes stay lowest-first: keyframe ids are age-ordered by
        # construction and several structures rely on that (spanning-tree
        # parents predate children, gauge = min id, GBA propagation order).
        # The ABA window that motivates ring allocation for points is not
        # present: culled keyframe slots are not referenced by device-chained
        # arrays, and consumers re-check kf_valid under the map lock.
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        k = int(free[0])
        self.kf_valid[k] = True
        return k

    def alloc_points(self, count: int) -> np.ndarray:
        free = self._alloc_ring(self.pt_valid, "_pt_cursor", count)
        if free is None:
            raise RuntimeError("map point capacity exhausted")
        self.pt_valid[free] = True
        self.pt_gen[free] += 1
        return free

    def _alloc_ring(self, valid: np.ndarray, cursor_attr: str, count: int):
        """Allocate `count` free slots scanning ring-wise from a rotating
        cursor (NOT lowest-first). Rationale: slot ids double as identities
        in device-chained bind arrays and worker queues; lowest-first
        allocation reuses a just-culled slot immediately, so an in-flight
        frame's binding silently points at a DIFFERENT new point whose
        validity bit is set again (the ABA the reference cannot have,
        because its identities are MapPoint pointers and dead objects keep
        isBad, MapPoint.cc:184-199). The rotating cursor makes the reuse
        distance ~the full capacity (16k allocations for points), far
        beyond any in-flight window."""
        cur = getattr(self, cursor_attr, 0)
        n = len(valid)
        order = np.concatenate([np.arange(cur, n), np.arange(0, cur)])
        free = order[~valid[order]][:count]
        if len(free) < count:
            return None
        if count:  # an empty request leaves the cursor
            setattr(self, cursor_attr, int(free[-1] + 1) % n)
        return free

    def add_keyframe(self, Tcw, feats_xy, feats_angle, feats_octave, feats_desc,
                     feats_valid, frame_id=0, timestamp=0.0) -> int:
        """Insert a keyframe from frame feature arrays. Returns its id."""
        k = self.add_keyframe_pending(Tcw, frame_id=frame_id, timestamp=timestamp)
        self.materialize_keyframe(
            k, feats_xy, feats_angle, feats_octave, feats_desc, feats_valid
        )
        return k

    def add_keyframe_pending(self, Tcw, frame_id=0, timestamp=0.0) -> int:
        """Allocate a keyframe slot with pose/id/bindings only; the feature
        arrays follow via :meth:`materialize_keyframe` (on the mapping worker
        — the reference also defers the per-feature bookkeeping to
        LocalMapping::ProcessNewKeyFrame, LocalMapping.cc:125-153, so the
        tracking thread never blocks on a device readback)."""
        k = self.alloc_keyframe()
        self.kf_seq[k] = self._kf_seq_next
        self._kf_seq_next += 1
        self.kf_T[k] = np.asarray(Tcw, np.float32)
        self.kf_feat_valid[k] = False
        self.kf_obs_point[k] = -1
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        return k

    def materialize_keyframe(self, k, feats_xy, feats_angle, feats_octave,
                             feats_desc, feats_valid) -> None:
        """Fill a pending keyframe's feature arrays (host side)."""
        self.kf_xy[k] = np.asarray(feats_xy, np.float32)
        self.kf_angle[k] = np.asarray(feats_angle, np.float32)
        self.kf_octave[k] = np.asarray(feats_octave, np.int32)
        self.kf_desc[k] = np.asarray(feats_desc, np.uint32)
        self.kf_feat_valid[k] = np.asarray(feats_valid, bool)

    def add_observation(self, pt: int, kf: int, feat: int) -> None:
        """Bind point <-> (kf, feature) both ways (MapPoint::AddObservation +
        Frame::mvpMapPoints assignment). Dead points are never bound."""
        if not self.pt_valid[pt]:
            return
        if self.kf_obs_point[kf, feat] == pt:
            return
        slot = self.pt_n_obs[pt]
        if slot >= self.cfg.max_obs_per_point:
            return  # observation table full: drop (rare; oldest stay)
        self.pt_obs_kf[pt, slot] = kf
        self.pt_obs_feat[pt, slot] = feat
        self.pt_n_obs[pt] += 1
        self.kf_obs_point[kf, feat] = pt

    def add_observations(self, pts, kfs, feats) -> None:
        """Bind many (point, kf, feature) triples both ways in one vectorized
        pass (MapPoint::AddObservation + Frame::mvpMapPoints assignment, in
        call order). Dead points are never bound; a full observation table
        drops the extra observations."""
        pts = np.asarray(pts, np.int64)
        kfs = np.asarray(kfs, np.int64)
        feats = np.asarray(feats, np.int64)
        if len(pts) == 0:
            return
        keep = self.pt_valid[pts] & (self.kf_obs_point[kfs, feats] != pts)
        pts, kfs, feats = pts[keep], kfs[keep], feats[keep]
        if len(pts) == 0:
            return
        # Slot assignment: current fill level + running offset for points
        # appearing multiple times within this batch.
        order = np.argsort(pts, kind="stable")
        ps, ks, fs = pts[order], kfs[order], feats[order]
        idx = np.arange(len(ps))
        first = np.concatenate([[True], ps[1:] != ps[:-1]])
        run_start = np.maximum.accumulate(np.where(first, idx, 0))
        slot = self.pt_n_obs[ps] + (idx - run_start)
        ok = slot < self.cfg.max_obs_per_point  # table full: drop (rare)
        ps, ks, fs, slot = ps[ok], ks[ok], fs[ok], slot[ok]
        self.pt_obs_kf[ps, slot] = ks
        self.pt_obs_feat[ps, slot] = fs
        np.add.at(self.pt_n_obs, ps, 1)
        self.kf_obs_point[ks, fs] = ps

    def remove_observation(self, pt: int, kf: int) -> None:
        """Unbind a point from a keyframe (MapPoint::EraseObservation)."""
        slots = self.pt_obs_kf[pt] == kf
        for s in np.nonzero(slots)[0]:
            f = self.pt_obs_feat[pt, s]
            if f >= 0 and self.kf_obs_point[kf, f] == pt:
                self.kf_obs_point[kf, f] = -1
        keep = ~slots
        kfs = self.pt_obs_kf[pt][keep]
        fts = self.pt_obs_feat[pt][keep]
        self.pt_obs_kf[pt] = -1
        self.pt_obs_feat[pt] = -1
        self.pt_obs_kf[pt, : len(kfs)] = kfs
        self.pt_obs_feat[pt, : len(fts)] = fts
        self.pt_n_obs[pt] = int((kfs >= 0).sum())  # the caller decides culling

    def remove_observations(self, pts, kfs) -> None:
        """Batched :meth:`remove_observation` over (point, keyframe) pairs —
        the post-BA outlier erase (Optimizer.cc:520-556) calls this once with
        every outlier observation instead of looping."""
        pts = np.asarray(pts, np.int64)
        kfs = np.asarray(kfs, np.int64)
        if len(pts) == 0:
            return
        upts, inv = np.unique(pts, return_inverse=True)
        M = self.cfg.max_obs_per_point
        row_kf = self.pt_obs_kf[upts]  # [n, M]
        rem = np.zeros((len(upts), M), bool)
        np.logical_or.at(rem, inv, row_kf[inv] == kfs[:, None])
        # Unbind the keyframe-side feature slots that point back at us.
        row_ft = self.pt_obs_feat[upts]
        kf_c = np.clip(row_kf, 0, None)
        ft_c = np.clip(row_ft, 0, None)
        mine = rem & (row_ft >= 0) & (self.kf_obs_point[kf_c, ft_c] == upts[:, None])
        self.kf_obs_point[kf_c[mine], ft_c[mine]] = -1
        # Compact each affected row: keep slots first, in stable order.
        order = np.argsort(rem, axis=1, kind="stable")  # False (keep) first
        self.pt_obs_kf[upts] = np.where(
            np.take_along_axis(rem, order, 1), -1, np.take_along_axis(row_kf, order, 1)
        )
        self.pt_obs_feat[upts] = np.where(
            np.take_along_axis(rem, order, 1), -1, np.take_along_axis(row_ft, order, 1)
        )
        self.pt_n_obs[upts] = ((self.pt_obs_kf[upts] >= 0)).sum(1)

    def cull_points(self, ids: np.ndarray) -> None:
        """SetBadFlag for a batch of points: clear masks + unbind features
        (fully vectorized: one scatter over the observation table)."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        kfs = self.pt_obs_kf[ids]  # [n, M]
        fts = self.pt_obs_feat[ids]
        kf_c = np.clip(kfs, 0, None)
        ft_c = np.clip(fts, 0, None)
        mine = (kfs >= 0) & (fts >= 0) & (self.kf_obs_point[kf_c, ft_c] == ids[:, None])
        self.kf_obs_point[kf_c[mine], ft_c[mine]] = -1
        self.pt_valid[ids] = False
        self.pt_obs_kf[ids] = -1
        self.pt_obs_feat[ids] = -1
        self.pt_n_obs[ids] = 0
        self.pt_visible[ids] = 0
        self.pt_found[ids] = 0
        self.pt_far[ids] = False
        self.pt_far_class[ids] = 0

    def replace_point(self, loser: int, winner: int) -> None:
        """Merge ``loser`` into ``winner`` (MapPoint::Replace,
        MapPoint.cc:132-175): every observation of the loser moves to the
        winner unless the winner is already observed there; the loser dies.
        Tracking stats accumulate, as in the reference."""
        if loser == winner or not self.pt_valid[loser]:
            return
        for s in range(self.pt_n_obs[loser]):
            kf, f = int(self.pt_obs_kf[loser, s]), int(self.pt_obs_feat[loser, s])
            if kf < 0:
                continue
            if winner in self.kf_obs_point[kf]:
                # Winner already seen in this keyframe: just unbind.
                if self.kf_obs_point[kf, f] == loser:
                    self.kf_obs_point[kf, f] = -1
            else:
                self.kf_obs_point[kf, f] = -1
                self.add_observation(winner, kf, f)
        self.pt_found[winner] += self.pt_found[loser]
        self.pt_visible[winner] += self.pt_visible[loser]
        self.pt_valid[loser] = False
        self.pt_obs_kf[loser] = -1
        self.pt_obs_feat[loser] = -1
        self.pt_n_obs[loser] = 0

    def update_spanning_tree(self, kf: int) -> None:
        """Assign kf's parent on its first covisibility update: the
        strongest covisible keyframe (KeyFrame::UpdateConnections first-
        connection path, KeyFrame.cc:383-391). Roots keep parent = -1."""
        if self.kf_parent[kf] >= 0:
            return
        w = self.covisibility_weights(kf)
        # Parent must predate the child (acyclic by construction). Age is
        # kf_seq, not the slot id (culled slots are reallocated lowest-first)
        # and not the frame id (which can collide after a session merge).
        w[self.kf_seq >= self.kf_seq[kf]] = 0
        best = int(np.argmax(w))
        if w[best] > 0:
            self.kf_parent[kf] = best

    def children_of(self, kf: int) -> np.ndarray:
        return np.nonzero(self.kf_valid & (self.kf_parent == kf))[0]

    def _reparent_children(self, kf: int) -> None:
        """KeyFrame::SetBadFlag reparenting (KeyFrame.cc:499-585): each child
        adopts its strongest covisible among a growing candidate set seeded
        with the dying keyframe's parent; leftovers fall back to that parent."""
        children = set(int(c) for c in self.children_of(kf))
        if not children:
            return
        parent = int(self.kf_parent[kf])
        candidates = {parent} if parent >= 0 else set()
        while children and candidates:
            best_w, best_child, best_parent = 0, -1, -1
            for c in children:
                w = self.covisibility_weights(c)
                for cand in candidates:
                    if w[cand] > best_w:
                        best_w, best_child, best_parent = int(w[cand]), c, cand
            if best_child < 0:
                break
            self.kf_parent[best_child] = best_parent
            candidates.add(best_child)
            children.discard(best_child)
        for c in children:  # no covisibility with any candidate
            self.kf_parent[c] = parent

    def cull_keyframe(self, kf: int) -> None:
        """SetBadFlag for a keyframe: reparent its spanning-tree children,
        release its observations, free the slot (KeyFrame::SetBadFlag,
        KeyFrame.cc:478-613). The pose relative to the parent is saved
        (mTcp) so frame-trajectory anchors survive the cull."""
        self._reparent_children(kf)
        p = int(self.kf_parent[kf])
        if p < 0 or not self.kf_valid[p]:
            # Keyframes culled before their own mapping pass never received
            # a spanning-tree parent — assign the anchor now (strongest
            # older covisible; any covisible as a last resort) so the
            # trajectory walk does not dead-end in the pre-correction world.
            self.update_spanning_tree(kf)
            p = int(self.kf_parent[kf])
            if p < 0 or not self.kf_valid[p]:
                w = self.covisibility_weights(kf)
                p = int(np.argmax(w)) if w.max() > 0 else -1
        if p >= 0 and self.kf_valid[p]:
            T_cp = (self.kf_T[kf] @ np.linalg.inv(self.kf_T[p])).astype(
                np.float32
            )
            self.culled_links[(int(kf), int(self.kf_seq[kf]))] = (
                p, int(self.kf_seq[p]), T_cp,
            )
        pts = np.unique(self.kf_obs_point[kf][self.kf_obs_point[kf] >= 0])
        self.remove_observations(pts, np.full(len(pts), kf, np.int64))
        self.kf_valid[kf] = False
        self.kf_feat_valid[kf] = False
        self.kf_obs_point[kf] = -1
        self.kf_parent[kf] = -1

    # ------------------------------------------------------------------ #
    # derived structures
    # ------------------------------------------------------------------ #
    def covisibility_weights(self, kf: int) -> np.ndarray:
        """[K] number of map points shared with every other keyframe
        (KeyFrame::UpdateConnections weight counting, KeyFrame.cc:303-402).
        Far points are excluded, as in the reference (KeyFrame.cc:320)."""
        pts = self.kf_obs_point[kf]
        pts = pts[(pts >= 0)]
        pts = pts[self.pt_valid[pts] & ~self.pt_far[pts]]
        w = np.zeros(self.cfg.max_keyframes, np.int32)
        if len(pts) == 0:
            return w
        obs_kf = self.pt_obs_kf[pts]  # [n, M]
        flat = obs_kf[obs_kf >= 0]
        np.add.at(w, flat, 1)
        w[kf] = 0
        w[~self.kf_valid] = 0
        return w

    def covisible_keyframes(self, kf: int, min_weight: int = 15, top: int | None = None) -> np.ndarray:
        """Sorted (desc weight) covisible keyframe ids with weight >= min
        (reference th=15, KeyFrame.cc:341; falls back to the single best
        neighbor when none clears the threshold, as the reference does)."""
        w = self.covisibility_weights(kf)
        ids = np.nonzero(w >= min_weight)[0]
        if len(ids) == 0:
            best = int(np.argmax(w))
            ids = np.array([best]) if w[best] > 0 else np.array([], np.int64)
        order = np.argsort(-w[ids], kind="stable")
        ids = ids[order]
        return ids[:top] if top is not None else ids

    def update_point_derived(self, ids: np.ndarray, scale_factor: float, n_levels: int) -> None:
        """Recompute derived per-point state after observation changes:
        mean viewing normal + scale-invariance distances
        (MapPoint::UpdateNormalAndDepth, MapPoint.cc:315-356) and the
        distinctive descriptor (min-median-Hamming over observing features,
        MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:227-293).

        Fully vectorized over the id batch (runs per keyframe insertion)."""
        ids = np.asarray(ids, np.int64)
        ids = ids[self.pt_valid[ids] & (self.pt_n_obs[ids] > 0)]
        if len(ids) == 0:
            return
        M = self.cfg.max_obs_per_point
        kfs = self.pt_obs_kf[ids]  # [n, M]
        fts = self.pt_obs_feat[ids]
        live = (kfs >= 0) & self.kf_valid[np.clip(kfs, 0, None)]
        has_live = live.any(1)
        ids, kfs, fts, live = ids[has_live], kfs[has_live], fts[has_live], live[has_live]
        if len(ids) == 0:
            return
        kfs_c = np.clip(kfs, 0, None)
        fts_c = np.clip(fts, 0, None)

        # Camera centers of all keyframes (once).
        R = self.kf_T[:, :3, :3]
        t = self.kf_T[:, :3, 3]
        Ow = -np.einsum("kji,kj->ki", R, t)  # [K, 3]

        rays = self.pt_xyz[ids][:, None, :] - Ow[kfs_c]  # [n, M, 3]
        norms = np.linalg.norm(rays, axis=-1)
        norms = np.where(norms < 1e-9, 1e-9, norms)
        unit = rays / norms[..., None]
        w = live.astype(np.float32)
        cnt = np.maximum(w.sum(1), 1.0)
        self.pt_normal[ids] = (unit * w[..., None]).sum(1) / cnt[:, None]

        # Scale band from the latest live observation per point.
        slot_idx = np.where(live, np.arange(M)[None, :], -1)
        last = slot_idx.max(1)  # [n]
        last_c = np.clip(last, 0, None)
        rr = np.arange(len(ids))
        dist = norms[rr, last_c]
        octv = self.kf_octave[kfs_c[rr, last_c], fts_c[rr, last_c]]
        max_d = dist * (scale_factor ** octv.astype(np.float64))
        self.pt_max_dist[ids] = max_d
        self.pt_min_dist[ids] = max_d / (scale_factor ** (n_levels - 1))

        # Distinctive descriptor: min median Hamming among live observations
        # (MapPoint::ComputeDistinctiveDescriptors), in host C++
        # (csrc/native.cpp); native.distinctive_plain is its numpy form.
        descs = self.kf_desc[kfs_c, fts_c]  # [n, M, 8] uint32
        best = native.point_distinctive_desc(descs, live)
        self.pt_desc[ids] = descs[rr, np.clip(best, 0, None)]
