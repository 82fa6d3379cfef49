"""Local mapping back end: point culling, new-point triangulation, duplicate
fusion, local BA and keyframe culling. Port of the synchronous, mirror path of
os1_tpu/pipeline/local_mapping.py (the reference's LocalMapping thread,
LocalMapping.cc:46-110, run once per keyframe).

Each stage snapshots what it needs from the host store, runs its device
program against the device mirror (K8 triangulation, K9 fusion, K10 local BA),
reads the compacted result back once, and writes it into the store. The
stages are generators that yield between dispatch and read-back, as the
reference's are, so the cooperative scheduler (``workers.CoopScheduler``) can
interleave them with tracking; :meth:`LocalMapper.process` drains them in
order. The cooperative hooks are the BA abort flag, checked between the LM
chunks, and the queue-pressure gate of fusion and local BA.

With the worker threads on, each stage takes the map lock (``lock``, the
System's) for its snapshot of the host store and the mirror's tensors, and
again for its write-back; the uploads, the device work and the read of the
result come between the two, outside the lock (a publish writes new mirror
tensors, so the snapshot's stay as they were).

Global BA, which loop closing runs after every corrected loop, is here too:
:func:`assemble_global_ba` snapshots the whole map from the host store,
:func:`apply_global_ba` writes the solve back and carries its correction to
the keyframes and points created meanwhile, :func:`global_bundle_adjustment`
is both in one call.

With a mesh backend (``mesh_backend``, ``parallel.MeshBABackend``, wired by
System), local BA runs landmark-sharded over the mesh, one sum of the reduced
camera system per LM iteration; the chunks and the abort stay as they are.

Not ported: the host-upload (mirror-less) paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..map.mirror import DeviceMirror, to_device
from ..map.store import MapStore
from ..optim import BAProblem, ba_begin, ba_iterate, ba_reclassify, ba_result
from ..optim.ba_core import C_BUCKETS, P_BUCKETS
from ..utils.profiling import HostReads, StageTimer
from . import tracking_kernels as tk
from .config import SlamConfig
from .workers import MapLock

# Far-point origin classes of store.pt_far_class (the reference's plOrigen
# taxonomy, MapPoint.h:404-444); the same values as the JAX package's viewer.
FAR_NORMAL = 0  # ordinary triangulated point
FAR_LOWCOS = 1  # low-parallax triangulation (umbralCosBajo)
FAR_COS = 2  # routed to quasi-infinity by the parallax gate (umbralCos)
FAR_SVDINF = 3  # quasi-infinite solve (svdInf)
FAR_CLASS_NAMES = ("normal", "umbralCosBajo", "umbralCos", "svdInf")


def assemble_global_ba(store: MapStore, cfg: SlamConfig, device):
    """Snapshot the full-map BA problem (Optimizer::GlobalBundleAdjustemnt,
    Optimizer.cc:41-46: every live keyframe, every non-far point with two or
    more observations) onto ``device``. Returns (prob, meta), or None when
    the map is too small. The problem has the map's exact sizes (the
    reference pads them to compile buckets).

    Keyframes whose features are still on the device (not materialized) are
    left out, like keyframes made during the solve: :func:`apply_global_ba`
    moves them with their spanning-tree parent. (The reference keeps them as
    fixed cameras, so they stay put while their points move.)"""
    cams = [int(k) for k in np.nonzero(store.kf_valid & store.kf_feat_valid.any(axis=1))[0]]
    if len(cams) < 2:
        return None
    C = len(cams)
    cam_slot = {c: i for i, c in enumerate(cams)}
    pts = np.nonzero(store.pt_valid & ~store.pt_far & (store.pt_n_obs >= 2))[0]
    if len(pts) < 20:
        return None

    okf = store.pt_obs_kf[pts]
    oft = store.pt_obs_feat[pts]
    lookup = np.full(store.cfg.max_keyframes, -1, np.int64)
    lookup[cams] = np.arange(C)
    okf_c = np.clip(okf, 0, None)
    oft_c = np.clip(oft, 0, None)
    slots = lookup[okf_c]
    # Observations of keyframes whose feature arrays are not yet materialized
    # stay out (their zero kf_xy rows would read as measurements at pixel
    # (0, 0)): the keyframes are not cameras of the problem, and their
    # kf_feat_valid rows are all False.
    valid = (okf >= 0) & (slots >= 0) & store.kf_feat_valid[okf_c, oft_c]

    fixed = np.zeros(C, bool)
    # Gauge: the two oldest keyframes by insertion age (the reference fixes
    # keyframe 0 only; the second pins the monocular scale, as the reference
    # package measured a post-loop GBA rescale the map without it).
    by_age = sorted(cams, key=lambda c: int(store.kf_seq[c]))
    fixed[cam_slot[by_age[0]]] = True
    fixed[cam_slot[by_age[1]]] = True
    # A camera with (almost) no observations in the problem is unconstrained:
    # it stays at its pose.
    fixed |= np.bincount(slots[valid].ravel(), minlength=C) < 6

    d = lambda a: to_device(np.ascontiguousarray(a), device)  # noqa: E731
    prob = BAProblem(
        cam_T=d(store.kf_T[cams].astype(np.float32)), cam_fixed=d(fixed),
        points=d(store.pt_xyz[pts].astype(np.float32)), point_valid=d(np.ones(len(pts), bool)),
        obs_cam=d(np.where(valid, slots, 0)), obs_uv=d(store.kf_xy[okf_c, oft_c]),
        obs_sigma2=d(cfg.sigma2_table[store.kf_octave[okf_c, oft_c]]), obs_valid=d(valid),
        intr=torch.as_tensor(cfg.intr, device=device))
    meta = dict(cams=cams, cam_slot=cam_slot, pts=pts, okf=okf, valid=valid, fixed=fixed,
                old_T=store.kf_T[cams].copy(), epoch=store.epoch,
                cam_seq={c: int(store.kf_seq[c]) for c in cams})
    return prob, meta


def apply_global_ba(store: MapStore, cfg: SlamConfig, res, meta) -> None:
    """Write a global BA's result (numpy ``cam_T``, ``points``,
    ``obs_inlier``) back, and carry the correction through the spanning tree
    to the keyframes and points created while it solved (the reference's
    RunGlobalBundleAdjustment tail, LoopClosing.cc:690-750)."""
    if store.epoch != meta["epoch"]:
        return
    cams, cam_slot, fixed = meta["cams"], meta["cam_slot"], meta["fixed"]
    pts, okf = meta["pts"], meta["okf"]
    # A keyframe's identity is (slot, kf_seq): a slot culled during the solve
    # may hold a new keyframe, which must not take the old one's pose.
    cam_seq = meta["cam_seq"]
    still = {c for c in cams if store.kf_valid[c] and int(store.kf_seq[c]) == cam_seq[c]}
    in_prob_kf = np.zeros(store.cfg.max_keyframes, bool)
    in_prob_kf[list(still)] = True
    old_pose = {c: meta["old_T"][i] for c, i in cam_slot.items() if c in still}
    new_T = np.asarray(res.cam_T)

    # Keyframes inserted during the solve: the child's pose composed with its
    # parent's correction (LoopClosing.cc:690-720), in ascending age, since
    # parents predate children.
    corrected = {c: new_T[i] for c, i in cam_slot.items() if c in still}
    live = np.nonzero(store.kf_valid)[0]
    live = live[np.argsort(store.kf_seq[live], kind="stable")]
    for k in live:
        k = int(k)
        if in_prob_kf[k]:
            continue
        p = int(store.kf_parent[k])
        if p < 0 or (p not in corrected) or (p not in old_pose):
            continue
        T_rel = store.kf_T[k] @ np.linalg.inv(old_pose[p])
        corrected[k] = (T_rel @ corrected[p]).astype(np.float32)
        old_pose[k] = store.kf_T[k].copy()

    for k, T in corrected.items():
        if not (k in cam_slot and fixed[cam_slot[k]]) and store.kf_valid[k]:
            store.kf_T[k] = T

    # Points in the problem take their solved positions; points created during
    # the solve move with their first observer's correction
    # (LoopClosing.cc:724-748), one affine transform per observer.
    alive = store.pt_valid[pts]
    store.pt_xyz[pts[alive]] = np.asarray(res.points)[: len(pts)][alive]
    in_prob_pt = np.zeros(store.cfg.max_points, bool)
    in_prob_pt[pts] = True
    others = np.nonzero(store.pt_valid & ~in_prob_pt)[0]
    if len(others):
        refs = store.pt_obs_kf[others, 0]
        for ref in np.unique(refs):
            ref = int(ref)
            if ref < 0 or ref not in corrected or ref not in old_pose:
                continue
            sel = others[refs == ref]
            T_old, T_new = old_pose[ref], corrected[ref]
            xc = store.pt_xyz[sel] @ T_old[:3, :3].T + T_old[:3, 3]
            store.pt_xyz[sel] = (xc - T_new[:3, 3]) @ T_new[:3, :3]

    # Outlier observations erased, only against keyframes whose identity
    # survived.
    inl = np.asarray(res.obs_inlier)[: len(pts)]
    okf_still = np.isin(okf, list(still)) if still else np.zeros_like(okf, bool)
    out_i, out_s = np.nonzero(meta["valid"] & ~inl & alive[:, None] & okf_still)
    store.remove_observations(pts[out_i], okf[out_i, out_s])
    dead = pts[alive & (store.pt_n_obs[pts] < 2)]
    if len(dead):
        store.cull_points(dead)


def global_bundle_adjustment(store: MapStore, cfg: SlamConfig, device, iters: int = 20,
                             reads: HostReads | None = None) -> None:
    """Synchronous full-map BA: assemble, ``iters`` LM iterations, apply."""
    work = assemble_global_ba(store, cfg, device)
    if work is None:
        return
    prob, meta = work
    res = ba_result(prob, ba_iterate(prob, ba_begin(prob), iters))
    reads = reads if reads is not None else HostReads()
    res = res._replace(**dict(zip(("cam_T", "points", "obs_inlier"),
                                  reads.numpy_all((res.cam_T, res.points, res.obs_inlier)))))
    apply_global_ba(store, cfg, res, meta)


@dataclass
class LocalMapper:
    cfg: SlamConfig
    store: MapStore
    mirror: DeviceMirror
    timer: StageTimer = field(default_factory=StageTimer)
    reads: HostReads = field(default_factory=HostReads)
    # Tracker's live reference keyframe (wired by System): never culled.
    protected_kf_fn = None  # callable() -> int | None
    on_cull_keyframe = None  # callback(kf_id), wired by System (db.erase)
    # BA preemption (reference mbAbortBA, LocalMapping.cc:116): set when a new
    # keyframe wants in; checked between the LM chunks of local BA.
    abort_ba: bool = False
    ba_iters: int = 0  # local-BA LM iterations run (bench.py's local-BA iterations/s)
    # Queue-pressure probe, wired by System in cooperative mode: the reference
    # runs fusion and local BA only when no further keyframes wait
    # (LocalMapping.cc:72). The deferral is bounded: after cfg.th.ba_debt_max
    # deferred keyframes they run regardless.
    pending_fn = None  # callable() -> int
    # The keyframes waiting for their pass, wired by System to the threaded
    # worker's queue: keyframe culling spares them (see cull_keyframes).
    queued_fn = None  # callable() -> list of keyframe ids
    _ba_debt: int = 0
    # Finite triangulations with a parallax cosine above this are classed
    # umbralCosBajo (the reference's viewer trackbar, Viewer.cc:133 ->
    # LocalMapping.cc:202-204, set by System.set_far_parallax_param; 0.9998
    # disables the band).
    far_cos_user: float = 0.9998
    lock: MapLock = field(default_factory=MapLock)  # the map lock, wired by System
    # Distributed solver backend (parallel.MeshBABackend), wired by System
    # when a mesh is active: local BA runs landmark-sharded over it
    # (BASELINE.json config 4). None: the single-device protocol.
    mesh_backend: object = None

    # Fusion targets: 20 first-ring + 5x5 second-ring covisible keyframes.
    _T_FUSE = 46

    def __post_init__(self):
        dev = self.mirror.device
        i = self.cfg.intr
        self._K = torch.tensor([[i[0], 0, i[2]], [0, i[1], i[3]], [0, 0, 1]],
                               dtype=torch.float32, device=dev)
        self._intr = torch.as_tensor(i, device=dev)
        self._sigma2 = torch.as_tensor(self.cfg.sigma2_table, device=dev)

    def _ba_fns(self):
        """(shard, begin, iterate, reclassify, result): the resumable BA
        protocol, single-device or mesh-sharded."""
        be = self.mesh_backend
        if be is None:
            return lambda p: p, ba_begin, ba_iterate, ba_reclassify, ba_result
        return be.shard, be.begin, be.iterate, be.reclassify, be.result

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.mirror.device)

    def warmup(self) -> None:
        """Run once every device program this mapper launches, on zero
        inputs at the port's shapes: the local BA's begin, iterate,
        reclassify and result and the mirror's BA assembly at every (P, C)
        bucket, the triangulation batch and the pair fusion. On a card that
        pays the first launch of each program, the library handles and the
        caching allocator's first growth at each bucket before the first
        keyframe; the store, the mirror and ``ba_iters`` are left as they
        were."""
        cfg, st, mir = self.cfg, self.store, self.mirror
        dev = mir.device
        N, M = cfg.orb.n_features, st.cfg.max_obs_per_point
        NB, K = cfg.th.triangulation_neighbors, st.cfg.max_keyframes
        eye = torch.eye(4, device=dev)
        shard, begin, iterate, reclassify, result = self._ba_fns()
        rows = (mir.pt_xyz, mir.pt_obs_kf, mir.pt_obs_feat, mir.kf_xy, mir.kf_octave,
                mir.kf_feat_valid)
        for P_pad in P_BUCKETS:
            obs = tk.assemble_ba_mirror(
                *rows, torch.zeros(P_pad, dtype=torch.int64, device=dev),
                torch.zeros(P_pad, dtype=torch.bool, device=dev),
                torch.full((K,), -1, dtype=torch.int64, device=dev), self._sigma2)
            for C_pad in C_BUCKETS:
                fixed = torch.zeros(C_pad, dtype=torch.bool, device=dev)
                fixed[0] = True
                points = torch.ones(P_pad, 3, device=dev)
                points[:, 2] = 5.0
                prob = BAProblem(
                    cam_T=eye.expand(C_pad, 4, 4).clone(), cam_fixed=fixed, points=points,
                    point_valid=torch.ones(P_pad, dtype=torch.bool, device=dev),
                    obs_cam=torch.zeros(P_pad, M, dtype=torch.int64, device=dev),
                    obs_uv=torch.full((P_pad, M, 2), 320.0, device=dev),
                    obs_sigma2=torch.ones(P_pad, M, device=dev),
                    obs_valid=torch.zeros(P_pad, M, dtype=torch.bool, device=dev),
                    intr=self._intr)
                prob = shard(prob)
                state = reclassify(prob, iterate(prob, begin(prob), 5))
                self.reads.numpy_all(result(prob, state)[:1] + obs[:1])
        tri = tk.triangulate_mirror_batch(
            eye, eye.expand(NB, 4, 4).clone(), 0,
            torch.zeros(NB, dtype=torch.int64, device=dev), mir.kf_xy, mir.kf_angle,
            mir.kf_octave, mir.kf_desc, torch.zeros(N, dtype=torch.bool, device=dev),
            torch.zeros(NB, N, dtype=torch.bool, device=dev), self._K, self._sigma2,
            torch.full((), 5.0, device=dev), enable_far=cfg.enable_far_points)
        L = 2 * self._T_FUSE
        lanes = torch.zeros(L, dtype=torch.int64, device=dev)
        fuse = tk.fuse_pairs_mirror(
            eye.expand(L, 4, 4).clone(), lanes, lanes, mir.kf_xy, mir.kf_angle, mir.kf_octave,
            mir.kf_desc, mir.kf_feat_valid, mir.kf_obs_point, mir.pt_xyz, mir.pt_desc,
            mir.pt_max_dist, mir.pt_valid, mir.pt_obs_kf, self._intr, float(cfg.camera.width),
            float(cfg.camera.height), cfg.orb.scale_factor, n_levels=cfg.orb.n_levels)
        self.reads.numpy_all((tri[0], fuse))

    def _publish(self) -> None:
        """Push the changed map state to the device mirror."""
        self.mirror.refresh_dynamic()

    def process(self, kf: int, bootstrap: bool = False) -> None:
        """Full local-mapping pass for a newly inserted keyframe
        (LocalMapping::Run body, LocalMapping.cc:58-88)."""
        for _ in self.process_steps(kf, bootstrap=bootstrap):
            pass

    def process_steps(self, kf: int, bootstrap: bool = False):
        """The pass as a generator that yields at every dispatch -> result
        boundary."""
        if bootstrap:
            return  # the initial map was just globally optimized
        with self.timer("lm.cull_points"), self.lock:
            # First covisibility update assigns the spanning-tree parent
            # (KeyFrame::UpdateConnections, KeyFrame.cc:383-391).
            self.store.update_spanning_tree(kf)
            self.cull_recent_points(kf)
            self._publish()
        yield from self.create_new_points_steps(kf)
        self._ba_debt += 1
        debt_max = self.cfg.th.ba_debt_max
        forced = debt_max > 0 and self._ba_debt >= debt_max
        if not forced and self.pending_fn is not None and self.pending_fn():
            return  # more keyframes wait: the heavy stages run when the queue drains
        yield from self.search_in_neighbors_steps(kf)
        if not forced and self.pending_fn is not None and self.pending_fn():
            return
        self._ba_debt = 0
        yield from self.local_ba_steps(kf)
        with self.timer("lm.cull_kfs"), self.lock:
            self.cull_keyframes(kf)
            self._publish()

    # ------------------------------------------------------------------ #
    def cull_recent_points(self, kf: int) -> None:
        """MapPointCulling (LocalMapping.cc:155-186): drop recent points with a
        poor found/visible ratio, or with too few observations two keyframes
        after their creation. Age is in keyframe insertions (kf_seq), since
        slot ids recycle."""
        st = self.store
        th = self.cfg.th
        seq_now = st.kf_seq[kf]
        first_seq = st.pt_first_seq
        recent = st.pt_valid & (first_seq >= seq_now - 3)
        ratio_bad = recent & (st.pt_visible > 0) & (
            st.pt_found < th.point_cull_found_ratio * st.pt_visible)
        obs_bad = recent & (seq_now - first_seq >= 2) & (st.pt_n_obs <= 2)
        bad = np.nonzero(ratio_bad | obs_bad)[0]
        if len(bad):
            st.cull_points(bad)

    # ------------------------------------------------------------------ #
    def create_new_points_steps(self, kf: int):
        """Triangulate new map points against covisible neighbours
        (LocalMapping::CreateNewMapPoints, LocalMapping.cc:188-367): snapshot
        the store, run K8 against the mirror, yield, read the compacted result
        back, write the new points."""
        st = self.store
        cfg = self.cfg
        NB = cfg.th.triangulation_neighbors
        with self.timer("lm.tri.snap"), self.lock:
            neighbors = st.covisible_keyframes(kf, top=NB)
            if len(neighbors) == 0:
                return
            # Median depth of the new keyframe's own points (baseline gate).
            own = st.kf_obs_point[kf]
            own = np.unique(own[own >= 0])
            if len(own) == 0:
                return
            own_z = (st.pt_xyz[own] @ st.kf_T[kf][:3, :3].T + st.kf_T[kf][:3, 3])[:, 2]
            md = float(np.median(own_z[own_z > 0])) if (own_z > 0).any() else 0.0
            if md <= 1e-6:
                return
            # Pad the neighbour list to NB lanes with the keyframe itself:
            # zero baseline, so every candidate of a pad lane is rejected.
            nbs = [int(n) for n in neighbors[:NB]]
            all_nb = np.array(nbs + [kf] * (NB - len(nbs)), np.int64)
            unbound_new = st.kf_feat_valid[kf] & (st.kf_obs_point[kf] < 0)
            if unbound_new.sum() < 10:
                return
            unbound_nb = st.kf_feat_valid[all_nb] & (st.kf_obs_point[all_nb] < 0)
            epoch0 = st.epoch
            self._publish()  # the mirror is exactly the host state from here
            mir = self.mirror
            rows = (mir.kf_xy, mir.kf_angle, mir.kf_octave, mir.kf_desc)
            T_kf, T_nb = st.kf_T[kf].copy(), st.kf_T[all_nb]

        with self.timer("lm.tri.dispatch"):
            dev = tk.triangulate_mirror_batch(
                self._dev(T_kf), self._dev(T_nb), kf, self._dev(all_nb), *rows,
                self._dev(unbound_new), self._dev(unbound_nb), self._K, self._sigma2,
                torch.tensor(md, dtype=torch.float32, device=mir.device),
                enable_far=cfg.enable_far_points)
        yield
        with self.timer("lm.tri.fetch"):
            # Compacted read-back, unpacked to the dense [NB, N] layout.
            code, pts_c, far_c, nbf_c, cosp_c = self.reads.numpy_all(dev)
            N_ = cfg.orb.n_features
            acc = np.zeros((NB, N_), bool)
            pts_np = np.zeros((NB, N_, 3), np.float32)
            far_np = np.zeros((NB, N_), bool)
            nb_idx_np = np.full((NB, N_), -1, np.int32)
            cosp_np = np.zeros((NB, N_), np.float32)
            sel = code >= 0
            nbs_i, feats_i = code[sel] // N_, code[sel] % N_
            acc[nbs_i, feats_i] = True
            pts_np[nbs_i, feats_i] = pts_c[sel]
            far_np[nbs_i, feats_i] = far_c[sel]
            nb_idx_np[nbs_i, feats_i] = nbf_c[sel]
            cosp_np[nbs_i, feats_i] = cosp_c[sel]

        with self.timer("lm.tri.apply"), self.lock:
            if st.epoch != epoch0:
                return  # the store was reset meanwhile
            # Features bound since the snapshot must not be re-triangulated.
            acc = acc & (st.kf_obs_point[kf] < 0)[None, :]
            j_first = np.argmax(acc, axis=0)
            any_acc = acc.any(axis=0) & (j_first < len(nbs))  # skip pad lanes
            feats = np.nonzero(any_acc)[0]
            if len(feats):
                js = j_first[feats]
                order = np.argsort(js, kind="stable")  # neighbour order
                feats, js = feats[order], js[order]
                free = int((~st.pt_valid).sum())
                feats, js = feats[:free], js[:free]
            if len(feats):
                ids = st.alloc_points(len(feats))
                st.pt_xyz[ids] = pts_np[js, feats]
                st.pt_first_seq[ids] = st.kf_seq[kf]
                st.pt_desc[ids] = st.kf_desc[kf, feats]
                st.pt_far[ids] = far_np[js, feats]
                # Far-point origin classes (LocalMapping.cc:255-276).
                qinf = np.linalg.norm(pts_np[js, feats], axis=1) >= 1e5
                st.pt_far_class[ids] = np.where(
                    far_np[js, feats], FAR_COS,
                    np.where(cosp_np[js, feats] > self.far_cos_user, FAR_LOWCOS,
                             np.where(qinf, FAR_SVDINF, FAR_NORMAL)),
                ).astype(np.uint8)
                n_new = len(ids)
                nb_arr = np.asarray(nbs, np.int64)[js]
                st.add_observations(
                    np.concatenate([ids, ids]),
                    np.concatenate([np.full(n_new, kf), nb_arr]),
                    np.concatenate([feats, nb_idx_np[js, feats]]),
                )
                st.update_point_derived(ids, cfg.orb.scale_factor, cfg.orb.n_levels)
                self._publish()

    # ------------------------------------------------------------------ #
    def _fuse_targets(self, kf: int) -> list[int]:
        """1st+2nd-ring covisible fusion targets (LocalMapping.cc:374-395)."""
        st = self.store
        first = [int(k) for k in st.covisible_keyframes(kf, top=20)]
        targets = list(first)
        seen = set(first) | {kf}
        for t in first[:5]:
            for t2 in st.covisible_keyframes(t, top=5):
                t2 = int(t2)
                if t2 not in seen:
                    targets.append(t2)
                    seen.add(t2)
        return targets

    def search_in_neighbors_steps(self, kf: int):
        """Bidirectional duplicate-point fusion with 1st+2nd-ring covisible
        neighbours (LocalMapping::SearchInNeighbors, LocalMapping.cc:369-447):
        one K9 lane per (target, source) keyframe pair, candidates gathered
        from the mirror; matches applied on the host in lane order."""
        st = self.store
        cfg = self.cfg
        with self.timer("lm.fuse.snap"), self.lock:
            targets = self._fuse_targets(kf)[: self._T_FUSE - 1]
            if not targets:
                return
            # Lanes: (t <- points of kf) for each target, then (kf <- points of t).
            tgt = targets + [kf] * len(targets)
            src = [kf] * len(targets) + targets
            L = len(tgt)
            # Source observation rows (slot -> point id), taken with the
            # publish below so they match what the device reads.
            snap_src_obs = st.kf_obs_point[src].copy()
            epoch0 = st.epoch
            self._publish()
            mir = self.mirror
            rows = (mir.kf_xy, mir.kf_angle, mir.kf_octave, mir.kf_desc, mir.kf_feat_valid,
                    mir.kf_obs_point, mir.pt_xyz, mir.pt_desc, mir.pt_max_dist, mir.pt_valid,
                    mir.pt_obs_kf)
            T_tgt = st.kf_T[tgt]

        with self.timer("lm.fuse.dispatch"):
            code = tk.fuse_pairs_mirror(
                self._dev(T_tgt), self._dev(np.asarray(tgt, np.int64)),
                self._dev(np.asarray(src, np.int64)), *rows, self._intr,
                float(cfg.camera.width), float(cfg.camera.height),
                cfg.orb.scale_factor, n_levels=cfg.orb.n_levels)
        yield
        yield
        with self.timer("lm.fuse.fetch"):
            code = self.reads.numpy(code)  # [L, FUSE_PAIR_TOP]

        with self.timer("lm.fuse.apply"), self.lock:
            if st.epoch != epoch0:
                return
            # Every lane's matches as one batch. First occurrence wins for
            # both the (target, feature) and the (target, point) key: the same
            # point can reach the new keyframe through several source lanes
            # and must not bind to two of its features.
            t_l, p_l, f_l = [], [], []
            for lane in range(L):
                c = code[lane]
                c = c[c >= 0]
                pids = snap_src_obs[lane][c >> 12]
                keep = pids >= 0
                n_k = int(keep.sum())
                if n_k:
                    t_l.append(np.full(n_k, tgt[lane], np.int64))
                    p_l.append(pids[keep].astype(np.int64))
                    f_l.append((c & 0xFFF)[keep].astype(np.int64))
            if not t_l:
                self._publish()
                return
            t_all = np.concatenate(t_l)
            p_all = np.concatenate(p_l)
            f_all = np.concatenate(f_l)
            live = st.pt_valid[p_all]
            t_all, p_all, f_all = t_all[live], p_all[live], f_all[live]

            def first_mask(keys):
                order = np.argsort(keys, kind="stable")
                sk = keys[order]
                first = np.concatenate([[True], sk[1:] != sk[:-1]])
                m = np.zeros(len(keys), bool)
                m[order[first]] = True
                return m

            uniq = (first_mask(t_all * cfg.orb.n_features + f_all)
                    & first_mask(t_all * st.cfg.max_points + p_all))
            existing = st.kf_obs_point[t_all, f_all]
            dup = (existing >= 0) & st.pt_valid[np.clip(existing, 0, None)]
            already = (st.pt_obs_kf[p_all] == t_all[:, None]).any(1)
            simple = uniq & ~dup & ~already
            st.add_observations(p_all[simple], t_all[simple], f_all[simple])
            touched = [p_all[simple]]
            # True duplicates keep the better-observed point (ORBmatcher::Fuse
            # + MapPoint::Replace, MapPoint.cc:132-175).
            for t, p, f in zip(t_all[uniq & dup], p_all[uniq & dup], f_all[uniq & dup]):
                t, p, f = int(t), int(p), int(f)
                if not st.pt_valid[p]:
                    continue  # died as the loser of an earlier Replace
                e = int(st.kf_obs_point[t, f])
                if e >= 0 and st.pt_valid[e] and e != p:
                    if st.pt_n_obs[e] >= st.pt_n_obs[p]:
                        st.replace_point(p, e)
                        touched.append(np.array([e], np.int64))
                    else:
                        st.replace_point(e, p)
                        touched.append(np.array([p], np.int64))
                elif e < 0 and not (st.pt_obs_kf[p] == t).any():
                    st.add_observation(p, t, f)
                    touched.append(np.array([p], np.int64))
            touched = np.unique(np.concatenate(touched))
            touched = touched[st.pt_valid[touched]]
            if len(touched):
                st.update_point_derived(touched, cfg.orb.scale_factor, cfg.orb.n_levels)
            self._publish()

    # ------------------------------------------------------------------ #
    def cull_keyframes(self, kf: int) -> None:
        """KeyFrameCulling (LocalMapping.cc:556-603): a covisible keyframe
        whose map points are >= 90% redundant (seen by >= 3 other keyframes)
        is removed. The two oldest keyframes (the gauge), the new keyframe,
        the tracker's reference keyframe and the keyframes still waiting for
        their pass (``queued_fn``) are kept.

        A waiting keyframe holds only the tracked points it was made with,
        all of them old and well observed, so it looks redundant before its
        own pass has triangulated anything; culled then, its pass is
        skipped and the map does not grow where the camera goes. In the
        reference a keyframe joins the covisibility graph only in its own
        ProcessNewKeyFrame (LocalMapping.cc:125-153), so culling never sees
        a waiting one. The JAX package adds the observations when the
        keyframe is made and culls it; its threaded worker seldom has one
        waiting, while the port's, paced one stage a tracked frame, has one
        waiting after most frames. The cooperative scheduler keeps the JAX
        package's rule (``queued_fn`` unset), which its parity tests hold."""
        st = self.store
        live = np.nonzero(st.kf_valid)[0]
        oldest2 = live[np.argsort(st.kf_seq[live], kind="stable")[:2]]
        protected = set(oldest2.tolist()) | {kf}
        if self.protected_kf_fn is not None:
            p = self.protected_kf_fn()
            if p is not None and p >= 0:
                protected.add(int(p))
        if self.queued_fn is not None:
            protected.update(int(k) for k in self.queued_fn())
        for c in st.covisible_keyframes(kf):
            c = int(c)
            if c in protected:
                continue
            obs = st.kf_obs_point[c]
            pts = obs[obs >= 0]
            pts = pts[st.pt_valid[pts]]
            if len(pts) < 10:
                continue
            redundant = st.pt_n_obs[pts] >= 4  # 3 others + itself
            if redundant.mean() > self.cfg.th.kf_cull_redundancy:
                st.cull_keyframe(c)
                if self.on_cull_keyframe is not None:
                    self.on_cull_keyframe(c)

    # ------------------------------------------------------------------ #
    def local_ba_steps(self, kf: int):
        """Local BA (Optimizer::LocalBundleAdjustment, Optimizer.cc:340-589):
        covisible keyframes free, boundary observers fixed, 5 LM iterations,
        outliers dropped, 10 more; outlier observations erased afterwards."""
        with self.timer("lm.ba.assemble"):
            with self.lock:
                snap = self._local_ba_snapshot(kf)
            if snap is None:
                return
            prob, meta = self._local_ba_problem(*snap)
        shard, begin, iterate, reclassify, result = self._ba_fns()
        with self.timer("lm.ba.dispatch"):
            prob = shard(prob)
            state = begin(prob)
            state = iterate(prob, state, 5)
            state = reclassify(prob, state)
            self.ba_iters += 5
        yield
        for _ in range(2):
            if self.abort_ba:  # a new keyframe waits: skip the remaining chunks
                break
            with self.timer("lm.ba.dispatch"):
                state = iterate(prob, state, 5)
                self.ba_iters += 5
            yield
        with self.timer("lm.ba.dispatch"):
            res = result(prob, state)
        yield
        yield
        with self.timer("lm.ba.fetch"):
            res = res._replace(**dict(zip(
                ("cam_T", "points", "obs_inlier"),
                self.reads.numpy_all((res.cam_T, res.points, res.obs_inlier)))))
        with self.timer("lm.local_ba"), self.lock:
            self._local_ba_apply(res, meta)
            self._publish()

    def _local_ba_assemble(self, kf: int):
        """The local BA problem on the device and its host metadata, or None
        when the neighbourhood has too few points."""
        snap = self._local_ba_snapshot(kf)
        return None if snap is None else self._local_ba_problem(*snap)

    def _local_ba_snapshot(self, kf: int):
        """The host side of the problem, from the store and the mirror's
        tensors as they stand (under the map lock): (host arrays, mirror
        tensors, metadata), or None."""
        st = self.store
        cfg = self.cfg
        local = [kf] + [int(k) for k in
                        st.covisible_keyframes(kf, top=cfg.th.local_ba_keyframes - 1)]
        pts = st.kf_obs_point[local]
        pts = np.unique(pts[pts >= 0])
        # Far (quasi-infinity) points stay out of BA (Optimizer.cc:243).
        pts = pts[st.pt_valid[pts] & ~st.pt_far[pts]][:P_BUCKETS[-1]]
        if len(pts) < 20:
            return None

        obs_kf_all = st.pt_obs_kf[pts]
        observers = np.unique(obs_kf_all[obs_kf_all >= 0])
        local_set = set(local)
        boundary = [int(k) for k in observers if int(k) not in local_set]
        cams = (local + boundary)[:C_BUCKETS[-1]]
        # Smallest padded bucket covering the problem (the reference's
        # compile buckets; kept so the arithmetic matches).
        P_BA = next(b for b in P_BUCKETS if b >= len(pts))
        C_BA = next(b for b in C_BUCKETS if b >= len(cams))
        cam_slot = {c: i for i, c in enumerate(cams)}
        fixed = np.ones(C_BA, bool)
        fixed[:len(local)] = False
        # Gauge: the oldest keyframe in the problem; with no boundary the two
        # oldest (monocular scale). Age is kf_seq, not the slot id.
        by_age = sorted(cams, key=lambda c: int(st.kf_seq[c]))
        fixed[cam_slot[by_age[0]]] = True
        if len(cams) > 1 and len(boundary) == 0:
            fixed[cam_slot[by_age[1]]] = True

        P = len(pts)
        M = st.cfg.max_obs_per_point
        cam_T = np.tile(np.eye(4, dtype=np.float32), (C_BA, 1, 1))
        for c, i in cam_slot.items():
            cam_T[i] = st.kf_T[c]
        okf = st.pt_obs_kf[pts]  # [P, M]
        oft = st.pt_obs_feat[pts]
        slot_lookup = np.full(st.cfg.max_keyframes, -1, np.int64)
        for c, i in cam_slot.items():
            slot_lookup[c] = i
        okf_c = np.clip(okf, 0, None)
        slots = slot_lookup[okf_c]
        # Observations the problem holds: those of materialized keyframes and
        # of the rows the mirror holds as device-published pending rows (the
        # device gathers their real features). Too few fixes the newest
        # keyframe at its tracked pose; too many frees a camera with no real
        # observation.
        feat_ok = st.kf_feat_valid[okf_c, np.clip(oft, 0, None)]
        if self.mirror._pending_rows:
            pending = np.zeros(st.cfg.max_keyframes, bool)
            pending[list(self.mirror._pending_rows)] = True
            feat_ok = feat_ok | pending[okf_c]
        valid = (okf >= 0) & (slots >= 0) & feat_ok
        obs_valid = np.zeros((P_BA, M), bool)
        obs_valid[:P] = valid  # host copy for the outlier erase
        # A camera with (almost) no observations in the problem would be sent
        # anywhere by the LM step: it stays fixed.
        n_obs_cam = np.bincount(slots[valid].ravel(), minlength=C_BA)
        for c, i in cam_slot.items():
            if n_obs_cam[i] < 6:
                fixed[i] = True

        pts_idx = np.zeros(P_BA, np.int64)
        pts_idx[:P] = pts
        pvalid = np.zeros(P_BA, bool)
        pvalid[:P] = True
        # K10: observation tables gathered from the mirror, which is exactly
        # the host state after this publish.
        self._publish()
        mir = self.mirror
        rows = (mir.pt_xyz, mir.pt_obs_kf, mir.pt_obs_feat, mir.kf_xy, mir.kf_octave,
                mir.kf_feat_valid)
        host = dict(pts_idx=pts_idx, pvalid=pvalid, slot_lookup=slot_lookup, cam_T=cam_T,
                    fixed=fixed)
        meta = dict(pts=pts, okf=okf, cam_slot=cam_slot, fixed=fixed, obs_valid=obs_valid,
                    P=P, epoch=st.epoch, cam_seq={c: int(st.kf_seq[c]) for c in cams})
        return host, rows, meta

    def _local_ba_problem(self, host, rows, meta):
        """Upload the host side and gather the observation tables from the
        snapshot's mirror tensors: (BAProblem, metadata)."""
        d = self._dev
        obs_cam, obs_uv, obs_s2, d_obs_valid, points = tk.assemble_ba_mirror(
            *rows, d(host["pts_idx"]), d(host["pvalid"]), d(host["slot_lookup"]), self._sigma2)
        prob = BAProblem(cam_T=d(host["cam_T"]), cam_fixed=d(host["fixed"]), points=points,
                         point_valid=d(host["pvalid"]), obs_cam=obs_cam, obs_uv=obs_uv,
                         obs_sigma2=obs_s2, obs_valid=d_obs_valid, intr=self._intr)
        return prob, meta

    def _local_ba_apply(self, res, meta) -> None:
        st = self.store
        if st.epoch != meta["epoch"]:
            return  # the store was reset meanwhile
        pts, okf, P = meta["pts"], meta["okf"], meta["P"]
        fixed, obs_valid, cam_seq = meta["fixed"], meta["obs_valid"], meta["cam_seq"]
        still = set()
        for c, i in meta["cam_slot"].items():
            # A keyframe's identity is (slot, kf_seq): a culled slot may have
            # been handed to a new keyframe.
            if not (st.kf_valid[c] and int(st.kf_seq[c]) == cam_seq[c]):
                continue
            still.add(c)
            if not fixed[i]:
                st.kf_T[c] = res.cam_T[i]
        alive = st.pt_valid[pts]
        st.pt_xyz[pts[alive]] = res.points[:P][alive]
        # Erase outlier observations (Optimizer.cc:520-556), only against
        # keyframes whose slot identity survived.
        inl = res.obs_inlier[:P]
        okf_still = np.isin(okf, list(still)) if still else np.zeros_like(okf, bool)
        out_i, out_s = np.nonzero(obs_valid[:P] & ~inl & alive[:, None] & okf_still)
        st.remove_observations(pts[out_i], okf[out_i, out_s])
        dead = pts[alive & (st.pt_n_obs[pts] < 2)]  # < 2 observations left
        if len(dead):
            st.cull_points(dead)
