"""Loop closing: BoW detection with consistency groups, the Sim3 candidate
program, loop correction, the essential graph and chunked global BA. Port of
os1_tpu/pipeline/loop_closing.py (reference LoopClosing.cc) for the
cooperative and synchronous pipelines.

Detection and the correction's bookkeeping are host numpy on the host store.
Each loop candidate is one device program (match, Horn RANSAC, Sim3 LM,
guided projection) whose packed result is read back once; the essential graph
and the global BA run on the device too. The attempt is a generator that
yields between a dispatch and its read, so the cooperative scheduler spreads
it over the following frames; :meth:`LoopCloser.process` drains it.

With the worker threads on (``mapping_worker`` set), the attempt runs on the
LoopClosing thread: detection and the snapshots under the map lock, the
candidates' programs outside it, the correction under it with local mapping
stopped (LoopClosing.cc:413-431), and the global BA on a detached GlobalBA
thread (LoopClosing.cc:584) that a newer loop aborts between chunks
(mbStopGBA) and joins before it corrects.

With a mesh backend (``mesh_backend``, wired by System), the global BA runs
landmark-sharded over the mesh and the essential graph edge-sharded over the
same devices (``parallel/``, BASELINE.json configs 4-5).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ..features.orb import FrameFeatures
from ..geometry import sim3
from ..map.store import MapStore
from ..matching import core as mcore
from ..matching import matchers
from ..optim import ba_begin, ba_iterate, ba_result
from ..optim.pose_graph import optimize_pose_graph
from ..optim.sim3_opt import optimize_sim3
from ..parallel import Mesh, distributed_pose_graph
from ..solvers.initializer import GumbelSampler
from ..solvers.sim3_solver import solve_sim3
from ..utils import transfer
from ..utils.profiling import HostReads, StageTimer
from ..vocab.database import KeyFrameDatabase
from .config import SlamConfig
from .local_mapping import apply_global_ba, assemble_global_ba
from .workers import MapLock

MIN_MATCHES_SIM3 = 20  # LoopClosing.cc:269
MIN_INLIERS_SIM3 = 20  # LoopClosing.cc:297 / Optimizer nInliers >= 20
MIN_TOTAL_MATCHES = 40  # LoopClosing.cc:387
# Largest factor by which the Sim3 LM may move the scale of Horn's RANSAC
# estimate. Where the two keyframes' centres nearly coincide (a revisit), the
# scale is close to unobservable in the two-way reprojection error and the LM
# runs along it (the reference package's LM, on the same inputs, takes a 0.94
# scale to 4.97); only Horn's 3D-3D fit sees it. Not in the reference package
# (LoopCloser.sim3_log records each candidate's two scales and both verdicts).
MAX_LM_SCALE_CHANGE = 1.5
CONSISTENCY_TH = 3  # LoopClosing.cc:53 mnCovisibilityConsistencyTh
SIM3_CAP = 512  # match capacity of the Sim3 solve
PROJ_CAP = 4096  # loop-region point capacity of the guided projection
GBA_ITERS, GBA_CHUNK = 20, 5  # global BA: LM iterations, dispatched in chunks
STOP_WAIT_S = 60.0  # the longest a correction waits for local mapping to stop
# Packed head: success, n_match, n_total, n_inliers, S12 flat (16), Horn's
# scale, the LM's scale, success without the scale guard, padding.
HEAD = 35


def match_bound_features(desc1, bound1, angle1, desc2, bound2, angle2) -> mcore.MatchResult:
    """Descriptor match between the point-bound features of two keyframes
    (the reference's SearchByBoW(KF, KF), ORBmatcher.cc:517-650): every bound
    pair a candidate, TH_LOW, ratio 0.75, mutual best, rotation consistency.
    The gate ``bound1 x bound2`` goes to the fused match as its two masks."""
    res = mcore.match_projected(desc1, desc2, bound1, bound2, max_dist=mcore.TH_LOW, ratio=0.75)
    res = mcore.mutual_best(res, desc2.shape[0])
    return mcore.rotation_consistency(angle1, angle2, res)


def lm_scale_consistent(S_ransac, S_opt) -> torch.Tensor:
    """True where the Sim3 LM kept the scale within MAX_LM_SCALE_CHANGE of
    Horn's estimate (a bool tensor: no host read).

    The guard is a deviation from the reference package, kept by decision.
    On bench.py's loop sequence on an NVIDIA H100 (80GB HBM3, 700 W) it
    rejects none of the 35 candidates (LM/Horn scale ratios 0.952-1.039),
    and a run without it closes the same loop at the same ATE. Where the LM
    does run along the scale (tests/data/sim3_scale_runaway.npz: both
    packages take it past 4), accepting the candidate wrecks the map on the
    correction, so dropping the guard would copy a fault and buy nothing."""
    change = torch.log(sim3.to_Rts(S_opt)[2] / sim3.to_Rts(S_ransac)[2])
    return torch.abs(change) <= math.log(MAX_LM_SCALE_CHANGE)


def sim3_candidate_program(desc1, bound1, angle1, xy1, oct1, feat_valid1, xyz1,
                           desc2, bound2, angle2, xy2, oct2, xyz2,
                           region_desc, region_xyz, region_ok, T_lw, intr, sigma2_table,
                           sampler):
    """ComputeSim3 (LoopClosing.cc:234-405) for one loop candidate as one
    device program: the bound-feature match, Horn's Sim3 RANSAC on the first
    SIM3_CAP matches in feature order, the Sim3 LM, and the guided projection
    of the loop region's points into the current keyframe through the
    corrected pose. Keyframe 1 is the current one, 2 the candidate; xyz1/xyz2
    are the camera-frame coordinates of each feature's point.

    A candidate succeeds as in the reference package, and only if the LM kept
    Horn's scale (:func:`lm_scale_consistent`, a decided deviation: see
    there).

    Returns (head [HEAD] float32, f1 [cap] int64, f2 [cap], pair_ok [cap]
    bool)."""
    N = desc1.shape[0]
    cap = min(SIM3_CAP, N)
    res = match_bound_features(desc1, bound1, angle1, desc2, bound2, angle2)
    n_match = res.ok.sum()
    # The first `cap` matched features in feature order.
    f1 = torch.argsort((~res.ok).to(torch.int32), stable=True)[:cap]
    msel = torch.arange(cap, device=f1.device) < n_match
    f1 = torch.where(msel, f1, torch.zeros_like(f1))
    f2 = torch.where(msel, res.idx[f1], torch.zeros_like(f1))

    def sel(x, fill=0.0):
        m = msel.reshape((cap,) + (1,) * (x.ndim - 1))
        return torch.where(m, x, torch.full_like(x, fill))

    x1, x2 = sel(xyz1[f1]), sel(xyz2[f2])
    uv1, uv2 = sel(xy1[f1]), sel(xy2[f2])
    s2_1 = sel(sigma2_table[oct1[f1].long()], 1.0)
    s2_2 = sel(sigma2_table[oct2[f2].long()], 1.0)

    ransac = solve_sim3(x1, x2, msel, uv1, uv2, s2_1, s2_2, intr, sampler,
                        min_inliers=MIN_INLIERS_SIM3)
    opt = optimize_sim3(ransac.S12, x1, x2, ransac.inliers & msel, uv1, uv2, s2_1, s2_2, intr)

    # Guided projection acceptance (LoopClosing.cc:341-389).
    S_cw = opt.S12 @ T_lw
    pc = region_xyz @ S_cw[:3, :3].T + S_cw[:3, 3]
    ok_depth = (pc[:, 2] > 0.05) & region_ok
    z = torch.where(torch.abs(pc[:, 2]) < 1e-8, torch.full_like(pc[:, 2], 1e-8), pc[:, 2])
    uv = torch.stack([intr[0] * pc[:, 0] / z + intr[2], intr[1] * pc[:, 1] / z + intr[3]], 1)
    feats = FrameFeatures(xy=xy1, response=torch.zeros_like(angle1), angle=angle1, octave=oct1,
                          desc=desc1, valid=feat_valid1)
    P = region_desc.shape[0]
    proj = matchers.search_by_projection(
        point_desc=region_desc, point_uv=uv, point_valid=ok_depth,
        point_octave=torch.zeros(P, dtype=torch.int32, device=uv.device), feats=feats,
        radius=torch.full((P,), 8.0, device=uv.device), ratio=1.0, max_dist=mcore.TH_LOW,
        octave_lo=-8, octave_hi=8)
    n_total = proj.ok.sum()

    success_ref = ((n_match >= MIN_MATCHES_SIM3) & ransac.success
                   & (opt.n_inliers >= MIN_INLIERS_SIM3) & (n_total >= MIN_TOTAL_MATCHES))
    success = success_ref & lm_scale_consistent(ransac.S12, opt.S12)
    f = torch.float32
    head = torch.cat([torch.stack([success.to(f), n_match.to(f), n_total.to(f),
                                   opt.n_inliers.to(f)]), opt.S12.reshape(16).to(f),
                      torch.stack([sim3.to_Rts(ransac.S12)[2].to(f), sim3.to_Rts(opt.S12)[2].to(f),
                                   success_ref.to(f)]),
                      torch.zeros(HEAD - 23, dtype=f, device=uv.device)])
    return head, f1, f2, opt.inliers & msel


@dataclass
class LoopCloser:
    cfg: SlamConfig
    store: MapStore
    db: KeyFrameDatabase
    device: torch.device | str = "cuda"
    last_loop_kf: int = -100
    consistent_groups: list = field(default_factory=list)  # [(set, count)]
    loop_edges: list = field(default_factory=list)  # [(kf_a, kf_b)]
    n_loops_closed: int = 0
    # Sim3 RANSAC hypothesis sampler (solvers.sim3_solver): None = a Gumbel
    # top-k from a generator seeded with 7 on ``device``.
    sampler: object = None
    # The tracker's keyframe gate reads this (Tracker.loop_closing_active).
    # As in the reference package it is only ever reset, never raised.
    closing_active: bool = False
    on_map_updated: object = None  # callback() after a global BA's write-back
    # callback() right after a correction, before the global BA: the world
    # moved, so the mirror republishes and the tracker re-anchors (System).
    on_corrected: object = None
    timer: StageTimer = field(default_factory=StageTimer)
    reads: HostReads = field(default_factory=HostReads)
    # One record per evaluated Sim3 candidate, from its packed head:
    # (kf, cand, n_match, n_inliers, n_total, Horn's scale, the LM's scale,
    # success without the scale guard, success).
    sim3_log: list = field(default_factory=list)
    lock: MapLock = field(default_factory=MapLock)  # the map lock, wired by System
    # The threaded pipeline's MappingWorker, wired by System: stopped while
    # a correction or a global BA's write-back moves the map.
    mapping_worker: object = None
    gba_spawned: int = 0  # global-BA threads started
    gba_errors: list = field(default_factory=list)  # exceptions of the GlobalBA thread
    # Distributed solver backend (parallel.MeshBABackend), wired by System
    # when a mesh is active. None: the single-device solves.
    mesh_backend: object = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.sampler is None:
            self.sampler = GumbelSampler(seed=7, device=self.device)
        self._intr = torch.as_tensor(self.cfg.intr, device=self.device)
        self._sigma2 = torch.as_tensor(self.cfg.sigma2_table, device=self.device)
        self._stop_gba = False  # mbStopGBA (LoopClosing.cc:416-425)
        self._gba_thread = None  # the detached global BA (LoopClosing.cc:584)

    # ------------------------------------------------------------------ #
    def process(self, kf: int, kf_count: int) -> bool:
        """A whole loop-closing attempt for a new keyframe (the drain of
        :meth:`process_steps`). Returns True if a loop was closed."""
        closed = False
        for closed in self.process_steps(kf, kf_count):
            pass
        return bool(closed)

    def process_steps(self, kf: int, kf_count: int):
        """The attempt as a generator that yields at each dispatch -> read
        interval and yields its running closed-a-loop flag; a keyframe with no
        candidate (the common case) finishes without yielding."""
        with self.lock:
            if not self.store.kf_valid[kf]:
                return  # culled before the loop stage got to it
            with self.timer("loop.detect"):
                candidates = self.detect(kf, kf_count)
            snaps = [(int(c), self._snapshot_sim3(kf, int(c))) for c in candidates[:3]]
            epoch0 = self.store.epoch
        if not snaps:
            return
        try:
            hit = None
            for cand, snap in snaps:
                with self.timer("loop.sim3"):
                    dev = self._dispatch_sim3(snap)
                yield False  # two intervals: the pipelined tracker keeps up
                yield False  # to its pipeline depth of frames ahead
                with self.timer("loop.sim3"):
                    ok, S_cl, pairs = self._fetch_sim3(dev, kf, cand)
                if ok:
                    hit = (cand, S_cl, pairs)
                    break
            if hit is None:
                return  # no candidate held
            with self.lock:
                if self.store.epoch != epoch0:
                    return  # the system was reset meanwhile
            cand, S_cl, pairs = hit
            # A running global BA belongs to a superseded loop (LoopClosing.cc:416-425).
            with self.timer("loop.gba_abort"):
                self.abort_gba()
            self._stop_mapping()
            try:
                with self.timer("loop.correct"), self.lock:
                    if self.store.kf_valid[kf] and self.store.kf_valid[cand]:
                        self.correct(kf, cand, S_cl, pairs)
                        self.last_loop_kf = kf_count
                        self.n_loops_closed += 1
            finally:
                self._release_mapping()
            if self.on_corrected is not None:
                self.on_corrected()
        finally:
            self.closing_active = False
        self._stop_gba = False
        if self.mapping_worker is not None:
            self._spawn_gba()
        else:
            # Chunked global BA on this thread: the sync drain runs it inline,
            # the cooperative scheduler spreads its chunks over the frames.
            yield from self._gba_steps()
        yield True

    def _stop_mapping(self) -> None:
        """Local mapping stops (after its pass in flight) while the map moves
        (LoopClosing.cc:413-431, :686); the cooperative and synchronous
        pipelines need no barrier, nothing maps while this runs. Raises, with
        the worker released, if it has not stopped within ``STOP_WAIT_S``."""
        if self.mapping_worker is not None:
            with self.timer("loop.stop_barrier"):
                self.mapping_worker.request_stop()
                if not self.mapping_worker.wait_stopped(timeout=STOP_WAIT_S):
                    self.mapping_worker.release()
                    raise RuntimeError(f"the LocalMapping thread did not stop within "
                                       f"{STOP_WAIT_S} s; the map is left as it was")

    def _release_mapping(self) -> None:
        if self.mapping_worker is not None:
            self.mapping_worker.release()

    def abort_gba(self) -> None:
        """Stop a global BA between its chunks (mbStopGBA) and join its
        thread, if one runs."""
        self._stop_gba = True
        t = self._gba_thread
        if t is not None and t.is_alive():
            t.join(timeout=120.0)
        self._gba_thread = None

    def wait_gba(self, timeout: float = 120.0) -> bool:
        """Join a running global BA thread; False if it is still running."""
        t = self._gba_thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def _spawn_gba(self) -> None:
        """Start the detached global BA thread (LoopClosing.cc:584)."""
        self._gba_thread = threading.Thread(target=self._run_gba, daemon=True, name="GlobalBA")
        self.gba_spawned += 1
        self._gba_thread.start()

    def _run_gba(self) -> None:
        """The GlobalBA thread: drains :meth:`_gba_steps`; an exception is
        printed and kept (``gba_errors``)."""
        try:
            for _ in self._gba_steps():
                pass
        except Exception as exc:  # noqa: BLE001: kept for the caller, as the workers do
            import traceback

            traceback.print_exc()
            self.gba_errors.append(exc)

    # ------------------------------------------------------------------ #
    def _gba_steps(self):
        """Global BA (RunGlobalBundleAdjustment, LoopClosing.cc:653-752) as
        generator steps: each GBA_CHUNK-iteration LM chunk is dispatched and
        the generator yields while the device solves; abortable between
        chunks."""
        with self.timer("loop.gba.assemble"), self.lock:
            work = assemble_global_ba(self.store, self.cfg, self.device)
        if work is None:
            return
        prob, meta = work
        be = self.mesh_backend
        if be is not None:  # landmark-sharded over the mesh (configs 4-5)
            begin, iterate, result = be.begin, be.iterate, be.result
            prob = be.shard(prob)
        else:
            begin, iterate, result = ba_begin, ba_iterate, ba_result
        state = begin(prob)
        for _ in range(GBA_ITERS // GBA_CHUNK):
            if self._stop_gba:
                return
            with self.timer("loop.gba.chunk"):
                state = iterate(prob, state, GBA_CHUNK)
            yield
        with self.timer("loop.gba.fetch"):
            res = result(prob, state)
            dev = transfer.announce((res.cam_T, res.points, res.obs_inlier))
        yield
        yield
        with self.timer("loop.gba.fetch"):
            cam_T, points, obs_inlier = transfer.fetch(dev, self.reads)
        if self._stop_gba:
            return
        self._stop_mapping()
        try:
            with self.timer("loop.gba.apply"), self.lock:
                apply_global_ba(self.store, self.cfg, res._replace(
                    cam_T=cam_T, points=points, obs_inlier=obs_inlier), meta)
                if self.on_map_updated is not None:
                    self.on_map_updated()
        finally:
            self._release_mapping()

    # ------------------------------------------------------------------ #
    def detect(self, kf: int, kf_count: int) -> np.ndarray:
        """DetectLoop (LoopClosing.cc:104-232): BoW candidates above the
        worst covisible neighbour's score, every connected keyframe excluded,
        then the covisibility-consistency accumulation."""
        st = self.store
        if kf_count < self.last_loop_kf + 10:  # LoopClosing.cc:115
            return np.empty(0, np.int64)
        neighbors = st.covisible_keyframes(kf, min_weight=15)
        if len(neighbors) == 0:
            return np.empty(0, np.int64)
        bow_kf = self.db.bows[kf]
        if bow_kf is None:
            return np.empty(0, np.int64)
        # Minimum acceptable score: the worst covisible neighbour's
        # similarity (LoopClosing.cc:125-139).
        min_score = float(min(self.db.score_kf(bow_kf, int(n)) for n in neighbors))
        # Every keyframe sharing a point with kf is excluded: the reference's
        # connected set is the whole weight map (KeyFrameDatabase.cc:78-96).
        connected = np.nonzero(st.covisibility_weights(kf) > 0)[0]
        cands = self.db.detect_loop_candidates(
            bow_kf, exclude=np.concatenate([[kf], connected]), min_score=min_score,
            covis_fn=lambda k: st.covisible_keyframes(k, top=10))
        if len(cands) == 0:
            self.consistent_groups = []
            return np.empty(0, np.int64)

        # Consistency groups (LoopClosing.cc:153-227).
        accepted, new_groups = [], []
        for c in cands:
            c = int(c)
            group = set(int(x) for x in st.covisible_keyframes(c, min_weight=15))
            group.add(c)
            best_count = 0
            for prev_set, prev_count in self.consistent_groups:
                if group & prev_set:
                    best_count = max(best_count, prev_count + 1)
            new_groups.append((group, best_count))
            if best_count >= CONSISTENCY_TH:
                accepted.append(c)
        self.consistent_groups = new_groups
        return np.array(accepted, np.int64)

    # ------------------------------------------------------------------ #
    def _snapshot_sim3(self, kf: int, cand: int) -> dict:
        """Host copy of one candidate's program inputs, taken under the map
        lock. xyz1/xyz2 are the camera-frame coordinates of the point bound
        to each feature (garbage for unbound features: the program gates on
        the bound masks)."""
        st = self.store
        obs1, obs2 = st.kf_obs_point[kf], st.kf_obs_point[cand]
        bound1 = (obs1 >= 0) & st.pt_valid[np.clip(obs1, 0, None)]
        bound2 = (obs2 >= 0) & st.pt_valid[np.clip(obs2, 0, None)]
        T1, T2 = st.kf_T[kf], st.kf_T[cand]
        xyz1 = st.pt_xyz[np.clip(obs1, 0, None)] @ T1[:3, :3].T + T1[:3, 3]
        xyz2 = st.pt_xyz[np.clip(obs2, 0, None)] @ T2[:3, :3].T + T2[:3, 3]
        # Loop-region points (the candidate and its covisible neighbourhood)
        # for the guided projection (LoopClosing.cc:341-389).
        region = [cand] + [int(k) for k in st.covisible_keyframes(cand, top=10)]
        pts = st.kf_obs_point[region]
        pts = np.unique(pts[pts >= 0])
        pts = pts[st.pt_valid[pts]][:PROJ_CAP]
        n_real = len(pts)
        pts = np.concatenate([pts, np.zeros(PROJ_CAP - n_real, np.int64)])
        snap = dict(
            desc1=st.kf_desc[kf], bound1=bound1, angle1=st.kf_angle[kf], xy1=st.kf_xy[kf],
            oct1=st.kf_octave[kf], feat_valid1=st.kf_feat_valid[kf],
            xyz1=xyz1.astype(np.float32),
            desc2=st.kf_desc[cand], bound2=bound2, angle2=st.kf_angle[cand],
            xy2=st.kf_xy[cand], oct2=st.kf_octave[cand], xyz2=xyz2.astype(np.float32),
            region_desc=st.pt_desc[pts], region_xyz=st.pt_xyz[pts].astype(np.float32),
            region_ok=np.arange(PROJ_CAP) < n_real, T_lw=T2.astype(np.float32))
        return {k: np.array(v) for k, v in snap.items()}  # copies: the rows may change later

    def _run_sim3(self, snap: dict):
        """The candidate program on a snapshot, on the device (the snapshot
        goes over in one copy)."""
        return sim3_candidate_program(
            **transfer.upload(snap, self.device),
            intr=self._intr, sigma2_table=self._sigma2, sampler=self.sampler)

    def _dispatch_sim3(self, snap: dict) -> transfer.Announced:
        """Dispatch the program; its packed result starts its copy to the
        host now (head, f1, f2, pair_ok in one float32 vector)."""
        head, f1, f2, pair_ok = self._run_sim3(snap)
        f = torch.float32
        return transfer.announce(torch.cat([head, f1.to(f), f2.to(f), pair_ok.to(f)]))

    def _fetch_sim3(self, dev: transfer.Announced, kf: int, cand: int):
        """Read a dispatched program and log it. Returns (ok, S_cl: candidate
        camera -> current camera, matched feature pairs [n, 2])."""
        out = transfer.fetch(dev, self.reads)
        self.sim3_log.append((kf, cand, int(out[1]), int(out[3]), int(out[2]), float(out[20]),
                              float(out[21]), bool(out[22] > 0.5), bool(out[0] > 0.5)))
        if out[0] < 0.5:
            return False, None, None
        cap = (len(out) - HEAD) // 3
        f1, f2, pair_ok = out[HEAD:].reshape(3, cap)
        pair_ok = pair_ok > 0.5
        pairs = np.stack([f1[pair_ok], f2[pair_ok]], axis=1).astype(np.int64)
        return True, out[4:20].reshape(4, 4).astype(np.float32), pairs

    def essential_graph(self, S, kf_valid, fixed, edge_i, edge_j, edge_S) -> torch.Tensor:
        """The essential graph's 20 LM iterations (Optimizer::
        OptimizeEssentialGraph) on the device from host arrays, which go over
        in one copy; edge-sharded over the mesh when one is wired. Returns
        the optimized Sim3 nodes [K, 4, 4]."""
        g = transfer.upload(dict(S=S, kf_valid=kf_valid, fixed=fixed, edge_i=edge_i,
                                 edge_j=edge_j, edge_S=edge_S), self.device)
        if self.mesh_backend is not None:  # edge-sharded over the mesh (config 5)
            mesh = Mesh(self.mesh_backend.mesh.devices.reshape(-1), ("edges",))
            ones = torch.ones(len(edge_i), dtype=torch.bool, device=self.device)
            return distributed_pose_graph(**g, edge_valid=ones, mesh=mesh, iters=20)
        return optimize_pose_graph(**g)

    # ------------------------------------------------------------------ #
    def correct(self, kf: int, cand: int, S_cl: np.ndarray, pairs: np.ndarray):
        """CorrectLoop (LoopClosing.cc:407-592): propagate the Sim3 over the
        current covisible group, fuse the duplicate points, optimize the
        essential graph, record the loop edge."""
        st = self.store
        K = st.cfg.max_keyframes
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731

        S_cw_corr = (S_cl @ st.kf_T[cand]).astype(np.float32)  # Sim3 world -> current
        group = [kf] + [int(k) for k in st.covisible_keyframes(kf, min_weight=15)]
        # Every keyframe newer than the closing one joins the group: the
        # cooperative Sim3 evaluation spans a few frames, and a keyframe made
        # meanwhile may miss the covisibility walk (left uncorrected, it ends
        # up inconsistent once the map moves).
        seq_kf = int(st.kf_seq[kf])
        for k in np.nonzero(st.kf_valid)[0]:
            k = int(k)
            if int(st.kf_seq[k]) > seq_kf and k not in group:
                group.append(k)
        old_T = {i: st.kf_T[i].copy() for i in group}
        T_cur_inv = np.linalg.inv(st.kf_T[kf])
        corr_S = {i: (old_T[i] @ T_cur_inv @ S_cw_corr).astype(np.float32) for i in group}

        # The group's points move through their first observing group
        # keyframe (LoopClosing.cc:460-487), one affine transform per keyframe.
        corrected = np.zeros(st.cfg.max_points, bool)
        for i in group:
            obs = st.kf_obs_point[i]
            pids = np.unique(obs[obs >= 0])
            pids = pids[st.pt_valid[pids] & ~corrected[pids]]
            if len(pids) == 0:
                continue
            corrected[pids] = True
            S_new_inv = sim3.inverse(t(corr_S[i])).numpy()
            xc = st.pt_xyz[pids] @ old_T[i][:3, :3].T + old_T[i][:3, 3]
            st.pt_xyz[pids] = xc @ S_new_inv[:3, :3].T + S_new_inv[:3, 3]
        for i in group:  # poses to the scale-normalized corrections
            st.kf_T[i] = sim3.to_se3(t(corr_S[i])).numpy()

        # Loop fusion: a matched pair is one physical point; the current
        # side's point hands its observations to the loop side's
        # (LoopClosing.cc:525-541).
        obs_cur = st.kf_obs_point[kf]
        for fc, fl in pairs:
            p_cur = int(obs_cur[fc])
            p_loop = int(st.kf_obs_point[cand, fl])
            if p_cur == p_loop or p_cur < 0 or p_loop < 0:
                continue
            if not (st.pt_valid[p_cur] and st.pt_valid[p_loop]):
                continue
            for s in range(st.pt_n_obs[p_cur]):
                okf, oft = int(st.pt_obs_kf[p_cur, s]), int(st.pt_obs_feat[p_cur, s])
                if okf < 0:
                    continue
                st.kf_obs_point[okf, oft] = -1
                st.add_observation(p_loop, okf, oft)
            st.pt_valid[p_cur] = False
            st.pt_obs_kf[p_cur] = -1
            st.pt_obs_feat[p_cur] = -1
            st.pt_n_obs[p_cur] = 0

        # ----- essential graph -----
        live = np.nonzero(st.kf_valid)[0]
        # A keyframe whose event has not run yet (its features still on the
        # device) has no spanning-tree parent and too few covisibility links
        # to hold it in the graph: left isolated it keeps its first
        # correction while its points move with the graph, and a tracker that
        # uses it as reference loses the next frame. It joins the tree now,
        # as its event's first step would (the reference has no such
        # keyframes: it adds a keyframe to the map only when mapping takes it).
        for i in live:
            if st.kf_parent[i] < 0 and not st.kf_feat_valid[i].any():
                st.update_spanning_tree(int(i))
        S_nodes = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        S_nodes[live] = st.kf_T[live]
        for i in group:  # corrected nodes start from their Sim3 corrections
            S_nodes[i] = corr_S[i]
        edges = set()
        # Spanning tree (KeyFrame::GetParent, Optimizer.cc:655-670).
        for i in live:
            p = int(st.kf_parent[int(i)])
            if p >= 0 and st.kf_valid[p]:
                edges.add((p, int(i)))
        # Strong covisibility (minFeat = 100, Optimizer.cc:617).
        for i in live:
            w = st.covisibility_weights(int(i))
            for j in np.nonzero(w >= 100)[0]:
                if j > i:
                    edges.add((int(i), int(j)))
        for a, b in self.loop_edges:  # past loop edges
            if st.kf_valid[a] and st.kf_valid[b]:
                edges.add((min(a, b), max(a, b)))
        ei = np.array([e[0] for e in edges], np.int64)
        ej = np.array([e[1] for e in edges], np.int64)
        # Measurements from the pre-correction poses (NonCorrectedSim3), the
        # group's own from the corrected ones, plus the new loop edge.
        pre = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        pre[live] = st.kf_T[live]
        for i in group:
            pre[i] = old_T[i]
        eS = np.einsum("eij,ejk->eik", pre[ej], np.linalg.inv(pre[ei]))
        ei = np.concatenate([ei, [cand]])
        ej = np.concatenate([ej, [kf]])
        eS = np.concatenate([eS, S_cw_corr[None] @ np.linalg.inv(st.kf_T[cand])[None]])
        fixed = np.zeros(K, bool)
        fixed[cand] = True  # the loop keyframe anchors the gauge (Optimizer.cc:620)
        # Each keyframe's pose before the graph, for the point remap: the
        # group's points already moved with corr_S, so corr_S is theirs.
        old_pose_all = {int(i): st.kf_T[int(i)].copy() for i in live}
        old_pose_all.update({i: corr_S[i] for i in group})

        with self.timer("loop.essential"):
            S_opt = self.reads.numpy(self.essential_graph(S_nodes, st.kf_valid, fixed, ei, ej,
                                                          eS.astype(np.float32)))
        # Poses written back and every point remapped through its first live
        # observer (Optimizer.cc:833-861), one affine transform per keyframe.
        new_T = sim3.to_se3(t(S_opt)).numpy()
        S_opt_inv = sim3.inverse(t(S_opt)).numpy()
        pt_done = np.zeros(st.cfg.max_points, bool)
        for i in live:
            i = int(i)
            obs = st.kf_obs_point[i]
            pids = np.unique(obs[obs >= 0])
            pids = pids[st.pt_valid[pids] & ~pt_done[pids]]
            if len(pids) == 0:
                continue
            pt_done[pids] = True
            corr = (S_opt_inv[i] @ sim3.from_se3(old_pose_all[i])).astype(np.float32)
            st.pt_xyz[pids] = st.pt_xyz[pids] @ corr[:3, :3].T + corr[:3, 3]
        st.kf_T[live] = new_T[live]

        self.loop_edges.append((min(kf, cand), max(kf, cand)))
        st.update_point_derived(np.nonzero(pt_done)[0], self.cfg.orb.scale_factor,
                                self.cfg.orb.n_levels)
