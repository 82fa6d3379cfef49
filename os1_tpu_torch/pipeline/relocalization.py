"""Relocalization: BoW candidate retrieval, descriptor matching, RANSAC PnP
and an LM pose polish. Port of the mirror path of
os1_tpu/pipeline/relocalization.py (reference Tracking::Relocalization,
Tracking.cc:969-1131).

All candidates are evaluated in one batched program, gathered from the device
mirror by index: one 5-lane launch of the fused gated match (the frame's
descriptors shared by every lane, the masks-only gate), mutual-best and
rotation consistency over the lanes, then PnP and the pose polish batched
over the lanes, and one read of the [5, 20] head and the [5, N] bindings.
Lanes left over by fewer than five candidates repeat the first one, and the
port takes its best lane (the JAX package reads only the first). The
reference package builds one [N, 5N] distance table and slices it; the fused
kernel never writes it, and its top-2 is bit-exact with the plain chain, so
the matches are the same. The per-candidate acceptance walk and the guided
projection rounds run on the host. The serial per-candidate path of the
reference package is not ported: the system always builds the mirror.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..map.mirror import to_device
from ..map.store import MapStore
from ..matching import core as mcore
from ..optim import optimize_pose
from ..solvers.initializer import GumbelSampler
from ..solvers.pnp import solve_pnp
from ..utils.profiling import HostReads
from ..vocab.database import KeyFrameDatabase
from . import tracking_kernels as tk
from .config import SlamConfig
from .frame import FrameData

RELOC_C = 5  # candidate lanes (reference: up to 5, Tracking.cc:1006)


def _reloc_candidates(frame_desc, frame_valid, frame_angle, xy_un, sigma2, cand_idx,
                      kf_desc, kf_angle, kf_obs_point, pt_xyz, pt_valid, intr, sampler):
    """Every candidate in one batched program: SearchByBoW's match, the
    256-hypothesis PnP RANSAC and the LM polish, one lane per candidate
    keyframe (mirror rows ``cand_idx`` [C]).

    Returns (head [C, 20] float32: n_match, pnp_ok, n_good, 0, Tcw flat 16;
    bind [C, N] int64 global point id per frame feature, -1 unbound)."""
    P = pt_xyz.shape[0]
    cdesc = kf_desc[cand_idx]  # [C, N, 8]
    cobs = kf_obs_point[cand_idx].long()  # [C, N]
    cobs_c = torch.clamp(cobs, 0, P - 1)
    has_pt = (cobs >= 0) & pt_valid[cobs_c]
    res = mcore.match_projected(frame_desc, cdesc, frame_valid, has_pt,
                                max_dist=mcore.TH_LOW, ratio=0.75)
    res = mcore.mutual_best(res, cdesc.shape[1])
    res = mcore.rotation_consistency(frame_angle, kf_angle[cand_idx], res)
    idx = torch.clamp(res.idx, min=0)
    pts = pt_xyz[torch.gather(cobs_c, 1, idx)]  # [C, N, 3] point of each feature's match
    pnp = solve_pnp(pts, xy_un, sigma2, res.ok, intr, sampler)
    opt = optimize_pose(pnp.Tcw, pts, xy_un, sigma2, pnp.inliers, intr)
    bind = torch.where(opt.inlier & res.ok, torch.gather(cobs, 1, idx), torch.full_like(cobs, -1))
    f = torch.float32
    head = torch.cat([torch.stack([res.ok.sum(-1).to(f), pnp.success.to(f),
                                   opt.n_inliers.to(f), torch.zeros_like(opt.n_inliers, dtype=f)],
                                  dim=-1), opt.Tcw.reshape(-1, 16)], dim=-1)
    return head, bind


@dataclass
class Relocalizer:
    cfg: SlamConfig
    store: MapStore
    db: KeyFrameDatabase
    mirror: object  # DeviceMirror
    # PnP hypothesis sampler (solvers.pnp): None = a Gumbel top-k from a
    # generator seeded with 42 on the mirror's device.
    sampler: object = None
    reads: HostReads = field(default_factory=HostReads)
    last_reloc_kf: int = -1  # the matched keyframe of the last success (the new reference)
    last_n_candidates: int = 0

    def __post_init__(self):
        dev = self.mirror.device
        if self.sampler is None:
            self.sampler = GumbelSampler(seed=42, device=dev)
        self._intr = torch.as_tensor(self.cfg.intr, device=dev)

    def _candidates(self, frame: FrameData):
        """BoW retrieval: candidate keyframes in the reference's order
        (DetectRelocalizationCandidates, KeyFrameDatabase.cc:199-336)."""
        st = self.store
        desc, valid = self.reads.numpy_all((frame.feats.desc, frame.feats.valid))
        _, _, bow = self.db.compute_bow(desc, valid)
        cands = self.db.detect_reloc_candidates(
            bow, covis_fn=lambda k: st.covisible_keyframes(k, top=10))
        self.last_n_candidates = len(cands)
        return cands

    def __call__(self, frame: FrameData):
        """Attempt relocalization. Returns (ok, Tcw, bind [N] point ids)."""
        st = self.store
        keep = []
        for kf in self._candidates(frame)[:RELOC_C]:
            kf = int(kf)
            obs_pt = st.kf_obs_point[kf]
            if ((obs_pt >= 0) & st.pt_valid[np.clip(obs_pt, 0, None)]).sum() >= 15:
                keep.append(kf)
        if not keep:
            return False, None, None
        cand_idx = np.full(RELOC_C, keep[0], np.int64)
        cand_idx[: len(keep)] = keep
        mir = self.mirror
        head, bind = _reloc_candidates(
            frame.feats.desc, frame.feats.valid, frame.feats.angle, frame.xy_un, frame.sigma2,
            to_device(cand_idx, mir.device), mir.kf_desc, mir.kf_angle, mir.kf_obs_point,
            mir.pt_xyz, mir.pt_valid, self._intr, self.sampler)
        head, bind = self.reads.numpy_all((head, bind))
        # The reference's per-candidate acceptance walk over the head: the
        # first candidate clearing every gate wins. With fewer candidates
        # than lanes, the spare lanes repeat the first candidate with other
        # PnP draws; its best lane stands for it (the reference iterates a
        # candidate's RANSAC until it succeeds, up to 300 iterations).
        for i, kf in enumerate(keep):
            if i == 0:
                i = max(np.nonzero(cand_idx == kf)[0], key=lambda j: (head[j, 1], head[j, 2]))
            n_match, pnp_ok, n_good = head[i, 0], head[i, 1], head[i, 2]
            if n_match < 15 or pnp_ok < 0.5 or n_good < 10:
                continue  # reference gates (Tracking.cc:1014,1050)
            Tcw = head[i, 4:20].reshape(4, 4).astype(np.float32)
            b = bind[i].astype(np.int64)
            # Binds may reference points culled since the mirror publish.
            b = np.where((b >= 0) & st.pt_valid[np.clip(b, 0, None)], b, -1)
            n_good = int(n_good)
            if n_good < 50:
                # Escalation (Tracking.cc:1079-1108): up to two guided
                # projection rounds over the candidate's covisibility region,
                # a wide window, then a narrow one around the refined pose.
                region_pts = self._region_points(kf)
                for radius in (10.0, 3.0):
                    if n_good >= 50 or len(region_pts) == 0:
                        break
                    Tcw, b, n_good = self._guided_round(frame, Tcw, b, region_pts, radius)
            if n_good < 50:
                continue
            self.last_reloc_kf = kf
            return True, Tcw, b
        return False, None, None

    def _region_points(self, kf: int) -> np.ndarray:
        """Map points of the candidate keyframe's covisibility region."""
        st = self.store
        region = [kf] + [int(k) for k in st.covisible_keyframes(kf, top=10)]
        pts = st.kf_obs_point[region]
        pts = np.unique(pts[pts >= 0])
        return pts[st.pt_valid[pts]]

    def _guided_round(self, frame, Tcw, bind, region_pts, radius):
        """One guided projection match and pose solve, one read."""
        st = self.store
        dev = self.mirror.device
        P = self.cfg.th.max_local_points
        ids = np.zeros(P, np.int64)
        valid = np.zeros(P, bool)
        m = min(len(region_pts), P)
        ids[:m] = region_pts[:m]
        valid[:m] = ~np.isin(ids[:m], bind[bind >= 0])
        prev_bound = bind >= 0
        d = lambda a: to_device(a, dev)  # noqa: E731
        T, lbind, inl, n, _ = tk.track_points(
            d(Tcw.astype(np.float32)), d(st.pt_xyz[ids].astype(np.float32)), d(st.pt_desc[ids]),
            d(valid & st.pt_valid[ids]), torch.zeros(P, dtype=torch.int32, device=dev),
            d(st.pt_normal[ids]), d(st.pt_min_dist[ids]),
            d(np.nan_to_num(st.pt_max_dist[ids], posinf=1e9)), d(prev_bound),
            d(st.pt_xyz[np.clip(bind, 0, None)].astype(np.float32)), d(prev_bound),
            frame, self.cfg.camera, self._intr, radius,
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
            use_frustum=True, ratio=0.9)
        lbind, inl, n, T = self.reads.numpy_all((lbind, inl, n, T))
        new_bind = np.where(lbind >= 0, ids[np.clip(lbind, 0, None)],
                            np.where(prev_bound & inl, bind, -1))
        return T, new_bind, int(n)
