"""SLAM pipeline configuration: camera calibration + extractor + map
capacities + tracking thresholds. Port of os1_tpu/pipeline/config.py: the
same fields and defaults, on the port's own Camera, OrbConfig and MapConfig.

Threshold defaults mirror the reference's hard-coded values (cited inline).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..features.orb import OrbConfig
from ..geometry.camera import Camera
from ..map.store import MapConfig


@dataclass(frozen=True)
class TrackingThresholds:
    min_init_matches: int = 100  # Tracking.cc:361 (nmatches<100 -> retry)
    min_init_triangulated: int = 50  # Initializer min_triangulated
    min_motion_inliers: int = 10  # Tracking.cc:649 (nmatchesMap>=10)
    min_refkf_inliers: int = 10  # Tracking.cc:580
    min_localmap_inliers: int = 30  # Tracking.cc:691 (<30 -> fail)
    motion_search_radius: float = 15.0  # SearchByProjection th (Tracking.cc:609)
    motion_search_radius_retry: float = 30.0  # 2*th retry (Tracking.cc:617)
    localmap_search_radius: float = 4.0  # base radius in px at octave 0
    max_local_keyframes: int = 80  # Tracking.cc:913
    max_local_points: int = 4096  # padded local-map point capacity
    kf_min_frames: int = 0  # mMinFrames (Tracking.cc:703)
    kf_max_frames: int = 30  # mMaxFrames = fps
    kf_ref_ratio: float = 0.9  # thRefRatio mono (Tracking.cc:744)
    kf_baseline_depth_ratio: float = 0.03  # staleness gate (see tracking.py)
    # Rotation-staleness keyframe trigger (not in the reference, which
    # relies on match decay alone — viable there because its mapping
    # latency is ~ms; with a worker-lagged mapper, rotation-dominant motion
    # needs the keyframe BEFORE matches collapse): insert once the view
    # direction has turned this far from the reference keyframe's.
    kf_view_angle_deg: float = 10.0
    kf_min_tracked: int = 15  # Tracking.cc:747
    triangulation_neighbors: int = 10  # LocalMapping.cc:192 (20 stereo, 10 eff.)
    local_ba_keyframes: int = 32  # covisible KFs in local BA
    point_cull_found_ratio: float = 0.25  # LocalMapping.cc:166
    kf_cull_redundancy: float = 0.9  # LocalMapping.cc:556 (90% rule)
    # Hot-path pose-opt schedule (rounds, iters/round, hard accept/reject):
    # the reference runs LM 4 rounds x 10 iters with chi2 reclassification
    # between rounds (Optimizer.cc:284-329); the default compresses that to
    # a damped-GN 3x4 with soft reweighting — A/B'd against (4, 10, True)
    # on the deterministic bench (accuracy.py).
    pose_opt_rounds: int = 3
    pose_opt_iters: int = 4
    pose_opt_reject: bool = False
    # Bounded deferral of the heavy mapping stages (fuse + local BA) under
    # keyframe-queue pressure: they run at the latest every ba_debt_max
    # queued keyframes. 0 restores the reference's pure drain gating
    # (LocalMapping.cc:72: heavy stages only when the queue is empty).
    # Default 1 = heavy stages EVERY keyframe, the reference's steady-state
    # behavior: with the round-4 transport fixes the worker keeps up, and
    # the bench ATE is ~20x better than any deferral setting (deferred BA
    # was the dominant async drift source — 0.18 vs 4.3 measured).
    ba_debt_max: int = 1


@dataclass
class SlamConfig:
    camera: Camera
    orb: OrbConfig = field(default_factory=OrbConfig)
    map: MapConfig = None
    th: TrackingThresholds = field(default_factory=TrackingThresholds)
    enable_far_points: bool = False  # os1 "puntos lejanos" experiment

    def __post_init__(self):
        if self.map is None:
            self.map = MapConfig(n_features=self.orb.n_features)
        assert self.map.n_features == self.orb.n_features

    @property
    def sigma2_table(self) -> np.ndarray:
        return np.asarray(self.orb.sigma2, np.float32)

    @property
    def intr(self) -> np.ndarray:
        return np.array(
            [
                float(self.camera.fx),
                float(self.camera.fy),
                float(self.camera.cx),
                float(self.camera.cy),
            ],
            np.float32,
        )
