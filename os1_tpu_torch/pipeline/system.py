"""System facade: the public API of the SLAM engine. Port of the synchronous
slice of os1_tpu/pipeline/system.py (reference System.cc:41-184).

The slice is ``System(cfg, enable_mapping=True, enable_loop_closing=False,
pipelined=False)``: per frame ORB extraction, the two-view bootstrap with its
initial BA, and the fused tracker against the device-resident map mirror; per
keyframe the keyframe is materialized, its mirror row published, local
mapping run (triangulation, fusion, local BA, culling) and the mirror
refreshed, before the next frame. ``enable_mapping=False`` is the
localization-only mode. Every option outside the slice raises
``NotImplementedError`` naming the ROADMAP item that brings it.

The system runs on the card: ``device=None`` means ``cuda`` and raises when
there is none; only an explicit ``device="cpu"`` runs it on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import default_device
from ..geometry import se3
from ..map.mirror import DeviceMirror
from ..map.store import MapStore
from ..utils.profiling import StageTimer
from .config import SlamConfig
from .frame import unpack_host
from .local_mapping import LocalMapper
from .tracking import Tracker, TrackingState


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to os1_tpu_torch yet (ROADMAP.md queue 1, {item})")


@dataclass
class System:
    cfg: SlamConfig
    enable_mapping: bool = True
    enable_loop_closing: bool = True
    pipelined: bool = False
    async_mapping: bool = False
    coop_mapping: bool = False
    distributed: bool | None = None
    store: MapStore = None
    device: torch.device | str | None = None  # None: cuda, or raise without a card
    sampler: object = None  # RANSAC hypothesis sampler (see Tracker)
    tracker: Tracker = field(init=False)

    def __post_init__(self):
        if self.enable_loop_closing:
            raise _not_ported("Loop closing (enable_loop_closing=True)", "item 10")
        if self.pipelined:
            raise _not_ported("Pipelined tracking (pipelined=True)", "item 7")
        if self.async_mapping or self.coop_mapping:
            raise _not_ported("Worker and cooperative mapping", "item 7: workers.py")
        if self.distributed:
            raise _not_ported("The distributed back end (distributed=True)", "item 12")
        self.device = torch.device(self.device) if self.device is not None else default_device()
        if self.store is None:
            self.store = MapStore(self.cfg.map)
        self.timer = StageTimer()
        self.tracker = Tracker(cfg=self.cfg, store=self.store, device=self.device,
                               sampler=self.sampler, timer=self.timer)
        self.reads = self.tracker.reads
        self.mirror = DeviceMirror(self.store, self.device)
        self.tracker.mirror = self.mirror
        self.mapper = None
        if self.enable_mapping:
            self.mapper = LocalMapper(cfg=self.cfg, store=self.store, mirror=self.mirror,
                                      timer=self.timer, reads=self.reads)
            self.mapper.protected_kf_fn = lambda: self.tracker.ref_kf
        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.on_reset = self._on_reset
        self._kf_count = 0
        # Keyframes whose feature arrays are still on the device (kf -> FrameData).
        self._pending_frames = {}

    def _on_reset(self):
        self._kf_count = 0
        self._pending_frames.clear()
        self.mirror.refresh()

    def set_timer(self, timer: StageTimer) -> None:
        """Use ``timer`` for every stage of the tracker and the mapper."""
        self.timer = self.tracker.timer = timer
        if self.mapper is not None:
            self.mapper.timer = timer

    def _on_new_keyframe(self, kf: int, bootstrap: bool = False, frame=None):
        """Synchronous keyframe event (the reference package's inline branch):
        materialize the keyframe's feature arrays, publish its mirror row,
        run local mapping on it, and publish the changed map state, all
        before the next frame."""
        self._kf_count += 1
        if frame is not None:
            self._pending_frames[kf] = frame
        self._materialize_kf(kf)
        with self.timer("mirror.refresh"):
            self.mirror.insert_keyframe_row(kf)
            self.mirror.refresh_dynamic()
        if self.mapper is not None:
            self.mapper.process(kf, bootstrap=bootstrap)
            with self.timer("mirror.refresh"):
                self.mirror.refresh_dynamic()

    def _materialize_kf(self, kf: int):
        frame = self._pending_frames.pop(kf, None)
        if frame is None:
            return
        with self.timer("lm.materialize"):
            pack = self.reads.numpy(frame.host_pack)
            if not self.store.kf_valid[kf]:
                return
            self.store.materialize_keyframe(kf, *unpack_host(pack))
            self.mirror.insert_keyframe_row(kf)
            # Normal/scale/descriptor refresh for the points this keyframe
            # observes (ProcessNewKeyFrame, LocalMapping.cc:134-147).
            obs = self.store.kf_obs_point[kf]
            pts = np.unique(obs[obs >= 0])
            self.store.update_point_derived(pts, self.cfg.orb.scale_factor,
                                            self.cfg.orb.n_levels)

    # ------------------------------------------------------------------ #
    def track_monocular(self, img, timestamp: float = 0.0):
        """Feed one grayscale (or RGB) image. Returns (state, Tcw | None)
        (System::TrackMonocular, System.cc:115-152)."""
        img = np.asarray(img)
        if img.ndim == 3:
            from ..ops.image import rgb_to_gray

            img = rgb_to_gray(torch.as_tensor(img)).numpy()
        return self.tracker.track(img, timestamp)

    def reset(self):
        self.tracker.reset()

    def flush(self):
        """End of stream. The synchronous slice keeps nothing in flight."""

    def shutdown(self):
        self.flush()

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    def save_map(self, base: str, options: int = 0):
        raise _not_ported("save_map", "item 11")

    def load_map(self, base: str):
        raise _not_ported("load_map", "item 11")

    def merge_session(self, base: str, max_probes: int = 8, run_gba: bool = True):
        raise _not_ported("merge_session", "item 11")

    # ------------------------------------------------------------------ #
    def keyframe_trajectory(self):
        """[(timestamp, Twc 4x4)] for all live keyframes, sorted by time."""
        st = self.store
        out = []
        for k in np.nonzero(st.kf_valid)[0]:
            Tcw = st.kf_T[k]
            R = Tcw[:3, :3]
            Twc = np.eye(4, dtype=np.float64)
            Twc[:3, :3] = R.T
            Twc[:3, 3] = -R.T @ Tcw[:3, 3]
            out.append((float(st.kf_timestamp[k]), Twc))
        out.sort(key=lambda x: x[0])
        return out

    def frame_trajectory(self):
        """[(timestamp, frame_id, Tcw)] for every tracked frame, re-anchored
        through each frame's reference keyframe's current pose."""
        return self.tracker.frame_trajectory()

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format: 'timestamp tx ty tz qx qy qz qw' per keyframe."""
        with open(path, "w") as f:
            for ts, Twc in self.keyframe_trajectory():
                q = se3.to_quaternion(torch.as_tensor(Twc[:3, :3])).numpy()
                t = Twc[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
