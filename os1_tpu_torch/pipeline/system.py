"""System facade: the public API of the SLAM engine. Port of
os1_tpu/pipeline/system.py (reference System.cc:41-184).

The shipped configuration is ``System(cfg, pipelined=True, coop_mapping=True)``:
pipelined tracking against the device-resident map mirror, and each
keyframe's mapping (materialize + BoW, culling, triangulation, fusion, local
BA) and loop-closing attempt (detection, the Sim3 candidates, correction, the
essential graph, chunked global BA) spread over the following frames by the
cooperative scheduler, one step a frame. ``async_mapping=True`` is the
reference's thread topology, the default of ``run_slam``: the tracker on the
caller's thread, local mapping on a LocalMapping thread, loop closing on a
LoopClosing thread and each global BA on a transient GlobalBA thread
(``workers.py``), all sharing one map lock (``lock``), with the mapping pass
advanced one stage a tracked frame (``MappingWorker.pacer``); it is not
deterministic. ``coop_mapping=False`` runs the keyframe event inline before
the next frame; ``pipelined=False`` applies each frame's result before
returning. In every mode the system keeps a BoW keyframe database and
relocalizes from LOST. ``enable_mapping=False`` is the localization-only mode;
``enable_loop_closing=False`` skips loop closing. Maps persist in the Osmap
format (``save_map``, ``load_map``, and ``merge_session``, which aligns
another session's map into this one).

The distributed back end (``parallel/``) follows the reference's rule:
``distributed=None`` shards whenever the system runs on a card and more than
one card exists, ``True`` requires a mesh (``RuntimeError`` without one),
``False`` forces a single device. With a mesh, local BA and global BA run
landmark-sharded through the resumable protocol and the essential graph runs
edge-sharded, one reduction an LM iteration, in every mode. ``mesh=`` gives
the mesh explicitly, as a ``parallel.Mesh`` whose positions may share a
device (eight shards on one card or on the CPU stand where the reference's
tests put eight virtual devices). The synchronous global BA of
``merge_session`` stays single-device, as the reference's does.

The system runs on the card: ``device=None`` means ``cuda`` and raises when
there is none; only an explicit ``device="cpu"`` runs it on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import default_device
from ..geometry import se3, sim3
from ..io import osmap_io
from ..map.mirror import DeviceMirror
from ..map.store import MapStore
from ..parallel import Mesh, MeshBABackend, default_mesh_backend
from ..utils import transfer
from ..utils.profiling import StageTimer, detached
from ..vocab.database import KeyFrameDatabase
from ..vocab.dbow2 import default_vocabulary, load_binary
from ..vocab.tree import Vocabulary
from .config import SlamConfig
from .frame import unpack_host
from .local_mapping import LocalMapper, global_bundle_adjustment
from .loop_closing import LoopCloser
from .relocalization import Relocalizer
from .tracking import Tracker, TrackingState
from .workers import CoopScheduler, LoopWorker, MapLock, MappingWorker

WAIT_S = 120.0  # longest wait for a worker to go idle or a global BA to end


@dataclass
class System:
    cfg: SlamConfig
    enable_mapping: bool = True
    enable_loop_closing: bool = True
    pipelined: bool = False
    async_mapping: bool = False  # the worker threads; coop_mapping is then ignored
    coop_mapping: bool = False
    # None: shard over the cards when more than one exists; True: require a
    # mesh; False: force a single device.
    distributed: bool | None = None
    mesh: Mesh | None = None  # an explicit mesh for the distributed back end
    store: MapStore = None
    device: torch.device | str | None = None  # None: cuda, or raise without a card
    sampler: object = None  # two-view RANSAC hypothesis sampler (see Tracker)
    # Place-recognition vocabulary: a Vocabulary, a path to a DBoW2 binary, or
    # None for the repository's default (vocab/dbow2.py).
    vocab: Vocabulary | str | None = None
    tracker: Tracker = field(init=False)

    def __post_init__(self):
        if self.mesh is not None and self.distributed is False:
            raise ValueError("a mesh was given with distributed=False")
        self.device = torch.device(self.device) if self.device is not None else default_device()
        if self.store is None:
            self.store = MapStore(self.cfg.map)
        self.timer = StageTimer()
        # One map lock (Map::mMutexMapUpdate, Map.h:140), shared by the
        # tracker, the mapper, the loop closer and this facade.
        self.lock = MapLock()
        self.tracker = Tracker(cfg=self.cfg, store=self.store, device=self.device,
                               sampler=self.sampler, timer=self.timer, pipelined=self.pipelined,
                               lock=self.lock)
        self.reads = self.tracker.reads
        self.mirror = DeviceMirror(self.store, self.device)
        self.tracker.mirror = self.mirror
        self.mapper = LocalMapper(cfg=self.cfg, store=self.store, mirror=self.mirror,
                                  timer=self.timer, reads=self.reads, lock=self.lock)
        self.mapper.protected_kf_fn = lambda: self.tracker.ref_kf

        # Place recognition (System.cc:100 loads the vocabulary).
        if self.vocab is None:
            self.vocab = default_vocabulary(self.device)
        elif isinstance(self.vocab, str):
            self.vocab = load_binary(self.vocab)
        self.db = KeyFrameDatabase(self.vocab, self.cfg.map.max_keyframes)
        self.relocalizer = Relocalizer(cfg=self.cfg, store=self.store, db=self.db,
                                       mirror=self.mirror, reads=self.reads)
        self.tracker.relocalizer = self.relocalizer
        self.loop_closer = LoopCloser(cfg=self.cfg, store=self.store, db=self.db,
                                      device=self.device, timer=self.timer, reads=self.reads,
                                      lock=self.lock, on_map_updated=self._publish_after_gba,
                                      on_corrected=self._after_loop_correction)
        self.tracker.loop_closing_active = lambda: self.loop_closer.closing_active
        self.mapper.on_cull_keyframe = self.db.erase
        self.tracker.on_new_keyframe = self._on_new_keyframe
        # Distributed solver backend (configs 4-5); no quiet fallback.
        self.mesh_backend = None
        if self.mesh is not None:
            self.mesh_backend = MeshBABackend(self.mesh)
        elif self.distributed is not False:
            self.mesh_backend = default_mesh_backend(self.device)
            if self.mesh_backend is None and self.distributed is True:
                raise RuntimeError("distributed=True requires more than one device")
        self.mapper.mesh_backend = self.loop_closer.mesh_backend = self.mesh_backend
        self.tracker.on_reset = self._on_reset
        self._kf_count = 0
        # Keyframes whose feature arrays are still on the device:
        # kf -> (FrameData, its host_pack's announced copy).
        self._pending_frames = {}

        self.mapping_worker = None
        self.loop_worker = None
        self.coop = None
        if self.async_mapping:
            if self.enable_loop_closing:
                self.loop_worker = LoopWorker(self._loop_process, self.lock)
            self.mapping_worker = MappingWorker(self.mapper, self.lock,
                                                on_process=self._worker_prepare,
                                                on_pass_done=self._worker_pass_done,
                                                loop_worker=self.loop_worker)
            self.loop_closer.mapping_worker = self.mapping_worker
            self.tracker.mapping_idle = lambda: self.mapping_worker.accepting
            self.tracker.interrupt_ba = self.mapping_worker.interrupt_ba
            self.mapper.pending_fn = self.mapping_worker.queue_size
            self.mapper.queued_fn = self.mapping_worker.queued
        elif self.coop_mapping:
            self.coop = CoopScheduler(self.mapper,
                                      loop_steps=self._loop_steps if self.enable_loop_closing
                                      else None,
                                      on_prepare=self._worker_prepare,
                                      on_pass_done=self._worker_pass_done)
            self.tracker.mapping_idle = lambda: self.coop.accepting
            self.tracker.interrupt_ba = lambda: setattr(self.mapper, "abort_ba", True)
            self.mapper.pending_fn = self.coop.queue_size

    def _loop_steps(self, kf: int):
        return self.loop_closer.process_steps(kf, self._kf_count)

    def _on_reset(self):
        # As in the reference package, the loop closer keeps its loop edges
        # and consistency groups across a reset.
        if self.mapping_worker is not None:
            self.mapping_worker.request_reset()
        if self.loop_worker is not None:
            self.loop_worker.request_reset()
        if self.coop is not None:
            self.coop.clear()
        self.db.clear()
        self._kf_count = 0
        self._pending_frames.clear()
        self.mirror.refresh()

    def set_timer(self, timer: StageTimer) -> None:
        """Use ``timer`` for every stage of the tracker (its fused step's
        too), the mapper and the loop closer, and for the waits of the host
        reads they share (``host.read``)."""
        self.timer = self.mapper.timer = self.loop_closer.timer = timer
        self.tracker.set_timer(timer)

    def _on_new_keyframe(self, kf: int, bootstrap: bool = False, frame=None):
        """A keyframe event, on the tracker's thread under the map lock.
        Threaded or cooperative: publish the keyframe's mirror row from the
        device frame, so the very next frame can track against it, and queue
        the mapping pass. Inline: materialize and BoW, publish the row, map,
        publish, all before the next frame."""
        self._kf_count += 1
        if frame is not None:
            # The feature arrays stay on the device; their copy to the host
            # starts now and is read when the keyframe is materialized.
            self._pending_frames[kf] = (frame, transfer.announce(frame.host_pack))
        if self.mapping_worker is not None or self.coop is not None:
            with self.timer("mirror.refresh"):
                if frame is not None:
                    self.mirror.insert_keyframe_row_device(kf, frame)
                else:
                    self.mirror.insert_keyframe_row(kf)
                self.mirror.refresh_dynamic()
            if not self.enable_mapping:
                self._worker_prepare(kf)  # keep the relocalization database current
            elif self.mapping_worker is not None:
                self.mapping_worker.insert_keyframe(kf, bootstrap=bootstrap)
            else:
                self.coop.insert(kf, bootstrap=bootstrap)
            return
        self._worker_prepare(kf)
        # The mapper gathers keyframe rows from the mirror by index, so row kf
        # is published before it runs.
        with self.timer("mirror.refresh"):
            self.mirror.insert_keyframe_row(kf)
            self.mirror.refresh_dynamic()
        if self.enable_mapping:
            self.mapper.process(kf, bootstrap=bootstrap)
            if self.enable_loop_closing and not bootstrap:
                with self.timer("loop.process"):
                    self.loop_closer.process(kf, self._kf_count)
            with self.timer("mirror.refresh"):
                self.mirror.refresh_dynamic()

    def _worker_prepare(self, kf: int):
        """First step of a keyframe event: materialize the deferred feature
        arrays (the reference's ProcessNewKeyFrame bookkeeping,
        LocalMapping.cc:125-153) and add the keyframe's BoW vector to the
        place-recognition database. False if the keyframe died meanwhile (a
        cull or a reset): the worker thread then skips its pass."""
        self._materialize_kf(kf)
        st = self.store
        with self.timer("bow.compute"):
            with self.lock:
                if not st.kf_valid[kf]:
                    return False
                desc, valid = st.kf_desc[kf].copy(), st.kf_feat_valid[kf].copy()
            _, _, bow = self.db.compute_bow(desc, valid)  # host descent, outside the lock
            with self.lock:
                if st.kf_valid[kf]:
                    self.db.add(kf, bow)
        return True

    def _materialize_kf(self, kf: int):
        pending = self._pending_frames.pop(kf, None)
        if pending is None:
            return
        with self.timer("lm.materialize"):
            pack = transfer.fetch(pending[1], self.reads)  # outside the lock
            with self.lock:
                if not self.store.kf_valid[kf]:
                    return
                self.store.materialize_keyframe(kf, *unpack_host(pack))
                # Re-publish the static feature row from the now complete
                # store, which is authoritative for the row from here on.
                self.mirror.insert_keyframe_row(kf)
                # Normal/scale/descriptor refresh for the points this keyframe
                # observes (ProcessNewKeyFrame, LocalMapping.cc:134-147).
                obs = self.store.kf_obs_point[kf]
                pts = np.unique(obs[obs >= 0])
                self.store.update_point_derived(pts, self.cfg.orb.scale_factor,
                                                self.cfg.orb.n_levels)

    def _worker_pass_done(self, kf: int):
        with self.timer("mirror.refresh"), self.lock:
            self.mirror.refresh_dynamic()

    def _publish_after_gba(self):
        with self.lock:
            self.mirror.refresh_dynamic()

    def _loop_process(self, kf: int):
        """The LoopClosing thread's pass for one keyframe. The corrected map
        is published by the correction's re-anchoring and the global BA's
        write-back (the reference package refreshes the mirror once more)."""
        if not self.enable_mapping:
            return
        with self.timer("loop.process"):
            self.loop_closer.process(kf, self._kf_count)

    def _after_loop_correction(self):
        """Re-anchor the tracker after a loop correction moved the world:
        publish the corrected map, drop the frames in flight (their pose chain
        is anchored in the old world) to track them again, and remap the last
        frame's pose through its reference keyframe's corrected pose.

        The motion model survives a remap: it is a camera-to-camera motion,
        and the previous pose is remapped with the last one. The dropped
        frames, and a frame whose dispatch or read straddles the drop, are
        tracked again on a new chain from the remapped pose before the next
        frame (``Tracker.drop_in_flight(replay=True)``), so each is predicted
        one frame ahead of the frame before it. The reference package clears
        the motion model and discards the frames in flight: its next frame
        is then predicted with no motion, three frames past the last one
        applied; a kept motion model bridged that gap in the cooperative
        mode, but on another thread the correction can land while a frame is
        between its dispatch and its tail: on bench.py's loop sequence on an
        NVIDIA H100 the next frame, four frames past the last one applied,
        found almost no inliers at the motion search's first radius at every
        correction, and was lost whenever the retry and the
        reference-keyframe fallback failed too
        (``scripts/threaded_repeats.py --trace``).

        With the worker threads on, this runs on the LoopClosing thread under
        the map lock, which the tracker holds over a dispatch's snapshot and
        over a result's tail."""
        with self.lock:
            self.mirror.refresh()
            tr = self.tracker
            tr.drop_in_flight(replay=True)
            tr._prev_Tcw = None
            remapped = False
            if tr.last is not None and tr.trajectory:
                ts, fid, ref, seq, T_rel, _ = tr.trajectory[-1]
                if (fid == tr.last.frame_id and ref >= 0 and self.store.kf_valid[ref]
                        and self.store.kf_seq[ref] == seq):
                    tr.last.Tcw = (T_rel @ self.store.kf_T[ref]).astype(np.float32)
                    remapped = True
            if remapped and tr.velocity is not None:
                tr._prev_Tcw = (np.linalg.inv(tr.velocity) @ tr.last.Tcw).astype(np.float32)
            else:
                tr.velocity = None

    # ------------------------------------------------------------------ #
    def warmup(self, include_loop: bool = True) -> float:
        """Pay the first-use costs before the first frame, and return the
        seconds it took. On a card these are not compiles (the JAX package's
        warm-up fills the XLA cache): the ``csrc/`` builds, the lazy loading
        of CUDA modules, the cuBLAS and cuSOLVER handles behind
        ``torch.linalg``, the caching allocator's first growth at each
        bucket shape and the first launch of each program. Each program the
        pipeline runs is launched once, on zero inputs at the port's shapes:
        the frame builder on both input dtypes, the fused tracker step, the
        bootstrap and the median depth, the mirror's keyframe-row insert,
        the local-map search, the BoW descent, the relocalization candidates
        program (match, PnP and polish on 5 lanes), the mapper's programs
        (``LocalMapper.warmup``) and, with ``include_loop``, a Sim3 candidate
        program and the essential graph at 256 and 1024 edges.

        The system is left as it was: no keyframe, point or database entry,
        the tracker's state and the samplers' draws untouched, the mirror
        republished from the store, no stage added to the stage timer (the
        fused step and the host reads run detached from it). The kernel
        launches made inside are kept out of the wrappers' counters and
        reported in ``self.warmup_launches``."""
        import time

        from ..ops.cuda_build import launches_apart, load_libraries
        from ..ops.pallas_hamming import gated_match_cuda, hamming_matrix_cuda
        from ..ops.patches import extract_patches_cuda, sample_patches_cuda
        from ..solvers.initializer import GumbelSampler
        from . import tracking_kernels as tk
        from .loop_closing import PROJ_CAP, sim3_candidate_program
        from .relocalization import RELOC_C, _reloc_candidates

        t0 = time.perf_counter()
        kernels = (gated_match_cuda, hamming_matrix_cuda, extract_patches_cuda,
                   sample_patches_cuda)
        cfg, tr, mir, dev = self.cfg, self.tracker, self.mirror, self.device
        N, L, K = cfg.orb.n_features, cfg.th.max_local_points, self.store.cfg.max_keyframes
        reads0 = self.reads.count
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        eye = torch.eye(4, device=dev)
        with launches_apart(kernels) as launched, detached(tr._fused, self.reads):
            load_libraries(cuda=dev.type == "cuda")
            # The frame builder on both input dtypes, the fused step.
            tr._build(z(cfg.orb.height, cfg.orb.width, dtype=torch.uint8), tr.camera)
            frame = tr._build(z(cfg.orb.height, cfg.orb.width), tr.camera)
            mirror = (mir.pt_xyz, mir.pt_desc, mir.pt_valid, mir.pt_normal, mir.pt_min_dist,
                      mir.pt_max_dist, mir.kf_desc, mir.kf_angle, mir.kf_obs_point)
            out = tr._fused(*mirror, frame, tr.camera, tr._intr, eye, eye,
                            torch.full((N,), -1, dtype=torch.int64, device=dev),
                            frame.feats.octave, 0, False, z(L, dtype=torch.int32),
                            z(L, dtype=torch.bool), False)
            transfer.fetch(transfer.announce(out["packed"]), self.reads)
            # Initialization: the bootstrap (its own draws), the median depth,
            # the keyframe-row inserts.
            self.reads.numpy(tk.bootstrap(frame, frame, tr._K, GumbelSampler(0, dev))[2])
            self.reads.item(tk.compute_median_depth(eye, mir.pt_xyz, mir.pt_valid))
            mir.insert_keyframe_row_device(0, frame)
            mir.insert_keyframe_row(0)
            mir.refresh_dynamic()
            # The local-map search after a relocalization.
            pts = torch.ones(L, 3, device=dev)
            pts[:, 2] = 5.0
            self.reads.numpy_all(tk.track_points(
                eye, pts, z(L, 8, dtype=torch.int32), z(L, dtype=torch.bool),
                z(L, dtype=torch.int32), z(L, 3), z(L), torch.full((L,), 100.0, device=dev),
                z(N, dtype=torch.bool), z(N, 3), z(N, dtype=torch.bool), frame, tr.camera,
                tr._intr, cfg.th.localmap_search_radius, scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels, use_frustum=True, ratio=0.8)[:1])
            # Place recognition and relocalization (its own draws).
            self.db.compute_bow(np.zeros((N, 8), np.uint32), np.zeros(N, bool))
            self.reads.numpy_all(_reloc_candidates(
                frame.feats.desc, frame.feats.valid, frame.feats.angle, frame.xy_un,
                frame.sigma2, z(RELOC_C, dtype=torch.int64), mir.kf_desc, mir.kf_angle,
                mir.kf_obs_point, mir.pt_xyz, mir.pt_valid, tr._intr, GumbelSampler(42, dev)))
            self.mapper.warmup()
            if include_loop:
                lc = self.loop_closer
                zeros = lambda *shape, dtype=np.float32: np.zeros(shape, dtype)  # noqa: E731
                xyz = zeros(N, 3)
                xyz[:, 2] = 5.0
                region_xyz = zeros(PROJ_CAP, 3)
                region_xyz[:, 2] = 5.0
                side = dict(desc=zeros(N, 8, dtype=np.uint32), bound=zeros(N, dtype=bool),
                            angle=zeros(N), xy=zeros(N, 2), oct=zeros(N, dtype=np.int32),
                            xyz=xyz)
                snap = {f"{k}{i}": v for i in (1, 2) for k, v in side.items()}
                snap.update(feat_valid1=zeros(N, dtype=bool),
                            region_desc=zeros(PROJ_CAP, 8, dtype=np.uint32),
                            region_xyz=region_xyz, region_ok=zeros(PROJ_CAP, dtype=bool),
                            T_lw=np.eye(4, dtype=np.float32))
                self.reads.numpy(sim3_candidate_program(
                    **transfer.upload(snap, dev), intr=lc._intr, sigma2_table=lc._sigma2,
                    sampler=GumbelSampler(7, dev))[0])
                S = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
                fixed = np.zeros(K, bool)
                fixed[0] = True
                for E in (256, 1024):
                    self.reads.numpy(lc.essential_graph(
                        S, np.ones(K, bool), fixed, np.zeros(E, np.int64), np.ones(E, np.int64),
                        np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))))
            mir.refresh()  # the device-inserted row 0 goes back to the store's
        self.warmup_launches = launched
        self.reads.count = reads0
        return time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    def track_monocular(self, img, timestamp: float = 0.0):
        """Feed one grayscale (or RGB) image. Returns (state, Tcw | None)
        (System::TrackMonocular, System.cc:115-152); pipelined, of the frame
        applied last."""
        img = np.asarray(img)
        if img.ndim == 3:
            from ..ops.image import rgb_to_gray

            img = rgb_to_gray(torch.as_tensor(img)).numpy()
        out = self.tracker.track(img, timestamp)
        if self.mapping_worker is not None:
            self.mapping_worker.pacer.tick()  # the LocalMapping thread's next stage may start
        if self.coop is not None:
            # One mapping step a frame, two under backlog: the stage
            # dispatched last frame has had a frame's worth of device time.
            self.coop.step(budget=2 if self.coop.queue_size() >= 2 else 1)
        return out

    def set_far_parallax_param(self, param: int):
        """The reference viewer's 'Parametro' trackbar (0..1000,
        Viewer.cc:133): below 998 it sets the far-point classification
        threshold umbralCos = 0.9 + param / 10000 (LocalMapping.cc:202-204);
        998 and above disable the umbralCosBajo band."""
        self.mapper.far_cos_user = 0.9 + param / 10000.0 if param < 998 else 0.9998

    def activate_localization_mode(self):
        """Stop mapping and track against the frozen map (System.cc:154-158):
        no keyframes and no point statistics are written afterwards."""
        self.enable_mapping = False
        self.tracker.only_tracking = True
        if self.coop is not None:
            self.coop.drain()
        self._wait_workers()

    def deactivate_localization_mode(self):
        self.enable_mapping = True
        self.tracker.only_tracking = False

    def reset(self):
        self.tracker.reset()  # on_reset clears the scheduler and the database

    def flush(self):
        """End of stream: apply the frames in flight and run the queued
        keyframe events to completion (with the worker threads on, wait until
        both are idle and the global BA has ended)."""
        self.tracker.flush()
        if self.coop is not None:
            self.coop.drain()
        self._wait_workers()

    def _wait_workers(self):
        """Wait for the mapping worker, then the loop worker, then a running
        global BA, with the mapping pass no longer paced by frames; raises if
        one of them is still busy after ``WAIT_S``."""
        if self.mapping_worker is None:
            return
        with self.mapping_worker.pacer.free_running():
            if not self.mapping_worker.wait_idle(WAIT_S):
                raise RuntimeError(f"the LocalMapping thread is still busy after {WAIT_S} s")
            if self.loop_worker is not None and not self.loop_worker.wait_idle(WAIT_S):
                raise RuntimeError(f"the LoopClosing thread is still busy after {WAIT_S} s")
            if not self.loop_closer.wait_gba(WAIT_S):
                raise RuntimeError(f"the GlobalBA thread is still running after {WAIT_S} s")

    def worker_errors(self) -> list:
        """(thread, keyframe or None, exception) for every exception the
        worker threads caught; empty in a sound run."""
        out = []
        for name, w in (("LocalMapping", self.mapping_worker), ("LoopClosing", self.loop_worker)):
            if w is not None:
                out += [(name, kf, exc) for kf, exc in w.errors]
        out += [("GlobalBA", None, exc) for exc in self.loop_closer.gba_errors]
        return out

    def shutdown(self):
        """Stop the worker threads (System::Shutdown, System.cc:169-182)."""
        try:
            self.flush()
        finally:
            self.loop_closer.abort_gba()
            if self.mapping_worker is not None:
                self.mapping_worker.shutdown()
            if self.loop_worker is not None:
                self.loop_worker.shutdown()

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    # ------------------------------------------------------------------ #
    # Osmap persistence (os1's Osmap::mapSave / mapLoad, Osmap.cpp:68-291)
    # ------------------------------------------------------------------ #
    def save_map(self, base: str, options: int = 0) -> dict:
        """Write the map in the Osmap format (``io/osmap_io.py``); returns the
        header. Like the reference, which stops local mapping for the save
        (Osmap.cpp:70-73), the cooperative scheduler is drained first, so
        every keyframe is materialized before it is written; the worker
        threads are waited for."""
        if self.coop is not None:
            self.coop.drain()
        self._wait_workers()
        with self.timer("osmap.save"), self.lock:
            return osmap_io.save_map(self.store, self.cfg, base, options)

    def load_map(self, base: str) -> dict:
        """Replace the map with an Osmap map and resume LOST: the next frames
        relocalize into it (Osmap::mapLoad). The queued keyframe events and
        the frames in flight belong to the old map and are dropped; the
        loop closer's edges and consistency groups stay, as in the
        reference. Returns the header."""
        if self.coop is not None:
            self.coop.clear()
        for w in (self.mapping_worker, self.loop_worker):
            if w is not None:
                w.request_reset()
        self._wait_workers()
        self._pending_frames.clear()
        tr = self.tracker
        tr.drop_in_flight()
        tr._prev_Tcw = None
        st = self.store
        with self.timer("osmap.load"), self.lock:
            header = osmap_io.load_map(st, self.cfg, base)
            self.db.clear()
            kfs = np.nonzero(st.kf_valid)[0]
            for k in kfs:
                _, _, bow = self.db.compute_bow(st.kf_desc[k], st.kf_feat_valid[k])
                self.db.add(int(k), bow)
        with self.lock:
            tr.state = TrackingState.LOST
            tr.last = None
            tr.velocity = None
            tr.ref_kf = int(kfs[-1]) if len(kfs) else -1
            self.mirror.refresh()
        return header

    def merge_session(self, base: str, max_probes: int = 8, run_gba: bool = True) -> bool:
        """Merge another session's Osmap map into the live one (multi-session
        mapping). Up to ``max_probes`` of the loaded keyframes, those with the
        most features first, query the BoW database; each one's two best
        resident candidates go through loop closing's Sim3 candidate program
        until one aligns. The loaded map is then moved into this map's world
        frame, the aligned pair's duplicate points are fused, and a global BA
        (``run_gba``) polishes the joint map. Returns True if an alignment was
        found; on False the loaded keyframes and points are removed again.
        The worker threads are waited for, and the merge holds the map lock."""
        if self.coop is not None:
            self.coop.drain()
        self._wait_workers()
        with self.lock:
            return self._merge(base, max_probes, run_gba)

    def _merge(self, base: str, max_probes: int, run_gba: bool) -> bool:
        st, lc = self.store, self.loop_closer
        kf_map, pt_map = osmap_io.merge_map(st, self.cfg, base)
        merged_kfs = kf_map[kf_map >= 0]
        loaded = pt_map[pt_map >= 0]
        merged_pts = np.zeros(st.cfg.max_points, bool)
        merged_pts[loaded[st.pt_valid[loaded]]] = True
        # BoW vectors of the loaded keyframes: queries only until they align.
        bows = {int(k): self.db.compute_bow(st.kf_desc[k], st.kf_feat_valid[k])[2]
                for k in merged_kfs}

        hit = None
        probes = sorted(merged_kfs.tolist(), key=lambda k: -int(st.kf_feat_valid[k].sum()))
        with self.timer("merge.align"):
            for k in probes[:max_probes]:
                cands, _ = self.db.query(bows[k])
                for cand in cands[:2].tolist():
                    ok, S_cl, pairs = lc._fetch_sim3(
                        lc._dispatch_sim3(lc._snapshot_sim3(k, cand)), k, cand)
                    if ok:
                        hit = (k, cand, S_cl, pairs)
                        break
                if hit:
                    break
        if hit is None:  # no overlap: roll the load back
            for k in merged_kfs:
                st.cull_keyframe(int(k))
            dead = np.nonzero(merged_pts & st.pt_valid)[0]
            if len(dead):
                st.cull_points(dead)
            self.mirror.refresh()
            return False

        kf, cand, S_cl, pairs = hit
        # S_cl maps cand's camera to kf's. With cand's pose T_lw in this
        # world (A) and kf's T_kb in the loaded one (B), B maps into A by
        # X_A = S_ba X_B, S_ba = (S_cl T_lw)^-1 T_kb.
        pids = np.nonzero(merged_pts & st.pt_valid)[0]
        dev = transfer.upload(dict(S_cl=S_cl, T_lw=st.kf_T[cand], T_kb=st.kf_T[kf],
                                   xyz=st.pt_xyz[pids], T=st.kf_T[merged_kfs]), self.device)
        S_ba = sim3.inverse(dev["S_cl"] @ dev["T_lw"]) @ dev["T_kb"]
        S_ab = sim3.inverse(S_ba)
        xyz = dev["xyz"] @ S_ba[:3, :3].T + S_ba[:3, 3]
        T = sim3.to_se3(dev["T"] @ S_ab)
        st.pt_xyz[pids], st.kf_T[merged_kfs] = self.reads.numpy_all((xyz, T))

        # The Sim3 inlier pairs see the same physical points: keep the
        # resident one of each duplicate.
        obs_kf, obs_cand = st.kf_obs_point[kf], st.kf_obs_point[cand]
        for fk, fc in pairs:
            p_b, p_a = int(obs_kf[fk]), int(obs_cand[fc])
            if p_b < 0 or p_a < 0 or p_b == p_a:
                continue
            if st.pt_valid[p_b] and st.pt_valid[p_a]:
                st.replace_point(p_b, p_a)
        st.update_point_derived(pids[st.pt_valid[pids]], self.cfg.orb.scale_factor,
                                self.cfg.orb.n_levels)
        # Spanning tree and place recognition for the merged side.
        st.kf_parent[kf] = cand
        lc.loop_edges.append((min(kf, cand), max(kf, cand)))
        for k in merged_kfs:
            self.db.add(int(k), bows[int(k)])
        self.mirror.refresh()
        if run_gba:
            with self.timer("merge.gba"):
                global_bundle_adjustment(st, self.cfg, self.device, iters=20, reads=self.reads)
            self.mirror.refresh()
        return True

    # ------------------------------------------------------------------ #
    def keyframe_trajectory(self):
        """[(timestamp, Twc 4x4)] for all live keyframes, sorted by time."""
        st = self.store
        out = []
        with self.lock:
            poses = [(float(st.kf_timestamp[k]), st.kf_T[k].copy())
                     for k in np.nonzero(st.kf_valid)[0]]
        for ts, Tcw in poses:
            R = Tcw[:3, :3]
            Twc = np.eye(4, dtype=np.float64)
            Twc[:3, :3] = R.T
            Twc[:3, 3] = -R.T @ Tcw[:3, 3]
            out.append((ts, Twc))
        out.sort(key=lambda x: x[0])
        return out

    def frame_trajectory(self):
        """[(timestamp, frame_id, Tcw)] for every tracked frame, re-anchored
        through each frame's reference keyframe's current pose."""
        with self.lock:
            return self.tracker.frame_trajectory()

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format: 'timestamp tx ty tz qx qy qz qw' per keyframe."""
        with open(path, "w") as f:
            for ts, Twc in self.keyframe_trajectory():
                q = se3.to_quaternion(torch.as_tensor(Twc[:3, :3])).numpy()
                t = Twc[:3, 3]
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
