"""One run of one cell: set-up, the measured window, the traced stretch and
the check that decides ``correct``.

The window feeds the frames of the traffic mix to the program's
``System.track_monocular`` one after another, session after session: a
session is the mix's frames from frame 0 on a map cleared by
``System.reset()``, and its end is a ``System.flush()``. The window closes
after the first frame that ends past ``seconds``; its time runs to the end of
the flush of the last frame in flight.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np

from . import cells, check, traffic


@dataclass
class Snapshot:
    """What a session left, read once it was flushed: the tracked frames'
    poses, the keyframes and the map, on the host."""

    frame_T: dict  # session frame index -> Tcw of every tracked frame
    kf_frame: np.ndarray  # [K] session frame index of each live keyframe
    kf_T: np.ndarray  # [K, 4, 4]
    kf_xy: np.ndarray  # [K, N, 2] undistorted keypoints
    kf_octave: np.ndarray
    kf_angle: np.ndarray
    kf_desc: np.ndarray  # [K, N, 8] uint32
    kf_valid: np.ndarray  # [K, N] feature valid
    kf_obs: np.ndarray  # [K, N] map point of each feature, -1 none
    pt_xyz: np.ndarray  # [P, 3]
    pt_valid: np.ndarray  # [P]


def snapshot(sys_, fid0: int, fps: float) -> Snapshot:
    st = sys_.store
    frame_T = {int(round(ts * fps)): np.asarray(T, np.float64)
               for ts, fid, T in sys_.frame_trajectory() if fid >= fid0}
    kfs = np.nonzero(st.kf_valid)[0]
    return Snapshot(frame_T=frame_T,
                    kf_frame=np.round(st.kf_timestamp[kfs] * fps).astype(np.int64),
                    kf_T=st.kf_T[kfs].astype(np.float64), kf_xy=st.kf_xy[kfs].copy(),
                    kf_octave=st.kf_octave[kfs].copy(), kf_angle=st.kf_angle[kfs].copy(),
                    kf_desc=st.kf_desc[kfs].copy(), kf_valid=st.kf_feat_valid[kfs].copy(),
                    kf_obs=st.kf_obs_point[kfs].copy(), pt_xyz=st.pt_xyz.astype(np.float64),
                    pt_valid=st.pt_valid.copy())


@dataclass
class Feeder:
    """Feeds one stream's sequence to its system session after session and
    keeps the window's counts: frames fed, each call's host seconds before
    the profiled stretch, every frame's tracking state, the frames lost
    after a session's first OK frame (bench.py's OK-stretch rule)."""

    sys_: object
    seq: traffic.Sequence
    stream: int = 0
    i: int = 0  # next frame of the current session
    fid0: int = 0  # the tracker's frame id at the session's start
    seen_ok: bool = False
    in_window: bool = False
    fed: int = 0  # frames fed in the window
    failed: int = 0
    latencies: list = field(default_factory=list)
    where: list = field(default_factory=list)  # (stream, session, frame) of each latency
    states: list = field(default_factory=list)  # (stream, session, frame, OK) of each frame fed
    snapshots: list = field(default_factory=list)

    def feed(self, profiled: bool = False) -> None:
        """Track the next frame; ``profiled``: it runs once the profiler has
        started, so its host time is left out of the latencies."""
        from os1_tpu_torch.pipeline.tracking import TrackingState

        i = self.i
        t0 = time.perf_counter()
        state, _ = self.sys_.track_monocular(self.seq.frames[i], i / self.seq.fps)
        dt = time.perf_counter() - t0
        ok = state == TrackingState.OK
        if self.in_window:
            if not profiled:
                self.latencies.append(dt)
                self.where.append((self.stream, len(self.snapshots), i))
            self.states.append((self.stream, len(self.snapshots), i, bool(ok)))
            self.fed += 1
            self.failed += int(self.seen_ok and not ok)
        self.seen_ok |= ok
        self.i += 1
        if self.i == len(self.seq.frames):
            self.end_session()
            self.sys_.reset()
            self.i, self.seen_ok = 0, False
            self.fid0 = self.sys_.tracker.frame_id

    def end_session(self, flushed: bool = False) -> None:
        if not flushed:
            self.sys_.flush()
        if self.in_window:
            self.snapshots.append(snapshot(self.sys_, self.fid0, self.seq.fps))

    def open_window(self) -> None:
        self.in_window = True


@dataclass
class Window:
    """Everything a metric reader may read of one run. In a ``--trace 1``
    run the host-clock per-layer numbers (latencies, stages, reads, BA
    iterations) cover the window's frames before the profiled stretch opens:
    from then on every launch carries the profiler's cost (``trace.py``).
    ``timed_frames`` counts the frames they cover."""

    seconds: float  # the window's wall time
    frames: int  # frames fed in the window, every stream
    failed: int
    setup_s: float
    latencies: list  # host seconds of every track_monocular call before the stretch
    stages: dict  # StageTimer name -> (host seconds, calls) before the stretch
    reads: int  # host reads before the stretch
    ba_iters: int  # local-BA LM iterations before the stretch
    timed_frames: int = None  # frames before the stretch (default: all)
    states: list = field(default_factory=list)  # (stream, session, frame, OK), every frame fed
    trace: object = None  # trace.Stretch of a --trace 1 run

    def __post_init__(self):
        if self.timed_frames is None:
            self.timed_frames = self.frames


def run_cell(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print, limits: dict | None = None):
    """Set up, measure, check. Returns (Window, check.Result, device dict).
    ``limits`` stands in for the cell's limits file (the tests' small cells).
    A mix of several ``streams`` serves each with a system of its own, one
    frame of each in turn."""
    import torch

    from os1_tpu_torch.utils.profiling import StageTimer

    from . import trace as tracing

    cuda = torch.device(device).type == "cuda"
    mix, cam = traffic.for_config(mix, cfg), cells.camera(cfg)
    seqs = [traffic.generate(mix, cam, seed, device, stream=k)
            for k in range(int(mix.get("streams", 1)))]
    feeders = []
    for k, seq in enumerate(seqs):
        sys_ = cells.build_system(cfg, device)
        sys_.warmup()
        feeders.append(Feeder(sys_, seq, stream=k, fid0=sys_.tracker.frame_id))
        for _ in range(seq.pretrack):
            feeders[-1].feed()
    systems = [d.sys_ for d in feeders]
    tracer = tracing.Tracer(mix) if trace and cuda else None
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    log(f"[setup] {setup_s:.3f} s")

    timer = tracer.timer if tracer is not None else StageTimer()
    for sys_ in systems:
        sys_.set_timer(timer)

    def counts():
        return np.array([sum(s.reads.count for s in systems),
                         sum(s.mapper.ba_iters for s in systems)])

    start = counts()
    opened = None  # the counts where the profiled stretch opened
    for drv in feeders:
        drv.open_window()
    fed, t0 = 0, time.perf_counter()
    while True:
        if tracer is not None:
            tracer.before_frame(fed)
            if opened is None and tracer.started:
                opened = counts()
        feeders[fed % len(feeders)].feed(profiled=opened is not None)
        fed += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if tracer is not None:
        tracer.stop(fed)
    for sys_ in systems:
        sys_.flush()  # the last frames in flight
    window_s = time.perf_counter() - t0
    for drv in feeders:
        drv.end_session(flushed=True)

    reads, iters = (opened if opened is not None else counts()) - start
    stages = {k: (timer.totals[k], timer.counts[k]) for k in timer.totals}
    stretch = tracer.result() if tracer is not None else None
    latencies = [t for d in feeders for t in d.latencies]
    where = [w for d in feeders for w in d.where]
    win = Window(seconds=window_s, frames=fed, failed=sum(d.failed for d in feeders),
                 setup_s=setup_s, latencies=latencies, stages=stages, reads=int(reads),
                 ba_iters=int(iters), timed_frames=len(latencies),
                 states=[s for d in feeders for s in d.states], trace=stretch)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1, memory_peak_bytes=int(torch.cuda.max_memory_allocated()) if cuda else 0)
    sessions = [(sn, d.seq) for d in feeders for sn in d.snapshots]
    log(f"[window] {win.frames} frames in {window_s:.3f} s, {win.failed} failed, "
        f"{len(sessions)} sessions checked")
    slow = sorted(range(len(latencies)), key=lambda k: -latencies[k])[:5]
    log("[window] slowest calls (stream, session, frame, ms): " + ", ".join(
        f"({where[k][0]}, {where[k][1]}, {where[k][2]}, {latencies[k] * 1e3:.1f})"
        for k in slow))
    if latencies:
        ms = np.asarray(latencies) * 1e3
        log(f"[window] host ms a call before any profiling: p50 {np.percentile(ms, 50):.1f}, "
            f"p95 {np.percentile(ms, 95):.1f} over {len(ms)} calls")
    log("[window] stages: " + ", ".join(f"{k} {t:.3f}s/{n}" for k, (t, n) in sorted(
        stages.items(), key=lambda kv: -kv[1][0])[:12]))
    for drv in feeders:
        drv.sys_.shutdown()
        drv.sys_ = None
    del systems, sys_
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result = check.Result(values=check.numbers(sessions, cfg, device),
                          limits=limits or check.load_limits(cell["name"]))
    return win, result, dev
