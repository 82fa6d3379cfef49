"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` trace of
the card over a steady run of frames inside the window, the program's stage
spans on the host clock, and the shapes of every launch of the hand-written
kernels, recorded by the benchmark's own wrappers around the places the
program calls them.

The stretch starts and ends on a synchronised card with a one-element fill
as a marker, so every kernel between the markers was launched inside it, and
the markers tie the host clock to the trace's.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

from . import kernels


@dataclass
class Stretch:
    frames: int
    window_s: float
    busy_s: float
    launches: int  # kernel events, markers left out
    kernel_s: dict  # kernel name -> device seconds
    bounds: dict  # metric stem -> (lower-bound seconds, launches recorded)
    device_s: dict  # metric stem -> (device seconds, events)
    idle_gaps: list  # [(host stage, idle seconds in it)], most first
    device_ops: list  # [(kernel, seconds)], most time first


class Tracer:
    """Installs the kernel wrappers and traces frames ``start`` to ``start +
    frames`` of the window (the traffic mix's ``trace`` entry, default 10
    and 30); its ``timer`` is the stage timer to give the systems."""

    def __init__(self, mix: dict):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from os1_tpu_torch.utils.profiling import StageTimer

        class RecordingTimer(StageTimer):
            """The program's stage timer, which keeps each stage's host
            interval while ``recording`` and adds to the totals only while
            ``counting``: until the profiled stretch opens."""

            def __init__(self):
                super().__init__()
                self.recording = False
                self.counting = True
                self.spans = []

            @contextlib.contextmanager
            def __call__(self, name: str):
                t0 = time.perf_counter_ns()
                try:
                    yield
                finally:
                    t1 = time.perf_counter_ns()
                    with self._lock:
                        if self.recording:
                            self.spans.append((name, t0, t1))
                        if self.counting:
                            self.totals[name] += (t1 - t0) * 1e-9
                            self.counts[name] += 1

        spec = mix.get("trace", {})
        self.start_at = int(spec.get("start", 10))
        self.length = int(spec.get("frames", 30))
        self.timer = RecordingTimer()
        self.torch = torch
        self.marker = torch.zeros(1, device="cuda")
        self.launches = {k: [] for k in kernels.TRACE_NAMES}
        self.recording = False
        self._install()
        # The profiler starts first at the stretch: once it has run, every
        # launch costs more host time for the rest of the process (on the
        # card a frame's ~6,800 launches run 15-60% slower), so no frame
        # before the stretch may follow a start of it.
        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        self.prof = None
        self.f0 = self.f1 = None
        self._result = None

    def _install(self) -> None:
        import os1_tpu_torch.features.orb as orb
        import os1_tpu_torch.matching.core as core

        gm, kp, bs = core.gated_match_cuda, orb.keypoint_patches, orb.brief_samples

        def gated_match_cuda(*args, **kw):
            names = ("desc_a", "desc_b", "max_dist", "ratio", "gate")
            kw.update(zip(names, args))
            a, b = kw["desc_a"], kw["desc_b"]
            if self.recording and b.shape[0] and a.shape[1]:
                self.launches["gated_match"].append(kernels.gated_match(
                    a.shape[0], a.shape[1], b.shape[0], b.shape[1], kw.get("gate") is not None,
                    kw.get("uv") is not None, kw.get("octave_a") is not None))
            return gm(**kw)

        def keypoint_patches(stack, kps):
            if self.recording and stack.is_cuda and kps.shape[0]:
                self.launches["patch_gather"].append(kernels.patch_gather(kps.shape[0]))
            return kp(stack, kps)

        def brief_samples(patches, abin, table):
            if self.recording and patches.is_cuda and patches.shape[0] and table.shape[1]:
                self.launches["sample_gather"].append(kernels.sample_gather(
                    patches.shape[0], table.shape[1], table.numel()))
            return bs(patches, abin, table)

        core.gated_match_cuda = gated_match_cuda
        orb.keypoint_patches = keypoint_patches
        orb.brief_samples = brief_samples

    def _mark(self) -> int:
        self.torch.cuda.synchronize()
        t = time.perf_counter_ns()
        self.marker.fill_(1.0)
        self.torch.cuda.synchronize()
        return t

    def before_frame(self, fed: int) -> None:
        if fed == self.start_at and self.prof is None:
            self.torch.cuda.synchronize()
            self.prof = self._profile()
            self.prof.start()
            self.t0 = self._mark()
            self.recording = self.timer.recording = True
            self.timer.counting = False
            self.f0 = fed
        elif fed == self.start_at + self.length:
            self.stop(fed)

    def stop(self, fed: int) -> None:
        if self.prof is None or self.f1 is not None:
            return
        self.recording = self.timer.recording = False
        self.t1 = self._mark()
        self.prof.stop()
        self.f1 = fed
        self._result = self._reduce()
        self.prof = None

    @property
    def started(self) -> bool:
        """The profiled stretch has opened (host-clock readings after it
        carry the profiler's cost)."""
        return self.f0 is not None

    def result(self):
        return self._result

    def _reduce(self) -> Stretch | None:
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            start = e.start_ns()
            events.append((start, start + e.duration_ns(), e.name()))
        events.sort()
        # The card was idle at both marks: the first and the last event are
        # the markers.
        if len(events) < 2 or not all("fill" in ev[2].lower() for ev in (events[0], events[-1])):
            return None
        m0, m1, inner = events[0], events[-1], events[1:-1]
        w0, w1 = m0[1], m1[0]
        offset = m0[0] - self.t0  # device clock minus host perf_counter, ns
        busy, intervals = 0, []
        for s, e, _ in inner:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if intervals and s <= intervals[-1][1]:
                intervals[-1][1] = max(intervals[-1][1], e)
            else:
                intervals.append([s, e])
        busy = sum(e - s for s, e in intervals)
        kernel_s, launches = {}, 0
        for s, e, name in inner:
            if name.startswith(("Memcpy", "Memset")):
                continue
            launches += 1
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        gaps, prev = [], w0
        for s, e in intervals + [[w1, w1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        # Idle time by what the host was doing: each gap goes to the
        # innermost stage running at its midpoint.
        segs = flatten(self.timer.spans)
        idle, j = {}, 0
        for g0, g1 in sorted(gaps):
            mid = (g0 + g1) / 2 - offset
            while j < len(segs) and segs[j][1] < mid:
                j += 1
            name = segs[j][2] if j < len(segs) and segs[j][0] <= mid else "between stages"
            idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
        idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        device_s = {}
        for stem, trace_name in kernels.TRACE_NAMES.items():
            hits = [(e - s) * 1e-9 for s, e, name in inner if trace_name in name]
            device_s[stem] = (sum(hits), len(hits))
        bounds = {stem: (sum(v), len(v)) for stem, v in self.launches.items()}
        ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])
        return Stretch(frames=self.f1 - self.f0, window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                       launches=launches, kernel_s=kernel_s, bounds=bounds, device_s=device_s,
                       idle_gaps=idle, device_ops=[(n[:160], s) for n, s in ops[:10]])


def flatten(spans) -> list:
    """Nested host spans [(name, t0, t1)] -> non-overlapping segments
    [(t0, t1, name of the innermost span)], in time order."""
    segs, stack, cur = [], [], None

    def close(upto):
        nonlocal cur
        while stack and stack[-1][2] <= upto:
            name, _, end = stack.pop()
            if end > cur:
                segs.append((cur, end, name))
                cur = end
        if stack and upto > cur:
            segs.append((cur, upto, stack[-1][0]))
        cur = max(cur, upto)

    for name, t0, t1 in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        if cur is None:
            cur = t0
        close(t0)
        stack.append((name, t0, t1))
    if stack:
        close(max(end for _, _, end in stack))
    return segs

