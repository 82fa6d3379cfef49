"""Where the port's time goes on the card: one torch.profiler window over the
bench orbit with local mapping on.

    python3 scripts/profile_port.py [--frames 130] [--window 100 130] [--json PATH]

Tracks the first ``--frames`` frames of bench.py's 300-frame orbit at the bench
configuration twice on the GPU: a plain pass for the per-frame wall time, then
a pass that profiles the frames of ``--window`` (CPU and CUDA activities).
Prints, per frame of the window: kernel launches issued by the host, device
busy time (the union of the device-side events' intervals), the plain
pass's wall time and so the device's busy and idle shares; then the
device-side events by name, the device time of the top operators and the
kernel launches made inside each stage of the stage timer. Needs a CUDA
device; the numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bench configuration and the drive loop)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=130)
    parser.add_argument("--window", type=int, nargs=2, default=(100, 130))
    parser.add_argument("--json", help="write the numbers to this file")
    args = parser.parse_args()
    a, b = args.window

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)

    from os1_tpu_torch.io import synthetic

    scene = synthetic.default_scene(seed=1)
    poses = synthetic.orbit_trajectory(chip_smoke.N_FRAMES_MAP, advance=0.05)[: args.frames]
    frames = synthetic.render_sequence(scene, poses, chip_smoke.BENCH_K, chip_smoke.H,
                                       chip_smoke.W)

    # Plain pass: the wall time of every frame.
    _, lat, ok, _, _ = chip_smoke.drive(frames, mapping=True)
    if not ok[a:b].all():
        raise SystemExit("the window is not tracked on every frame")
    wall_ms = float(lat[a:b].sum() * 1e3)

    # Profiled pass: the same frames, the window under the profiler, each
    # stage of the stage timer marked as a profiler range.
    from os1_tpu_torch.utils.profiling import StageTimer

    class RangeTimer(StageTimer):
        @contextmanager
        def __call__(self, name):
            with torch.profiler.record_function("stage:" + name), super().__call__(name):
                yield

    sys_ = chip_smoke.build_system("cuda", mapping=True)
    sys_.set_timer(RangeTimer())
    for i, img in enumerate(frames[:b]):
        if i < a:
            sys_.track_monocular(img, timestamp=i / 30.0)
            continue
        if i == a:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        sys_.track_monocular(img, timestamp=i / 30.0)
    torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t0) * 1e3
    prof.__exit__(None, None, None)

    from torch.autograd import DeviceType

    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    # Device busy time: the union of the device-side events' intervals
    # (kernels, copies, fills), so overlap is counted once; the events are
    # also summed by name, and the operators that issued them ranked.
    # The stage ranges are projected onto the device timeline as well; they
    # are annotations, not device work.
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for s0, s1 in spans:
        busy_us += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    device_ms = busy_us / 1e3
    by_name = Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
    top = sorted((e for e in events if e.device_type == DeviceType.CPU), key=_device_us,
                 reverse=True)[:12]
    n = b - a
    stage_launches = Counter()  # launches by their innermost stage
    for e in prof.events():
        if e.name.startswith("cudaLaunchKernel"):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("stage:"):
                p = p.cpu_parent
            stage_launches[p.name[len("stage:"):] if p is not None else "(no stage)"] += 1
    out = dict(
        device=smi, window=[a, b], frames=n,
        launches_per_frame=launches / n, device_events_per_frame=len(device) / n,
        device_ms_per_frame=device_ms / n,
        wall_ms_per_frame=wall_ms / n, profiled_wall_ms_per_frame=prof_wall_ms / n,
        device_busy_share=device_ms / wall_ms, device_idle_share=1.0 - device_ms / wall_ms,
        device_events_summed_ms_per_frame=sum(by_name.values()) / 1e3 / n,
        top_device_events=[dict(name=k, ms_per_frame=v / 1e3 / n)
                           for k, v in by_name.most_common(8)],
        top_ops=[dict(op=e.key, count=e.count, device_ms=_device_us(e) / 1e3) for e in top],
        launches_per_frame_by_stage={k: v / n for k, v in stage_launches.most_common()},
    )
    print(f"[profile] frames {a}..{b - 1} ({n}): {out['launches_per_frame']:.1f} kernel "
          f"launches/frame, {out['device_events_per_frame']:.1f} device events/frame, device time {out['device_ms_per_frame']:.3f} ms/frame, plain wall "
          f"{out['wall_ms_per_frame']:.3f} ms/frame (profiled {out['profiled_wall_ms_per_frame']:.3f}); "
          f"device busy {out['device_busy_share'] * 100:.1f}%, idle "
          f"{out['device_idle_share'] * 100:.1f}%")
    print(f"[profile] device events summed: {out['device_events_summed_ms_per_frame']:.3f} "
          f"ms/frame; by name:")
    for r in out["top_device_events"]:
        print(f"[profile]   {r['name'][:60]:<60s} {r['ms_per_frame']:10.3f} ms/frame")
    print("[profile] operators by their own device time (whole window):")
    for r in out["top_ops"]:
        print(f"[profile]   {r['op'][:60]:<60s} {r['count']:8d}x {r['device_ms']:10.3f} ms")
    for k, v in out["launches_per_frame_by_stage"].items():
        print(f"[profile]   launches/frame in {k:<24s} {v:10.1f}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
