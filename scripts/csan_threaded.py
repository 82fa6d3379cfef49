"""CUDA-sanitizer probe of the threaded mode on one NVIDIA GPU.

    python3 scripts/csan_threaded.py [--frames 40] [--json PATH]

Runs ``System(cfg, pipelined=True, async_mapping=True)`` (loop closing on)
over the first frames of the test sequence (240x320, 512 features, 4 levels,
orbit_trajectory(40, advance=0.08) of default_scene(seed=3)) under PyTorch's
CUDA sanitizer (``torch.cuda._sanitizer``), which checks every PyTorch
operation's reads and writes of device memory against the streams and events
that order them, and reports an access on one stream that no synchronisation
orders after a conflicting access on another.

The sanitizer's dispatch mode is per thread, so every thread (the tracker,
LocalMapping, LoopClosing, GlobalBA) enters its own mode over one shared
event handler. The hand-written kernels (ctypes calls) are invisible to it.
Prints the operations it checked by thread, the races it reported, the
exceptions the worker threads caught, and the card's name and power limit;
exits 1 if it reported a race or a worker failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--json", help="write the findings to this file")
    args = ap.parse_args()

    import torch
    from torch.cuda import _sanitizer as csan
    from torch.utils._python_dispatch import TorchDispatchMode

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    root = csan.CUDASanitizerDispatchMode()  # turns on the device trace, one event handler
    checked = defaultdict(int)
    races = []
    count_lock = threading.Lock()

    class ThreadMode(csan.CUDASanitizerDispatchMode):
        """The sanitizer's mode for one thread, over the shared handler."""

        def __init__(self):
            TorchDispatchMode.__init__(self)
            self.event_handler = root.event_handler

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            with count_lock:
                checked[threading.current_thread().name] += 1
            try:
                return super().__torch_dispatch__(func, types, args, kwargs)
            except csan.CUDASanitizerErrors as exc:
                races.append((threading.current_thread().name, str(exc)[:2000]))
                raise

    run = threading.Thread.run

    def run_checked(self):
        with ThreadMode():
            run(self)

    threading.Thread.run = run_checked

    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig, System

    poses = synthetic.orbit_trajectory(40, advance=0.08)[:args.frames]
    frames = synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)
    cfg = SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    t0 = time.perf_counter()
    states, failure = [], None
    with ThreadMode():
        s = System(cfg, pipelined=True, async_mapping=True, device="cuda")
        try:
            for i, img in enumerate(frames):
                states.append(s.track_monocular(img, timestamp=i / 30.0)[0].name)
            s.flush()
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001: reported below, then the exit code says it
            failure = repr(exc)[:2000]
        finally:
            s.shutdown()
    threading.Thread.run = run
    worker_errors = [f"{name} kf {kf}: {exc!r}"[:500] for name, kf, exc in s.worker_errors()]
    out = dict(device=smi, frames=len(frames), seconds=time.perf_counter() - t0,
               states="".join("O" if x == "OK" else "." for x in states),
               keyframes=s.store.n_keyframes(), points=s.store.n_points(),
               ops_checked_by_thread=dict(checked), races=races, worker_errors=worker_errors,
               failure=failure, lock_wait_s=dict(s.lock.wait_s))
    print(f"[csan] {out['frames']} frames in {out['seconds']:.1f}s, states {out['states']}, "
          f"{out['keyframes']} keyframes, {out['points']} points")
    print(f"[csan] operations checked by thread: {out['ops_checked_by_thread']}")
    print(f"[csan] races reported: {len(races)}; worker errors: {worker_errors}; "
          f"failure: {failure}")
    for name, msg in races[:5]:
        print(f"[csan] race on {name}: {msg}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(smi)
    return 1 if (races or worker_errors or failure) else 0


if __name__ == "__main__":
    sys.exit(main())
