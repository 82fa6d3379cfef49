"""Repeated passes of the threaded mode over bench.py's loop sequence (or
orbit) on one NVIDIA GPU: how often it meets chip_smoke.py's [threaded]
gates, how many tracked bindings named a point slot that was refilled while
their frame was in flight (``Tracker.stale_binds``), and the keyframe
policy's trace behind a failure.

    python3 scripts/threaded_repeats.py [--seq loop|orbit] [--runs 4]
        [--straight] [--trace] [--json PATH]

Each pass is ``chip_smoke.phase_threaded`` on a fresh
``System(cfg, pipelined=True, async_mapping=True)`` at the bench
configuration. ``--straight`` holds the LocalMapping thread's pacer free for
the whole pass, so each keyframe's pass runs straight through as fast as the
thread can, as the JAX package's worker does; by default the pass is paced,
one stage a tracked frame. ``--trace`` records, a frame, the state, the
tracked inliers, the keyframe and point counts, the queue depths, the stale
bindings so far, the point allocations so far and the allocator's cursor,
and each keyframe made and culled. Prints one line a
pass and a summary; ``--device cpu`` rehearses it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _tracer(sys_, log: dict) -> None:
    """Wrap the tracker and the store to record the keyframe policy."""
    tr, st = sys_.tracker, sys_.store
    track, cull, new = tr.track, st.cull_keyframe, tr.on_new_keyframe

    def traced_track(img, timestamp=0.0):
        out = track(img, timestamp)
        log["frames"].append((tr.frame_id - 1, tr.state.name, tr.last.n_inliers if tr.last else -1,
                              st.n_keyframes(), st.n_points(),
                              sys_.mapping_worker.queue_size(), sys_.loop_worker.queue_size(),
                              tr.stale_binds, int(st.pt_gen.sum()),
                              getattr(st, "_pt_cursor", 0)))
        return out

    def traced_cull(k):
        log["culls"].append((tr.frame_id - 1, int(k)))
        return cull(k)

    def traced_new(kf, bootstrap=False, frame=None):
        log["made"].append((tr.frame_id - 1, int(kf)))
        return new(kf, bootstrap=bootstrap, frame=frame)

    tr.track, st.cull_keyframe, tr.on_new_keyframe = traced_track, traced_cull, traced_new


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", choices=("loop", "orbit"), default="loop")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--straight", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json")
    args = ap.parse_args()

    if args.device != "cpu":
        cs.phase_device()
        cs.phase_build()
    else:
        cs._launch_gate = lambda res, fails: None  # no kernels on the CPU
    frames, poses = (cs.render_loop if args.seq == "loop" else cs.render)(cs.N_FRAMES_MAP)
    nan = dict(fps_ok=math.nan, p50_ms=math.nan, p99_ms=math.nan, wall_fps=math.nan)
    mode = "straight" if args.straight else "paced"
    runs = []
    for k in range(args.runs):
        log = dict(frames=[], culls=[], made=[])
        built = []
        with contextlib.ExitStack() as free:

            def on_build(s, log=log):
                built.append(s)
                if args.straight:
                    free.enter_context(s.mapping_worker.pacer.free_running())
                if args.trace:
                    _tracer(s, log)

            build = cs.build_system
            cs.build_system = lambda *a, **kw: _built(build(*a, **kw), on_build)
            t0 = time.perf_counter()
            try:
                res = cs.phase_threaded(args.seq, frames, poses, nan, device=args.device)
                row = dict(ok=True, ate=res["ate"], fps=res["fps_ok"], loss=res["loss_log"],
                           loops=res["loop_edges"],
                           keyframes=res["keyframes"] + res["keyframes_culled"])
            except RuntimeError as exc:
                row = dict(ok=False, error=str(exc)[:400])
            finally:
                cs.build_system = build
        tr = built[0].tracker if built else None
        row.update(mode=mode, seconds=time.perf_counter() - t0,
                   stale_binds=tr.stale_binds if tr else None,
                   trace=log if args.trace else None)
        runs.append(row)
        print(f"[repeats] {mode} {args.seq} pass {k}: "
              f"{json.dumps({x: v for x, v in row.items() if x != 'trace'})}", flush=True)
    n_ok = sum(r["ok"] for r in runs)
    print(f"[repeats] {mode} {args.seq}: {n_ok} of {len(runs)} passes met the gates; stale "
          f"bindings a pass {[r['stale_binds'] for r in runs]}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(runs, f, default=str)
    return 0


def _built(sys_, on_build):
    on_build(sys_)
    return sys_


if __name__ == "__main__":
    sys.exit(main())
