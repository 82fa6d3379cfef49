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
one stage a tracked frame. ``--trace`` records, a frame (the columns are
named in ``trace["columns"]``), the state, the tracked inliers, the keyframe
and point counts, the queue depths, the stale bindings so far, the point
allocations so far and the allocator's cursor, whether the LocalMapping
thread accepts a keyframe (``MappingWorker.accepting``), whether it is asked
to stop and since which frame, whether a loop closure is in flight, the
tracker's last keyframe decision (its frame, the flags c1-c4 and the
verdict: hold, not_needed, loop_closing, refused or insert), the local-map
size the last fused step was given and the mapper's current stage; and
each keyframe made and culled, each stop and release, and each mapping
pass (its keyframe, the frames it started and ended at, the points it
triangulated and culled, whether fusion and local BA ran, or that it was
skipped because its keyframe died in the queue) and each re-anchoring after
a loop correction (the last frame, its reference keyframe and whether it
was still valid, whether the motion model was kept). Prints one line a pass
and a summary; ``--device cpu`` rehearses it.
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


COLUMNS = ("frame", "state", "inliers", "keyframes", "points", "map_queue", "loop_queue",
           "stale_binds", "pt_allocs", "pt_cursor", "accepting", "stop_requested",
           "stopped_since", "closing_active", "kf_check", "local_map", "stage")


def _tracer(sys_, log: dict) -> None:
    """Wrap the tracker, the store, the mapper and the LocalMapping worker to
    record the keyframe policy."""
    tr, st, mp, mw = sys_.tracker, sys_.store, sys_.mapper, sys_.mapping_worker
    track, cull, new = tr.track, st.cull_keyframe, tr.on_new_keyframe
    local, prepare = tr._local_candidates, mw.on_process
    stop, release = mw.request_stop, mw.release
    now = dict(local=-1, stage="idle", stop_since=-1, pass_=None)
    log["columns"] = COLUMNS
    log.update(stops=[], passes=[])

    def fid():
        return tr.frame_id - 1

    def traced_track(img, timestamp=0.0):
        out = track(img, timestamp)
        log["frames"].append((fid(), tr.state.name, tr.last.n_inliers if tr.last else -1,
                              st.n_keyframes(), st.n_points(),
                              mw.queue_size(), sys_.loop_worker.queue_size(),
                              tr.stale_binds, int(st.pt_gen.sum()),
                              getattr(st, "_pt_cursor", 0), mw.accepting,
                              mw._stop_requested, now["stop_since"],
                              sys_.loop_closer.closing_active, tr.kf_check, now["local"],
                              now["stage"]))
        return out

    def traced_cull(k):
        log["culls"].append((fid(), int(k)))
        return cull(k)

    def traced_new(kf, bootstrap=False, frame=None):
        log["made"].append((fid(), int(kf)))
        return new(kf, bootstrap=bootstrap, frame=frame)

    def traced_local(bind):
        ids, valid = local(bind)
        now["local"] = int(valid.sum())
        return ids, valid

    def traced_stop():
        now["stop_since"] = fid()
        log["stops"].append(("stop", fid()))
        return stop()

    def traced_release():
        now["stop_since"] = -1
        log["stops"].append(("release", fid()))
        return release()

    def traced_prepare(kf):
        ok = prepare(kf)
        if ok is False:
            log["passes"].append(dict(kf=int(kf), start=fid(), skipped=True))
        return ok

    def stage(name, steps, key=None):
        def run(kf):
            now["stage"] = name
            p = now["pass_"]
            if p is not None and key is not None:
                p[key] = True
            a0 = int(st.pt_gen.sum())
            yield from steps(kf)
            if p is not None and name == "triangulate":
                p["triangulated"] = int(st.pt_gen.sum()) - a0
        return run

    def pass_steps(steps):
        def run(kf, bootstrap=False):
            p = dict(kf=int(kf), start=fid(), bootstrap=bool(bootstrap), fused=False, ba=False)
            now["pass_"] = p
            n0 = st.n_points()
            try:
                yield from steps(kf, bootstrap=bootstrap)
            finally:
                p.update(end=fid(), net_points=st.n_points() - n0)
                log["passes"].append(p)
                now["stage"], now["pass_"] = "idle", None
        return run

    def cull_points(steps):
        def run(kf):
            now["stage"] = "cull_points"
            n0 = st.n_points()
            steps(kf)
            if now["pass_"] is not None:
                now["pass_"]["points_culled"] = n0 - st.n_points()
        return run

    reanchor = sys_._after_loop_correction

    def traced_reanchor():
        """The re-anchoring after a correction: whether the last frame's
        pose was remapped through its reference keyframe and the motion
        model kept."""
        last = tr.last
        ref = tr.trajectory[-1][2:4] if tr.trajectory else (-1, -1)
        row = dict(frame=fid(), last_frame=last.frame_id if last else None,
                   last_recorded=tr.trajectory[-1][1] if tr.trajectory else None,
                   ref=int(ref[0]), ref_valid=bool(ref[0] >= 0 and st.kf_valid[ref[0]]),
                   ref_seq_same=bool(ref[0] >= 0 and st.kf_seq[ref[0]] == ref[1]),
                   tracker_ref=int(tr.ref_kf), had_velocity=tr.velocity is not None)
        out = reanchor()
        row.update(kept_velocity=tr.velocity is not None)
        log["reanchors"].append(row)
        return out

    sys_._after_loop_correction = traced_reanchor
    sys_.loop_closer.on_corrected = traced_reanchor
    log["reanchors"] = []
    mp.process_steps = pass_steps(mp.process_steps)
    mp.cull_recent_points = cull_points(mp.cull_recent_points)
    mp.create_new_points_steps = stage("triangulate", mp.create_new_points_steps)
    mp.search_in_neighbors_steps = stage("fuse", mp.search_in_neighbors_steps, "fused")
    mp.local_ba_steps = stage("local_ba", mp.local_ba_steps, "ba")
    tr.track, st.cull_keyframe, tr.on_new_keyframe = traced_track, traced_cull, traced_new
    tr._local_candidates, mw.on_process = traced_local, traced_prepare
    mw.request_stop, mw.release = traced_stop, traced_release


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
