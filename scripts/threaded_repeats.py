"""Repeated passes of the threaded mode over bench.py's loop sequence (or
orbit) on one NVIDIA GPU: how often it meets chip_smoke.py's [threaded]
gates, how many tracked bindings named a point slot that was refilled while
their frame was in flight (``Tracker.stale_binds``), and the keyframe
policy's trace behind a failure.

    python3 scripts/threaded_repeats.py [--seq loop|orbit] [--runs 4]
        [--straight] [--trace] [--frames NPZ] [--root DIR] [--json PATH]

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
a loop correction (``trace["reanchors"]``): the last frame applied, the
frames in flight it dropped and the frame whose dispatch straddled it (or
whose read did), its reference keyframe (still valid, still waiting in
``MappingWorker.queued()`` and not materialized), whether the motion model
was kept; and the first frame dispatched after it: the gap in frames from
the last applied one, the predicted pose and the remapped last pose against
the ground truth (the camera centre after the Sim3 alignment of the pass's
final trajectory, in the ground truth's units; the rotation of the motion
from the last pose against the ground truth's), the inliers of
the motion search at each radius, the reference-keyframe fallback's inliers
where it ran, the local-map inliers, the local-map size and whether it was
tracked. A pass summary says whether a frame was lost within 10 frames of
a correction. Each pass also gives the host ms a call of the mapping stages
that update the points' derived state (``DERIVED``). Prints one line a pass
and a summary; ``--device cpu``
rehearses it.

``--frames NPZ`` reads the rendered sequence from NPZ (rendered and written
there when missing), so that several processes share one rendering.
``--root DIR`` runs another checkout's package and its chip_smoke.py under
this script's trace (an unpacked ``git archive`` of the parent commit, say),
to compare two commits in one call: run the two in turns.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import threading
import time

import numpy as np

cs = None  # chip_smoke of the checkout under test, imported by main()
AFTER = 10  # frames after a correction in which a loss counts against it
# The mapping stages that update the points' derived state (the distinctive
# descriptor): host ms a call, printed for each pass.
DERIVED = ("lm.materialize", "lm.tri.apply", "lm.fuse.apply")


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
    now.update(fid=-1, apply_fid=-1, corr=0, first=None)
    motion = threading.local()  # the motion searches' inliers of the dispatch in flight

    def traced_reanchor():
        """The re-anchoring after a correction, under the map lock as the
        system's own: the last frame applied and the frames in flight, the
        reference keyframe's state, whether the last pose was remapped and
        the motion model kept."""
        with tr.lock:
            last = tr.last
            ref = tr.trajectory[-1][2:4] if tr.trajectory else (-1, -1)
            queued = [int(k) for k in mw.queued()]
            k = int(tr.ref_kf)
            row = dict(frame=fid(), last_frame=last.frame_id if last else None,
                       last_recorded=tr.trajectory[-1][1] if tr.trajectory else None,
                       in_flight=[int(e[1]) for e in tr._pending], straddled=[],
                       read_straddled=[], ref=int(ref[0]),
                       ref_valid=bool(ref[0] >= 0 and st.kf_valid[ref[0]]),
                       ref_seq_same=bool(ref[0] >= 0 and st.kf_seq[ref[0]] == ref[1]),
                       tracker_ref=k, tracker_ref_queued=k in queued,
                       tracker_ref_materialized=bool(k >= 0 and st.kf_feat_valid[k].any()),
                       queued=queued, had_velocity=tr.velocity is not None)
            out = reanchor()
            row.update(kept_velocity=tr.velocity is not None,
                       remapped_T=tr.last.Tcw.tolist() if tr.last is not None else None)
            log["reanchors"].append(row)
            now["corr"] += 1
            now["first"] = dict(reanchor=len(log["reanchors"]) - 1)  # its first dispatch next
        return out

    def traced_pipelined(frame, f, timestamp):
        """One pipelined dispatch; a frame a correction dropped between its
        snapshot and its place in the pipeline straddled it."""
        now["fid"], corr0 = int(f), now["corr"]
        out = pipelined(frame, f, timestamp)
        if now["corr"] != corr0:
            row = log["reanchors"][-1]
            if int(f) not in row["in_flight"] and int(f) not in [int(e[1]) for e in tr._pending]:
                row["straddled"].append(int(f))
        return out

    def traced_snapshot(host_bind):
        """The first dispatch after a re-anchoring (under the map lock):
        where it starts from and what it predicts."""
        out = snapshot(host_bind)
        first = now["first"]
        if first is not None and "fid" not in first and tr.last is not None:
            last_T = tr.last.Tcw.astype(np.float64)
            vel = tr.velocity if tr._chain is None else None
            first.update(fid=now["fid"], last_fid=int(tr.last.frame_id),
                         gap=now["fid"] - int(tr.last.frame_id), chain_none=tr._chain is None,
                         has_velocity=tr.velocity is not None, local_map=now["local"],
                         last_T=last_T.tolist(),
                         pred_T=(vel @ last_T if vel is not None else last_T).tolist())
        return out

    def traced_fused(*a, **kw):
        motion.inliers = []
        try:
            return fused(*a, **kw)
        finally:
            first = now["first"]
            if first is not None and first.get("fid") == now["fid"] and "motion" not in first:
                first["motion"] = motion.inliers
            motion.inliers = None

    def traced_item(t):
        v = item(t)
        if getattr(motion, "inliers", None) is not None:
            motion.inliers.append(v)
        return v

    def traced_apply(frame, f, *rest):
        now["apply_fid"], corr0 = int(f), now["corr"]
        n0 = len(tr.trajectory)
        out = apply(frame, f, *rest)
        first = now["first"]
        if first is not None and first.get("fid") == int(f) and "tracked" not in first:
            first.update(state_after=tr.state.name,
                         tracked=len(tr.trajectory) > n0 and tr.trajectory[-1][1] == int(f))
            log["reanchors"][first["reanchor"]]["first"] = first
            now["first"] = None
        elif now["corr"] != corr0 and not (len(tr.trajectory) > n0):
            log["reanchors"][-1]["read_straddled"].append(int(f))
        return out

    def traced_host(packed, local_ids, gen=None):
        out = host_result(packed, local_ids, gen)
        first, h = now["first"], out[4]
        if first is not None and first.get("fid") == now["apply_fid"]:
            first.update(pre_ok=bool(h["pre_ok"]), used_motion=bool(h["used_motion"]),
                         n_pre=int(h["n_pre"]), n_inliers=int(h["n_inliers"]))
        return out

    pipelined, snapshot, fused = tr._track_frame_pipelined, tr._fused_snapshot, tr._fused
    apply, host_result, item = tr._apply_result, tr._host_result, tr.reads.item
    tr._track_frame_pipelined, tr._fused_snapshot, tr._fused = (
        traced_pipelined, traced_snapshot, traced_fused)
    tr._apply_result, tr._host_result, tr.reads.item = traced_apply, traced_host, traced_item
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


def _centre(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def _sim3_fit(est, gt):
    """(s, R, t) with gt ~ s R est + t over camera centres (Umeyama), as
    ``synthetic.aligned_errors`` aligns them."""
    pe, pg = np.array([_centre(T) for T in est]), np.array([_centre(T) for T in gt])
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    ec, gc = pe - mu_e, pg - mu_g
    U, d, Vt = np.linalg.svd(gc.T @ ec / len(pe))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(d) @ S) / (ec ** 2).sum(1).mean()
    return s, R, mu_g - s * R @ mu_e


def _pose_errors(T, gt, fit, T_from, gt_from) -> dict:
    """Camera-centre error (ground-truth units) of an estimated pose after
    the pass's alignment, and the rotation error (degrees) of its motion from
    ``T_from`` against the ground truth's from ``gt_from`` (no alignment)."""
    s, R, t = fit
    c = s * R @ _centre(T) + t
    rot = lambda A, B: np.asarray(A, np.float64)[:3, :3] @ np.asarray(B, np.float64)[:3, :3].T  # noqa: E731
    R_err = rot(T, T_from) @ rot(gt, gt_from).T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1.0, 1.0)))
    return dict(centre=float(np.linalg.norm(c - _centre(gt))), rot_deg=float(ang))


def _corrections(sys_, log, poses) -> list:
    """Each re-anchoring's row with its first frame's errors against the
    ground truth and the losses within AFTER frames after it."""
    traj = sys_.frame_trajectory()
    fit = _sim3_fit([T for *_, T in traj], [poses[f] for _, f, _ in traj])
    loss = [int(f) for f, _ in sys_.tracker.loss_log]
    rows = []
    for r in log["reanchors"]:
        r = dict(r)
        base = r["last_frame"] if r["last_frame"] is not None else r["frame"]
        r["lost_after"] = [f for f in loss if base < f <= r["frame"] + AFTER]
        r["dropped"] = len(r["in_flight"]) + len(r["straddled"]) + len(r["read_straddled"])
        first = r.get("first")
        if first is not None and "pred_T" in first:
            gt_first, gt_last = poses[first["fid"]], poses[first["last_fid"]]
            last_T = first["last_T"]
            first["pred_err"] = _pose_errors(first["pred_T"], gt_first, fit, last_T, gt_last)
            first["still_err"] = _pose_errors(last_T, gt_first, fit, last_T, gt_last)
            first["last_err"] = _pose_errors(last_T, gt_last, fit, last_T, gt_last)
        rows.append(r)
    return rows


def main() -> int:
    global cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", choices=("loop", "orbit"), default="loop")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--straight", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", help="cache of the rendered sequence (.npz)")
    ap.add_argument("--root", help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--json")
    args = ap.parse_args()

    root = os.path.abspath(args.root or os.path.dirname(os.path.dirname(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    cs = chip_smoke
    print(f"[repeats] package {os.path.dirname(cs.__file__)}", flush=True)
    if args.device != "cpu":
        cs.phase_device()
        cs.phase_build()
    else:
        cs._launch_gate = lambda res, fails: None  # no kernels on the CPU
    render = cs.render_loop if args.seq == "loop" else cs.render
    if args.frames and os.path.exists(args.frames):
        with np.load(args.frames) as z:
            frames, poses = z["frames"], list(z["poses"])
    else:
        frames, poses = render(cs.N_FRAMES_MAP)
        if args.frames:
            np.savez(args.frames, frames=frames, poses=np.stack(poses))
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
        s = built[0] if built else None
        row.update(mode=mode, seconds=time.perf_counter() - t0,
                   stale_binds=s.tracker.stale_binds if s else None)
        if s is not None:
            tm = s.timer
            row["derived_ms"] = {k: round(tm.totals[k] / tm.counts[k] * 1e3, 3)
                                 for k in DERIVED if tm.counts.get(k)}
        if args.trace and s is not None:
            log["corrections"] = _corrections(s, log, poses)
            row["corrections"] = [_brief(r) for r in log["corrections"]]
        row["lost_after_correction"] = any(c["lost"] for c in row.get("corrections", []))
        row["trace"] = log if args.trace else None
        runs.append(row)
        print(f"[repeats] {mode} {args.seq} pass {k}: "
              f"{json.dumps({x: v for x, v in row.items() if x != 'trace'})}", flush=True)
    n_ok = sum(r["ok"] for r in runs)
    n_lost = sum(r["lost_after_correction"] for r in runs)
    print(f"[repeats] {mode} {args.seq}: {n_ok} of {len(runs)} passes met the gates; "
          f"{n_lost} lost a frame within {AFTER} frames after a correction; stale bindings a "
          f"pass {[r['stale_binds'] for r in runs]}")
    if args.trace:
        _compare([c for r in runs for c in r.get("corrections", [])])
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(runs, f, default=str)
    return 0


def _brief(r) -> dict:
    """The numbers of one correction that the pass line prints."""
    first = r.get("first") or {}
    out = dict(frame=r["frame"], last=r["last_frame"], in_flight=r["in_flight"],
               straddled=r["straddled"] + r["read_straddled"], ref=r["tracker_ref"],
               ref_queued=r["tracker_ref_queued"], ref_materialized=r["tracker_ref_materialized"],
               kept_velocity=r["kept_velocity"], lost=r["lost_after"])
    for key in ("fid", "gap", "local_map", "motion", "used_motion", "n_pre", "n_inliers",
                "tracked"):
        out[f"first_{key}"] = first.get(key)
    for key in ("pred_err", "still_err", "last_err"):
        if key in first:
            out[key] = [round(first[key]["centre"], 4), round(first[key]["rot_deg"], 3)]
    return out


def _compare(rows) -> None:
    """The corrections that lost a frame after them beside those that did
    not: medians of the gap, the dropped frames, the prediction's error and
    the first frame's inliers, and how often the reference keyframe was
    still waiting."""
    for lost in (True, False):
        sel = [r for r in rows if bool(r["lost"]) == lost]
        if not sel:
            continue

        def med(key, sel=sel):
            v = [r[key] for r in sel if r.get(key) is not None]
            return float(np.median(v)) if v else None

        def med_err(key, i, sel=sel):
            v = [r[key][i] for r in sel if key in r]
            return float(np.median(v)) if v else None

        motion = [r["first_motion"][0] for r in sel if r.get("first_motion")]
        print(f"[repeats] corrections {'losing' if lost else 'keeping'} the next frames: "
              f"{len(sel)}; gap median {med('first_gap')}, frames dropped "
              f"{[len(r['in_flight']) + len(r['straddled']) for r in sel]}, reference keyframe "
              f"waiting in {sum(r['ref_queued'] for r in sel)}, not materialized in "
              f"{sum(not r['ref_materialized'] for r in sel)}; predicted centre error median "
              f"{med_err('pred_err', 0)}, rotation {med_err('pred_err', 1)} deg (last pose "
              f"held: {med_err('still_err', 0)}; remap {med_err('last_err', 0)}); first motion "
              f"search inliers median {float(np.median(motion)) if motion else None}, "
              f"fallback used {sum(r.get('first_used_motion') is False for r in sel)}, "
              f"local map median {med('first_local_map')}", flush=True)


def _built(sys_, on_build):
    on_build(sys_)
    return sys_


if __name__ == "__main__":
    sys.exit(main())
