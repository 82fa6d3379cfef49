"""Both packages on bench.py's loop sequence, on the CPU, in the shipped mode.

    python3 scripts/compare_loop_cpu.py --out DIR [--frames 300] [--threads 3]

Renders bench.py's loop sequence (room_scene(seed=3), loop_trajectory(300),
640x480) once with the port's renderer and tracks the same frames through

  * the JAX package: ``os1_tpu.pipeline.System(cfg, pipelined=True,
    coop_mapping=True)``, built by ``bench.build_system()``;
  * the port: ``os1_tpu_torch.pipeline.System(..., device="cpu")``, built by
    ``chip_smoke.build_system(shipped=True, loop=True)``, with the JAX
    tracker's two-view RANSAC draws replayed (the Sim3 and relocalization
    draws stay each package's own);

each in its own process, both at once (``--threads`` torch / XLA threads
each). For each package it records per frame the tracking state, the live
keyframe and point counts, the reference keyframe, the frame applied last
with its local-map inliers and pose, every Sim3 candidate evaluation
(frame, keyframe, candidate, success, matches, projected matches, LM
inliers) and the loss log. It prints the frame of each package's loop
correction with its loop edge, the states of the 5 frames after it, and the
first frame at which the two packages' records differ, with the largest
pose difference before it. The frames and everything recorded are written
to ``DIR`` (``compare.json``).

Needs both packages, so it runs where JAX is installed; it never uses a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
AFTER = 5  # frames shown after each correction


def _track(sys_, frames, lc, log, state_name):
    """Track every frame; per frame the state, keyframes and reference keyframe."""
    rows = []
    for i, img in enumerate(frames):
        log["frame"] = i
        loops0 = lc.n_loops_closed
        state, _ = sys_.track_monocular(img, timestamp=i / 30.0)
        last = sys_.tracker.last
        rows.append(dict(frame=i, state=state_name(state), keyframes=int(sys_.store.kf_valid.sum()),
                         points=int(sys_.store.pt_valid.sum()), ref_kf=int(sys_.tracker.ref_kf),
                         loops=lc.n_loops_closed, corrected=lc.n_loops_closed > loops0,
                         applied=-1 if last is None else int(last.frame_id),
                         n_inliers=-1 if last is None else int(last.n_inliers),
                         Tcw=None if last is None else np.asarray(last.Tcw, float).tolist()))
    sys_.flush()
    return rows


def run_jax(frames, threads):
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("XLA_FLAGS", f"--xla_cpu_multi_thread_eigen=true "
                                       f"intra_op_parallelism_threads={threads}")
    import bench

    sys_ = bench.build_system()
    lc = sys_.loop_closer
    log = dict(frame=-1, evals=[], pending=[])
    snapshot, dispatch, fetch = lc._snapshot_sim3, lc._dispatch_sim3, lc._fetch_sim3
    ids = {}

    def snap_logged(kf, cand):
        snap = snapshot(kf, cand)
        ids[id(snap)] = (int(kf), int(cand))
        return snap

    def dispatch_logged(snap):
        log["pending"].append(ids.pop(id(snap)))
        return dispatch(snap)

    def fetch_logged(dev):
        head = np.asarray(dev[0])
        kf, cand = log["pending"].pop(0)
        log["evals"].append([log["frame"], kf, cand, bool(head[0] > 0.5), int(head[1]),
                             int(head[2]), int(head[3])])
        return fetch(dev)

    lc._snapshot_sim3, lc._dispatch_sim3, lc._fetch_sim3 = (snap_logged, dispatch_logged,
                                                            fetch_logged)
    rows = _track(sys_, frames, lc, log, lambda s: s.name)
    return rows, log["evals"], sys_, lc


class ReplaySampler:
    """The JAX tracker's two-view RANSAC draws, replayed for the port: per
    bootstrap attempt the tracker splits its key and the initializer splits
    the subkey into the homography and fundamental keys."""

    def __init__(self):
        import jax

        self.jax = jax
        self.key = jax.random.PRNGKey(0)
        self.pending = []

    def __call__(self, valid, iters, k):
        import torch
        from os1_tpu.solvers.initializer import _sample_indices

        if not self.pending:
            self.key, sub = self.jax.random.split(self.key)
            self.pending = list(self.jax.random.split(sub))
        idx = _sample_indices(self.pending.pop(0), self.jax.numpy.asarray(valid.numpy()), iters, k)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


def run_torch(frames, threads):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(threads)
    import chip_smoke

    sys_ = chip_smoke.build_system("cpu", mapping=True, shipped=True, loop=True)
    sys_.tracker.sampler = ReplaySampler()
    lc = sys_.loop_closer
    log = dict(frame=-1, evals=[])
    fetch = lc._fetch_sim3

    def fetch_logged(dev, kf, cand):
        n0 = len(lc.sim3_log)
        out = fetch(dev, kf, cand)
        r = lc.sim3_log[n0]
        log["evals"].append([log["frame"], r[0], r[1], r[8], r[2], r[4], r[3]])
        return out

    lc._fetch_sim3 = fetch_logged
    rows = _track(sys_, frames, lc, log, lambda s: s.name)
    return rows, log["evals"], sys_, lc


def child(pkg, out_dir, threads):
    frames = np.load(os.path.join(out_dir, "frames.npy"))
    poses = np.load(os.path.join(out_dir, "poses.npy"))
    t0 = time.perf_counter()
    rows, evals, sys_, lc = (run_jax if pkg == "jax" else run_torch)(frames, threads)
    from os1_tpu_torch.io import synthetic  # numpy ATE; imports no JAX

    traj = sys_.frame_trajectory()
    ate = synthetic.ate_rmse([np.asarray(T) for _, _, T in traj],
                             [poses[f] for _, f, _ in traj])
    res = dict(package=pkg, seconds=time.perf_counter() - t0, rows=rows, evals=evals,
               loop_edges=[list(map(int, e)) for e in lc.loop_edges], ate=float(ate),
               loss_log=[[int(f), str(r)] for f, r in sys_.tracker.loss_log])
    with open(os.path.join(out_dir, f"{pkg}.json"), "w") as f:
        json.dump(res, f)


def summary(res):
    rows = res["rows"]
    states = "".join("O" if r["state"] == "OK" else "." for r in rows)
    corr = [r["frame"] for r in rows if r["corrected"]]
    out = dict(seconds=res["seconds"], ate=res["ate"], loop_edges=res["loop_edges"],
               loss_log=res["loss_log"], states=states, corrections=corr,
               n_evals=len(res["evals"]))
    out["after_correction"] = {c: [[r["frame"], r["state"]] for r in rows[c + 1:c + 1 + AFTER]]
                               for c in corr}
    return out


def first_difference(a, b):
    """The first frame at which the states, keyframe or point counts, the
    reference keyframe, the applied frame's local-map inliers or the
    candidate evaluations made during it differ, with the largest pose
    difference of the applied frames before it."""
    ev_a, ev_b = {}, {}
    for e in a["evals"]:
        ev_a.setdefault(e[0], []).append(e[1:])
    for e in b["evals"]:
        ev_b.setdefault(e[0], []).append(e[1:])
    dpose = 0.0
    for ra, rb in zip(a["rows"], b["rows"]):
        f = ra["frame"]
        what = [k for k in ("state", "keyframes", "points", "ref_kf", "loops", "applied",
                            "n_inliers") if ra[k] != rb[k]]
        if ev_a.get(f, []) != ev_b.get(f, []):
            what.append("sim3 evaluations")
        if what:
            return dict(frame=f, differs=what, max_pose_diff_before=dpose,
                        jax=dict(ra, evals=ev_a.get(f, [])), torch=dict(rb, evals=ev_b.get(f, [])))
        if ra["Tcw"] is not None and rb["Tcw"] is not None:
            dpose = max(dpose, float(np.abs(np.subtract(ra["Tcw"], rb["Tcw"])).max()))
    return None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--threads", type=int, default=3)
    p.add_argument("--out", required=True, help="directory for the frames and the records")
    p.add_argument("--child", choices=("jax", "torch"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(args.child, args.out, args.threads)
        return 0

    import chip_smoke

    os.makedirs(args.out, exist_ok=True)
    frames, poses = chip_smoke.render_loop(args.frames)
    np.save(os.path.join(args.out, "frames.npy"), frames)
    np.save(os.path.join(args.out, "poses.npy"), np.asarray(poses))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", pkg,
                               "--out", args.out, "--threads", str(args.threads)], env=env)
             for pkg in ("jax", "torch")]
    rcs = [pr.wait() for pr in procs]
    if any(rcs):
        print(f"a package's run failed: exit codes {rcs}", file=sys.stderr)
        return 1
    res = {}
    for pkg in ("jax", "torch"):
        with open(os.path.join(args.out, f"{pkg}.json")) as f:
            res[pkg] = json.load(f)
    out = {pkg: summary(r) for pkg, r in res.items()}
    out["first_difference"] = first_difference(res["jax"], res["torch"])
    for pkg in ("jax", "torch"):
        s = out[pkg]
        print(f"[{pkg}] {s['seconds']:.1f}s; ATE {s['ate']:.6f}; corrections at frames "
              f"{s['corrections']} (loop edges {s['loop_edges']}); {s['n_evals']} Sim3 "
              f"evaluations; loss log {s['loss_log']}")
        print(f"[{pkg}] states {s['states']}")
        for c, after in s["after_correction"].items():
            print(f"[{pkg}] the {AFTER} frames after the correction at {c}: {after}")
    print(f"[compare] first difference: {json.dumps(out['first_difference'])}")
    with open(os.path.join(args.out, "compare.json"), "w") as f:
        json.dump(dict(summary=out, runs=res), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
