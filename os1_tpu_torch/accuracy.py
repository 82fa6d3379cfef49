"""Deterministic accuracy rig of the port: bench-scale ATE with
repeatability. Port of accuracy.py:41-164.

The reference is deterministic by construction: seeded RANSAC
(DUtils::Random::SeedRandOnce(0), src/Initializer.cc:80) and video-file
replay (src/Video.cpp:60-73) are its regression mechanism. This rig runs a
whole bench sequence (``io/sequences``) through ``System.track_monocular``
after ``System.warmup()``; in the sync mode (inline mapping) and the coop
mode (the shipped configuration) two runs give bit-identical trajectories,
so one run is a trustworthy accuracy measurement and a difference between
two commits is the code change.

Usage:
  python -m os1_tpu_torch.accuracy                    # sync orbit, 300 frames, 1 run
  python -m os1_tpu_torch.accuracy --runs 2           # + determinism check
  python -m os1_tpu_torch.accuracy --async --runs 3   # the shipped (coop) mode
  python -m os1_tpu_torch.accuracy --seq loop         # loop-closure sequence
  python -m os1_tpu_torch.accuracy --pose-ref         # reference 4x10-LM pose schedule
  python -m os1_tpu_torch.accuracy --debt 0           # pure drain gating (no BA debt)
  python -m os1_tpu_torch.accuracy --frames 150       # shorter sequence
  python -m os1_tpu_torch.accuracy --device cpu       # on the CPU

It prints one line a run and, with ``--runs`` > 1, the number of distinct
trajectories and the ATE spread; differing trajectories in the sync or coop
mode print ``DETERMINISM VIOLATION`` and exit 1. A sequence that cannot be
rendered (no packaged photographs) exits 2.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

from .io import sequences


def run_once(frames, poses, sync, th_overrides, threaded=False, log_lost=True, device=None,
             build=sequences.build_system):
    """One run of ``frames`` on a fresh system from ``build`` (bench.py's by
    default) on ``device`` (None: the card): ``warmup()``, every frame,
    ``flush()``; the Sim3-aligned ATE, lost frames, keyframes, points, loops
    closed and the 16-hex-digit SHA-256 of the stacked poses."""
    from .io import synthetic
    from .pipeline import TrackingState

    sys_ = build(sync=sync, threaded=threaded, device=device, **th_overrides)
    sys_.warmup()
    states = []
    for i, img in enumerate(frames):
        state, _ = sys_.track_monocular(img, timestamp=i / sequences.FPS)
        states.append(state)
    sys_.flush()

    traj = sys_.frame_trajectory()
    est = [T for (_, fid, T) in traj]
    gt = [poses[fid] for (_, fid, _) in traj]
    ate = synthetic.ate_rmse(est, gt) if len(est) >= 10 else float("nan")
    lost = [i for i, s in enumerate(states) if s != TrackingState.OK]
    if log_lost and sys_.tracker.loss_log:
        print("   loss events:", sys_.tracker.loss_log[:12])
    stacked = np.stack(est) if est else np.zeros((0, 4, 4), np.float32)
    digest = hashlib.sha256(np.ascontiguousarray(stacked).tobytes()).hexdigest()[:16]
    out = dict(
        ate=ate,
        n_tracked=len(est),
        n_lost=len(lost),
        lost=lost[:40],
        n_keyframes=sys_.store.n_keyframes(),
        n_points=sys_.store.n_points(),
        n_loops=sys_.loop_closer.n_loops_closed,
        traj_sha=digest,
    )
    sys_.shutdown()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Deterministic accuracy rig of the port.")
    ap.add_argument("--frames", type=int, default=sequences.N_FRAMES)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--seq", choices=sequences.SEQUENCES, default="orbit")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="bench configuration (pipelined + cooperative mapping), "
                         "deterministic like sync")
    ap.add_argument("--threaded", action="store_true",
                    help="worker-thread topology (scheduler-dependent; implies --async)")
    ap.add_argument("--pose-ref", action="store_true",
                    help="reference 4x10-LM pose-opt schedule with reclassification")
    ap.add_argument("--debt", type=int, default=None,
                    help="ba_debt_max override (0 = pure drain gating)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="TrackingThresholds override")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="per-frame Gaussian photometric noise sigma (gray levels); distinct "
                         "--noise-seed values estimate the ATE spread across feature "
                         "realizations")
    ap.add_argument("--noise-seed", type=int, default=0)
    return ap.parse_args(argv)


def thresholds(args) -> dict:
    """The TrackingThresholds overrides of ``--pose-ref``, ``--debt`` and
    ``--set``."""
    th = {}
    if args.pose_ref:
        th.update(pose_opt_rounds=4, pose_opt_iters=10, pose_opt_reject=True)
    if args.debt is not None:
        th.update(ba_debt_max=args.debt)
    for kv in args.set:
        k, v = kv.split("=", 1)
        th[k] = json.loads(v)
    return th


def main(argv=None) -> int:
    args = parse_args(argv)
    th = thresholds(args)
    frames, poses = sequences.frames(args.seq, args.frames)
    if frames is None:
        print("sequence unavailable (no bundled photos)", file=sys.stderr)
        return 2
    if args.noise > 0.0:
        rng = np.random.default_rng(args.noise_seed)
        frames = np.clip(
            frames.astype(np.float32)
            + rng.normal(0.0, args.noise, frames.shape).astype(np.float32),
            0, 255,
        ).astype(np.uint8)
    path_len = sequences.path_length(poses)

    if args.threaded:
        args.async_ = True
    results = []
    for r in range(args.runs):
        out = run_once(frames, poses, sync=not args.async_, th_overrides=th,
                       threaded=args.threaded, device=args.device)
        results.append(out)
        print(
            f"run {r}: ATE {out['ate']:.4f} ({out['ate'] / path_len * 100:.2f}% "
            f"of {path_len:.1f}-unit path)  tracked {out['n_tracked']}/"
            f"{len(frames)}  lost {out['lost'] if out['n_lost'] else '[]'}  "
            f"KFs {out['n_keyframes']}  pts {out['n_points']}  "
            f"loops {out['n_loops']}  sha {out['traj_sha']}",
            flush=True,
        )

    if args.runs > 1:
        shas = {o["traj_sha"] for o in results}
        ates = [o["ate"] for o in results]
        mode = "threaded" if args.threaded else "coop" if args.async_ else "sync"
        print(f"{mode}: {len(shas)} distinct trajectories over {args.runs} runs; "
              f"ATE spread [{min(ates):.4f}, {max(ates):.4f}]", flush=True)
        # The sync and coop modes are deterministic by construction; only
        # the worker-thread topology depends on the scheduler.
        if not args.threaded and len(shas) != 1:
            print(f"DETERMINISM VIOLATION: {mode} runs differ", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
