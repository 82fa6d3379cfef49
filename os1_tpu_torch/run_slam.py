"""Command-line entry point, the reference's main.cc. Port of
os1_tpu/run_slam.py:

    python -m os1_tpu_torch.run_slam [settings.yaml] [sequence] [options]

``sequence`` is a video file, a TUM/EuRoC/KITTI dataset directory, an image
directory or a webcam index; ``--synthetic`` (or no settings and no
sequence) runs the built-in rendered scene at 640x480, 1024 features and 8
levels. The default is the reference's thread topology (pipelined tracking,
the LocalMapping and LoopClosing threads); ``--sync`` runs everything on one
thread. Prints one JSON summary line, exports the trajectory and the map on
request, and exits 1 if a worker thread caught an exception.

Two options differ from the JAX package's: ``--device`` (``cuda``, the
default, or ``cpu``), and ``--warmup``, which builds the hand-written
libraries of ``csrc/`` into ``_build/``, then runs ``System.warmup()`` on the
run's configuration (the JAX package's fills its XLA compile cache), prints
both times and exits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="os1_tpu_torch.run_slam",
                                description="monocular SLAM on an NVIDIA GPU (os1 capabilities)")
    p.add_argument("settings", nargs="?", default=None,
                   help="calibration YAML (the reference's webcam.yaml schema)")
    p.add_argument("sequence", nargs="?", default=None,
                   help="video file / dataset dir / webcam index")
    p.add_argument("--synthetic", action="store_true", help="run on the built-in synthetic scene")
    p.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    p.add_argument("--save-map", default=None, help="save the Osmap map to this base path")
    p.add_argument("--load-map", default=None, help="load an Osmap map before the start")
    p.add_argument("--save-trajectory", default=None, help="write the TUM keyframe trajectory")
    p.add_argument("--localization", action="store_true",
                   help="localization-only mode (frozen map)")
    p.add_argument("--no-loop-closing", action="store_true")
    p.add_argument("--viewer", action="store_true", help="live viewer windows")
    p.add_argument("--sync", action="store_true",
                   help="synchronous single-thread pipeline (deterministic; the default is "
                        "the pipelined tracker with the mapping and loop-closing threads, "
                        "as the reference runs)")
    p.add_argument("--snapshots", default=None, help="snapshot directory")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU; the default is the card (cuda), and the run "
                        "stops with an error without one")
    p.add_argument("--warmup", action="store_true",
                   help="build the csrc/ libraries into _build/, run System.warmup() and "
                        "exit; later runs start without compiling")
    return p


def _synthetic(n_frames: int):
    """(config, ground-truth poses, sequence) of the built-in scene."""
    from .features.orb import OrbConfig
    from .geometry.camera import Camera
    from .io import synthetic
    from .map.store import MapConfig
    from .pipeline import SlamConfig

    H, W = 480, 640
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    cfg = SlamConfig(camera=Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=W, height=H),
                     orb=OrbConfig(height=H, width=W),
                     map=MapConfig(max_keyframes=128, max_points=16384, n_features=1024))
    scene = synthetic.default_scene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, advance=0.04)
    seq = ((i / 30.0, synthetic.render(scene, T, K, H, W)) for i, T in enumerate(poses))
    return cfg, poses, seq


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .pipeline import System, TrackingState

    if args.warmup:
        # The libraries first, then the system's first-use costs
        # (System.warmup), on the configuration a run would use.
        from .ops.cuda_build import load_libraries

        t0 = time.perf_counter()
        built = load_libraries(cuda=args.device != "cpu")
        print(f"warmup: {len(built)} libraries ready in {time.perf_counter() - t0:.1f} s "
              f"(build seconds: {built})")
        if args.settings is None:
            cfg = _synthetic(1)[0]
        else:
            from .io.config import load_slam_config

            cfg = load_slam_config(args.settings)
        sys_ = System(cfg=cfg, enable_loop_closing=not args.no_loop_closing,
                      pipelined=not args.sync, async_mapping=not args.sync,
                      device=args.device)
        try:
            warm_s = sys_.warmup(include_loop=not args.no_loop_closing)
        finally:
            sys_.shutdown()
        print(f"warmup: System.warmup() in {warm_s:.1f} s; kernel launches "
              f"{sys_.warmup_launches}")
        return 0

    gt_poses = None
    video_src = None
    if args.synthetic or (args.settings is None and args.sequence is None):
        cfg, gt_poses, seq = _synthetic(args.frames or 120)
    else:
        from .io.config import load_slam_config
        from .io.datasets import open_sequence

        cfg = load_slam_config(args.settings)
        if args.sequence is None:
            print("no sequence given", file=sys.stderr)
            return 2
        if args.sequence.isdigit() or args.sequence.endswith((".mp4", ".avi", ".mkv", ".mov",
                                                               ".webm")):
            # Webcam or video file through the VideoSource thread: the
            # viewer's pause/reverse/seek controls drive it live
            # (Video.cpp:60-73,154-159; Viewer.cc:128).
            from .io.video import VideoSource

            video_src = VideoSource(int(args.sequence) if args.sequence.isdigit()
                                    else args.sequence)

            def cam_seq():
                t0 = time.time()
                while (f := video_src.get_image()) is not None:
                    yield time.time() - t0, f

            seq = cam_seq()
        else:
            seq = open_sequence(args.sequence)

    sys_ = System(cfg=cfg, enable_loop_closing=not args.no_loop_closing,
                  pipelined=not args.sync, async_mapping=not args.sync, device=args.device)
    try:
        if args.load_map:
            sys_.load_map(args.load_map)
        if args.localization:
            sys_.activate_localization_mode()

        from .viz.viewer import Viewer

        viewer = Viewer(sys_, live=args.viewer, snapshot_dir=args.snapshots,
                        video_source=video_src)
        n_frames = n_ok = 0
        t_start = time.time()
        est, gt = [], []
        for ts, img in seq:
            state, Tcw = sys_.track_monocular(img, timestamp=ts)
            viewer.update(img, state, Tcw)
            n_frames += 1
            if state == TrackingState.OK:
                n_ok += 1
                if gt_poses is not None and Tcw is not None:
                    est.append(Tcw)
                    gt.append(gt_poses[n_frames - 1])
            if args.frames and n_frames >= args.frames:
                break
            if viewer.quit_requested:
                break
        wall = time.time() - t_start
        viewer.close()
        sys_.flush()  # the frames in flight and the keyframe queues

        if args.save_trajectory:
            sys_.save_keyframe_trajectory_tum(args.save_trajectory)
        if args.save_map:
            sys_.save_map(args.save_map)

        summary = {
            "frames": n_frames,
            "tracked_fraction": round(n_ok / max(n_frames, 1), 3),
            "fps": round(n_frames / max(wall, 1e-9), 2),
            "keyframes": sys_.store.n_keyframes(),
            "map_points": sys_.store.n_points(),
            "loops_closed": sys_.loop_closer.n_loops_closed,
            "final_state": sys_.state.name,
        }
        if est:
            from .io.synthetic import ate_rmse

            summary["ate_rmse_vs_groundtruth"] = round(ate_rmse(est, gt), 5)
        print(json.dumps(summary))
    finally:
        sys_.shutdown()
        if video_src is not None:
            video_src.stop()
    errors = sys_.worker_errors()
    for name, kf, exc in errors:
        print(f"{name} thread: keyframe {kf}: {exc!r}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
