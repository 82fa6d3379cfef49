"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (os1_tpu_torch, never JAX) once at the bench
configuration (640x480, 1024 features, 8 levels, MapConfig(128, 16384)) with
mapping off, and fails (non-zero exit, no final result line) if any phase
fails:

  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles csrc/hamming.cu for sm_90a from this checkout;
  3. kernel vs plain: the Hamming kernel against its plain PyTorch version
     on the card at the main path's shapes and a ragged one, exactly, with
     the device time of both (CUDA-graph replay, CUDA events) and the eager
     per-call time;
  4. slice: renders the 100-frame orbit sequence and tracks it through
     System.track_monocular, gated on initialization, tracked frames, ATE
     against ground truth and the kernel's launch count on the main path;
  5. a second pass with synchronised stage timers for the stage table, and
     whether it reproduced the first pass.

The last line is {"ok": true, "device": {...}}; the line before it gives the
card's name and power limit, and the one before that lists the kernels.
``--json PATH`` also writes every number of the run to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
N_FRAMES = 100
BENCH_K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
GATE_INIT_BY = 10  # initialization frame (the JAX package on CPU: frame 3)
GATE_OK_THROUGH = 35  # OK on every frame from the first OK one through here
GATE_MIN_OK = 30
GATE_ATE = 0.2  # the bench's orbit gate (bench.py GATE_ATE_ORBIT)
JAX_CPU_LOST_AT = 42  # where the JAX package, mapping off, lost this sequence
HAMMING_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from os1_tpu_torch.ops import pallas_hamming

    t0 = time.perf_counter()
    pallas_hamming.load_library()
    dt = time.perf_counter() - t0
    nvcc = pallas_hamming.build_seconds
    built = f"nvcc {nvcc:.3f}s" if nvcc is not None else "already built in _build/"
    log(f"[build] csrc/hamming.cu for sm_90a: {built}, load total {dt:.3f}s")
    return dt


def _event_ms(fn, reps: int = 50) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 50) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def phase_kernel():
    import torch

    from os1_tpu_torch.ops.hamming import hamming_matrix
    from os1_tpu_torch.ops.pallas_hamming import hamming_matrix_cuda

    rng = np.random.default_rng(0)
    rows = []
    for n, m in HAMMING_SHAPES:
        a = torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        b = torch.from_numpy(rng.integers(0, 2**32, (m, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        if not (bool((a < 0).any()) and bool((b < 0).any())):
            raise RuntimeError("the random words do not exercise bit 31")
        before = hamming_matrix_cuda.launches
        out = hamming_matrix_cuda(a, b)
        torch.cuda.synchronize()
        if hamming_matrix_cuda.launches != before + 1:
            raise RuntimeError("hamming_matrix_cuda did not count its launch")
        ref = hamming_matrix(a, b)
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        if out.shape != (n, m) or err != 0:
            raise RuntimeError(f"kernel disagrees with the plain version at [{n}, {m}]: "
                               f"max abs err {err}")
        # Device time (graph replay), in turns: plain, kernel, kernel, plain.
        g_plain_1 = _graph_ms(lambda: hamming_matrix(a, b))
        g_kernel_1 = _graph_ms(lambda: hamming_matrix_cuda(a, b))
        g_kernel_2 = _graph_ms(lambda: hamming_matrix_cuda(a, b))
        g_plain_2 = _graph_ms(lambda: hamming_matrix(a, b))
        # Eager calls back to back (what the main path pays per call,
        # host launch overhead included).
        e_kernel = _event_ms(lambda: hamming_matrix_cuda(a, b))
        e_plain = _event_ms(lambda: hamming_matrix(a, b))
        row = dict(shape=[n, m], max_abs_err=err, ms=min(g_kernel_1, g_kernel_2),
                   plain_ms=min(g_plain_1, g_plain_2),
                   ms_runs=[g_kernel_1, g_kernel_2], plain_ms_runs=[g_plain_1, g_plain_2],
                   eager_ms=e_kernel, eager_plain_ms=e_plain,
                   table_gbps=n * m * 4 / (min(g_kernel_1, g_kernel_2) * 1e-3) / 1e9)
        log(f"[kernel] hamming [{n}, {m}]: exact (max abs err {err}); device time "
            f"kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms "
            f"(runs kernel {g_kernel_1:.5f}/{g_kernel_2:.5f}, plain {g_plain_1:.5f}/{g_plain_2:.5f}); "
            f"table write {row['table_gbps']:.1f} GB/s; eager per call kernel {e_kernel:.5f} ms, "
            f"plain {e_plain:.5f} ms")
        rows.append(row)
    return rows


def build_system(device):
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig, System

    cam = Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=W, height=H)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(height=H, width=W, n_features=1024, n_levels=8),
        map=MapConfig(max_keyframes=128, max_points=16384, n_features=1024),
    )
    return System(cfg, enable_mapping=False, enable_loop_closing=False, pipelined=False,
                  device=device)


def run_sequence(sys_, frames):
    import torch

    from os1_tpu_torch.pipeline import TrackingState

    lat, states, reads = [], [], []
    for i, img in enumerate(frames):
        r0 = sys_.reads.count
        t0 = time.perf_counter()
        state, _ = sys_.track_monocular(img, timestamp=i / 30.0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        states.append(state == TrackingState.OK)
        reads.append(sys_.reads.count - r0)
    return np.array(lat), np.array(states), np.array(reads)


def phase_slice(frames, poses):
    import torch

    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.ops.pallas_hamming import hamming_matrix_cuda

    sys_ = build_system("cuda")
    torch.cuda.reset_peak_memory_stats()
    hamming_matrix_cuda.launches = 0
    lat, ok, reads = run_sequence(sys_, frames)
    launches = hamming_matrix_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    first = int(np.argmax(ok)) if ok.any() else len(ok)
    lost_at = next((i for i in range(first, len(ok)) if not ok[i]), None)
    stretch_end = lost_at if lost_at is not None else len(ok)
    traj = sys_.frame_trajectory()
    ok_ids = [fid for _, fid, _ in traj]
    est = [T for _, _, T in traj]
    finite = all(np.isfinite(T).all() and T.shape == (4, 4) for T in est)
    ate = synthetic.ate_rmse(est, [poses[f] for f in ok_ids]) if len(est) >= 3 else float("inf")
    stretch = slice(first + 1, stretch_end)  # frames tracked by the fused step
    lat_ok = lat[stretch]
    res = dict(
        init_frame=first, lost_at=lost_at, jax_cpu_lost_at=JAX_CPU_LOST_AT,
        n_ok=int(ok.sum()), ate=ate, keyframes=sys_.store.n_keyframes(),
        points=sys_.store.n_points(), hamming_launches=launches,
        fps_ok=float(len(lat_ok) / lat_ok.sum()) if len(lat_ok) else 0.0,
        p50_ms=float(np.percentile(lat_ok, 50) * 1e3) if len(lat_ok) else None,
        p99_ms=float(np.percentile(lat_ok, 99) * 1e3) if len(lat_ok) else None,
        host_reads_per_frame=float(reads[stretch].mean()) if len(lat_ok) else None,
        peak_mem_bytes=int(peak), loss_log=[list(map(str, e)) for e in sys_.tracker.loss_log],
        states="".join("O" if s else "." for s in ok),
    )
    log(f"[slice] states {res['states']}")
    log(f"[slice] init at frame {first} (gate <= {GATE_INIT_BY}); lost at {lost_at} "
        f"(JAX package on CPU: {JAX_CPU_LOST_AT}); {res['n_ok']} OK frames; "
        f"{res['keyframes']} keyframes, {res['points']} points; ATE {ate:.6f}")
    log(f"[slice] OK stretch frames {first + 1}..{stretch_end - 1}: {res['fps_ok']:.3f} frames/s, "
        f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
        f"host reads/frame {res['host_reads_per_frame']:.3f}")
    log(f"[slice] hamming_matrix_cuda launches on the main path: {launches}; "
        f"peak device memory {peak} bytes")
    log("[slice] stage table (host clock, stages not synchronised):\n" + sys_.timer.report())

    fails = []
    if first > GATE_INIT_BY:
        fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
    if not ok[first:GATE_OK_THROUGH + 1].all():
        fails.append(f"not OK on every frame {first}..{GATE_OK_THROUGH}")
    if res["n_ok"] < GATE_MIN_OK:
        fails.append(f"{res['n_ok']} OK frames < {GATE_MIN_OK}")
    if not finite:
        fails.append("non-finite or misshaped poses")
    if not ate <= GATE_ATE:
        fails.append(f"ATE {ate} > {GATE_ATE}")
    if launches <= 0:
        fails.append("hamming_matrix_cuda never launched on the main path")
    if fails:
        raise RuntimeError("slice failed: " + "; ".join(fails))
    return res, traj


def phase_stages(frames):
    """Second pass with stage timers that synchronise the card at every stage
    end, so each stage owns its device time."""
    from os1_tpu_torch.utils.profiling import StageTimer

    sys_ = build_system("cuda")
    timer = StageTimer(sync=True)
    sys_.timer = sys_.tracker.timer = timer
    _, ok, _ = run_sequence(sys_, frames)
    log("[stages] stage table (synchronised stages, second pass):\n" + timer.report())
    traj = sys_.frame_trajectory()
    return dict(stages={k: [timer.totals[k], timer.counts[k]] for k in timer.totals},
                states="".join("O" if s else "." for s in ok), traj=traj)


def phase_extractor_agreement(frames):
    """The card's extractor against the same code on the CPU, frame 0."""
    import torch

    from os1_tpu_torch.features.orb import OrbConfig, make_extractor

    cfg = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
    img = torch.as_tensor(frames[0])
    fg = make_extractor(cfg, "cuda")(img.cuda())
    fc = make_extractor(cfg, "cpu")(img)
    same_xy = float((fg.xy.cpu() == fc.xy).all(1).float().mean())
    same_desc = float((fg.desc.cpu() == fc.desc).all(1).float().mean())
    log(f"[extract] card vs CPU on frame 0: identical keypoints {same_xy:.4f}, "
        f"identical descriptors {same_desc:.4f}")
    return dict(same_xy=same_xy, same_desc=same_desc)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="write every number of the run to this file")
    args = parser.parse_args()

    import torch

    name, smi = phase_device()
    out = dict(device=name, nvidia_smi=smi)
    out["build_s"] = phase_build()
    out["hamming"] = phase_kernel()

    from os1_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    scene = synthetic.default_scene(seed=1)
    poses = synthetic.orbit_trajectory(N_FRAMES, advance=0.05)
    frames = synthetic.render_sequence(scene, poses, BENCH_K, H, W)
    log(f"[render] {N_FRAMES} frames {H}x{W} in {time.perf_counter() - t0:.3f}s")

    out["slice"], traj1 = phase_slice(frames, poses)
    second = phase_stages(frames)
    out["stages"] = second["stages"]
    same_states = second["states"] == out["slice"]["states"]
    same_traj = len(traj1) == len(second["traj"]) and all(
        a[1] == b[1] and np.array_equal(a[2], b[2]) for a, b in zip(traj1, second["traj"]))
    out["rerun_identical"] = dict(states=same_states, poses_bitwise=same_traj)
    log(f"[stages] second pass vs first: same states {same_states}, "
        f"bit-identical poses {same_traj}")
    out["extractor_agreement"] = phase_extractor_agreement(frames)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)

    big = next(r for r in out["hamming"] if r["shape"] == [4096, 1024])
    kernels = [dict(
        name="hamming_matrix_cuda", route="cuda", source="os1_tpu_torch/csrc/hamming.cu",
        replaces="os1_tpu/ops/pallas_hamming.py:37",
        launches=out["slice"]["hamming_launches"],
        max_abs_err=max(r["max_abs_err"] for r in out["hamming"]),
        ms=big["ms"], plain_ms=big["plain_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
