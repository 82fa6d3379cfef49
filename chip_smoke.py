"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (os1_tpu_torch, never JAX) at the bench
configuration (640x480, 1024 features, 8 levels, MapConfig(128, 16384)) and
fails (non-zero exit, no final result line) if any phase fails:

  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every csrc/*.cu for sm_90a from this checkout, one nvcc
     per source, all started together;
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes and a ragged one, exactly, with the
     device time of both (CUDA-graph replay, CUDA events), the time of the
     one PyTorch call that computes the same function where there is one,
     the eager per-call time and the bound: K1 the Hamming table
     ([hamming]), P1 the keypoint patch gather and P2 the BRIEF sample
     gather of the extractor ([patches]);
  4. slice: the 100-frame orbit tracked with mapping off, gated on
     initialization, every frame OK through frame 35, ATE and kernel
     launches (without a mapper the map stops growing and the run is lost
     once the camera leaves it);
  5. mapping: the bench's 300-frame orbit tracked with local mapping on,
     gated on initialization by frame 10, every frame OK from the first OK
     one to the end, ATE <= 0.2 and launches of every kernel on this path;
  6. a second mapping pass with synchronised stage timers for the stage
     table, and whether it reproduced the first pass bit for bit;
  7. the card's extractor against the same code on the CPU.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H, W = 480, 640
N_FEATURES, N_LEVELS = 1024, 8
MAP_KEYFRAMES, MAP_POINTS = 128, 16384
N_FRAMES = 100  # the mapping-off slice's orbit
N_FRAMES_MAP = 300  # bench.py's orbit (bench.py:26)
BENCH_K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
GATE_INIT_BY = 10  # initialization frame (the JAX package on CPU: frame 3)
GATE_OK_THROUGH = 35  # mapping off: OK on every frame from the first OK one through here
GATE_MIN_OK = 30
GATE_ATE = 0.2  # the bench's orbit gate (bench.py GATE_ATE_ORBIT)
JAX_CPU_LOST_AT = 42  # where the JAX package, mapping off, lost this sequence
HAMMING_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777))
PATCH_COUNTS = (1024, 1000)  # keypoints: the main path's, and a ragged count
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet, 700 W)


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
    """Build every kernel library from csrc/, the nvcc runs side by side."""
    from os1_tpu_torch.ops import pallas_hamming, patches

    libs = (pallas_hamming.LIBRARY, patches.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.load(), libs))
    dt = time.perf_counter() - t0
    for lib in libs:
        built = (f"nvcc {lib.build_seconds:.3f}s" if lib.build_seconds is not None
                 else "already built in _build/")
        log(f"[build] {os.path.relpath(lib.source)} for sm_90a: {built}")
    log(f"[build] all kernels loaded in {dt:.3f}s")
    return dt


def _bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


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


def _timings(kernel, plain, library=None):
    """Device time per call by graph replay, in turns plain, kernel, kernel,
    plain (and the library call last); eager per-call time of the kernel."""
    g_plain_1 = _graph_ms(plain)
    g_kernel_1 = _graph_ms(kernel)
    g_kernel_2 = _graph_ms(kernel)
    g_plain_2 = _graph_ms(plain)
    return dict(ms=min(g_kernel_1, g_kernel_2), plain_ms=min(g_plain_1, g_plain_2),
                ms_runs=[g_kernel_1, g_kernel_2], plain_ms_runs=[g_plain_1, g_plain_2],
                library_ms=_graph_ms(library) if library is not None else None,
                eager_ms=_event_ms(kernel), eager_plain_ms=_event_ms(plain))


def _fmt(row) -> str:
    lib = f"{row['library_ms']:.5f} ms" if row["library_ms"] is not None else "none"
    return (f"device time kernel {row['ms']:.5f} ms (runs {row['ms_runs'][0]:.5f}/"
            f"{row['ms_runs'][1]:.5f}), plain {row['plain_ms']:.5f} ms, library call {lib}, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); eager per call kernel "
            f"{row['eager_ms']:.5f} ms, plain {row['eager_plain_ms']:.5f} ms")


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
        # No single PyTorch call computes a popcount Hamming table.
        row = dict(shape=[n, m], max_abs_err=err,
                   **_timings(lambda: hamming_matrix_cuda(a, b), lambda: hamming_matrix(a, b)))
        # Bytes: both descriptor sets read once, the int32 table written once.
        row.update(bound_ms=_bound_ms((n + m) * 32 + n * m * 4), bound_by="bytes")
        row["table_gbps"] = n * m * 4 / (row["ms"] * 1e-3) / 1e9
        log(f"[hamming] [{n}, {m}]: exact (max abs err {err}); {_fmt(row)}; "
            f"table write {row['table_gbps']:.1f} GB/s")
        rows.append(row)
    return rows


def _patch_keypoints(rng, n):
    """Keypoints over the level stack, the first ones on and past every edge
    (padding lanes may sit anywhere and must read in bounds)."""
    k = np.stack([rng.integers(0, N_LEVELS, n), rng.integers(19, H - 19, n),
                  rng.integers(19, W - 19, n)], 1).astype(np.int32)
    e = np.array([[0, 0, 0], [N_LEVELS - 1, H - 1, W - 1], [0, -40, 5], [N_LEVELS - 1, 3, W + 50],
                  [0, H - 16, 14], [N_LEVELS - 1, 14, W - 16]], np.int32)
    k[: len(e)] = e
    return k


def phase_patches():
    """P1 and P2 against their plain versions on the card, exactly."""
    import torch

    from os1_tpu_torch.features.orb import _rotated_patch_table
    from os1_tpu_torch.ops import patches as tp

    rng = np.random.default_rng(1)
    stack = torch.from_numpy(rng.normal(size=(N_LEVELS, H, W)).astype(np.float32)).cuda()
    table = torch.from_numpy(_rotated_patch_table(42)).cuda()
    out = dict(p1=[], p2=[])
    for n in PATCH_COUNTS:
        kps = torch.from_numpy(_patch_keypoints(rng, n)).cuda()
        got = tp.extract_patches_cuda(stack, kps)
        torch.cuda.synchronize()
        err1 = float((got - tp.extract_patches(stack, kps)).abs().max())
        flat = got.reshape(n, tp.PS * tp.PS)
        abin = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).cuda()
        samples = tp.sample_patches_cuda(flat, abin, table)
        torch.cuda.synchronize()
        err2 = float((samples - tp.sample_patches(flat, abin, table)).abs().max())
        if err1 != 0 or err2 != 0 or got.shape != (n, 32, 32) or samples.shape != (n, 512):
            raise RuntimeError(f"patch kernels disagree with the plain versions at N={n}: "
                               f"max abs err P1 {err1}, P2 {err2}")
        # The one PyTorch call for each: advanced indexing with the window
        # indices precomputed (P1), torch.gather on the precomputed sample
        # index (P2).
        k = kps.long()
        r = torch.arange(tp.PS, device="cuda")
        li = k[:, 0].clamp(0, N_LEVELS - 1)[:, None, None]
        ri = ((k[:, 1] - tp.HALF).clamp(0, H - tp.PS)[:, None] + r)[:, :, None]
        ci = ((k[:, 2] - tp.HALF).clamp(0, W - tp.PS)[:, None] + r)[:, None, :]
        idx = table[abin.long()].long()
        row1 = dict(n=n, max_abs_err=err1, **_timings(
            lambda: tp.extract_patches_cuda(stack, kps), lambda: tp.extract_patches(stack, kps),
            lambda: stack[li, ri, ci]))
        # Bytes: the N windows read once and written once, the keypoints read.
        row1.update(bound_ms=_bound_ms(2 * n * 1024 * 4 + n * 12), bound_by="bytes")
        row2 = dict(n=n, max_abs_err=err2, **_timings(
            lambda: tp.sample_patches_cuda(flat, abin, table),
            lambda: tp.sample_patches(flat, abin, table), lambda: torch.gather(flat, 1, idx)))
        # Bytes: patches, bins and table read once, the samples written once.
        row2.update(bound_ms=_bound_ms(n * 1024 * 4 + n * 4 + table.numel() * 4 + n * 512 * 4),
                    bound_by="bytes")
        log(f"[patches] P1 N={n}: exact; {_fmt(row1)}")
        log(f"[patches] P2 N={n}: exact; {_fmt(row2)}")
        out["p1"].append(row1)
        out["p2"].append(row2)
    return out


def build_system(device, mapping: bool):
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig, System

    cam = Camera.make(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=W, height=H)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS),
        map=MapConfig(max_keyframes=MAP_KEYFRAMES, max_points=MAP_POINTS, n_features=N_FEATURES),
    )
    return System(cfg, enable_mapping=mapping, enable_loop_closing=False, pipelined=False,
                  device=device)


def _counters():
    from os1_tpu_torch.ops import patches
    from os1_tpu_torch.ops.pallas_hamming import hamming_matrix_cuda

    return {"hamming_matrix_cuda": hamming_matrix_cuda,
            "extract_patches_cuda": patches.extract_patches_cuda,
            "sample_patches_cuda": patches.sample_patches_cuda}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(frames, mapping: bool, device="cuda", timer=None):
    """Track ``frames`` through System.track_monocular, with every kernel
    launch count set to 0 just before and read just after. Returns the
    system, per-frame latency, OK flags, host reads and launch counts."""
    from os1_tpu_torch.pipeline import TrackingState

    sys_ = build_system(device, mapping)
    if timer is not None:
        sys_.set_timer(timer)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    lat, states, reads = [], [], []
    for i, img in enumerate(frames):
        r0 = sys_.reads.count
        t0 = time.perf_counter()
        state, _ = sys_.track_monocular(img, timestamp=i / 30.0)
        _sync(device)
        lat.append(time.perf_counter() - t0)
        states.append(state == TrackingState.OK)
        reads.append(sys_.reads.count - r0)
    launches = {k: c.launches for k, c in counters.items()}
    return sys_, np.array(lat), np.array(states), np.array(reads), launches


def summarize(sys_, lat, ok, reads, launches, poses, stretch_end=None):
    """The end-to-end numbers of one driven path."""
    from os1_tpu_torch.io import synthetic

    first = int(np.argmax(ok)) if ok.any() else len(ok)
    lost_at = next((i for i in range(first, len(ok)) if not ok[i]), None)
    if stretch_end is None:
        stretch_end = lost_at if lost_at is not None else len(ok)
    traj = sys_.frame_trajectory()
    est = [T for _, _, T in traj]
    finite = all(np.isfinite(T).all() and T.shape == (4, 4) for T in est)
    ate = (synthetic.ate_rmse(est, [poses[f] for _, f, _ in traj]) if len(est) >= 3
           else float("inf"))
    lat_ok = lat[first + 1:stretch_end]  # frames tracked by the fused step
    st = sys_.store
    return dict(
        init_frame=first, lost_at=lost_at, n_ok=int(ok.sum()), ate=ate, finite=finite,
        keyframes=st.n_keyframes(), keyframes_culled=int(st._kf_seq_next - st.n_keyframes()),
        points=st.n_points(), launches=launches,
        fps_ok=float(len(lat_ok) / lat_ok.sum()) if len(lat_ok) else 0.0,
        p50_ms=float(np.percentile(lat_ok, 50) * 1e3) if len(lat_ok) else None,
        p99_ms=float(np.percentile(lat_ok, 99) * 1e3) if len(lat_ok) else None,
        host_reads_per_frame=float(reads[first + 1:stretch_end].mean()) if len(lat_ok) else None,
        loss_log=[list(map(str, e)) for e in sys_.tracker.loss_log],
        states="".join("O" if s else "." for s in ok), stretch=[first + 1, stretch_end - 1],
    ), traj


def _log_path(tag, res):
    log(f"[{tag}] states {res['states']}")
    log(f"[{tag}] init at frame {res['init_frame']} (gate <= {GATE_INIT_BY}); lost at "
        f"{res['lost_at']}; {res['n_ok']} OK frames; {res['keyframes']} keyframes live, "
        f"{res['keyframes_culled']} culled, {res['points']} points; ATE {res['ate']:.6f}")
    a, b = res["stretch"]
    log(f"[{tag}] OK stretch frames {a}..{b}: {res['fps_ok']:.3f} frames/s, "
        f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
        f"host reads/frame {res['host_reads_per_frame']:.3f}")
    log(f"[{tag}] kernel launches on this path: {res['launches']}; "
        f"peak device memory {res['peak_mem_bytes']} bytes")


def _launch_gate(res, fails):
    for k, v in res["launches"].items():
        if v <= 0:
            fails.append(f"{k} never launched on this path")


def phase_slice(frames, poses):
    """The mapping-off path (tracking alone) with its gates."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    sys_, lat, ok, reads, launches = drive(frames, mapping=False)
    res, _ = summarize(sys_, lat, ok, reads, launches, poses)
    res["jax_cpu_lost_at"] = JAX_CPU_LOST_AT
    res["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    _log_path("slice", res)
    first = res["init_frame"]
    fails = []
    if first > GATE_INIT_BY:
        fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
    if not ok[first:GATE_OK_THROUGH + 1].all():
        fails.append(f"not OK on every frame {first}..{GATE_OK_THROUGH}")
    if res["n_ok"] < GATE_MIN_OK:
        fails.append(f"{res['n_ok']} OK frames < {GATE_MIN_OK}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    if not res["ate"] <= GATE_ATE:
        fails.append(f"ATE {res['ate']} > {GATE_ATE}")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("slice failed: " + "; ".join(fails))
    return res


def phase_mapping(frames, poses):
    """The main path: tracking with local mapping on, over the bench orbit."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    sys_, lat, ok, reads, launches = drive(frames, mapping=True)
    res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
    res["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    res["frames"] = len(frames)
    _log_path("mapping", res)
    log("[mapping] stage table (host clock, stages not synchronised):\n" + sys_.timer.report())
    first = res["init_frame"]
    fails = []
    if first > GATE_INIT_BY:
        fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
    if not ok[first:].all():
        fails.append(f"not OK on every frame {first}..{len(frames) - 1}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    if not res["ate"] <= GATE_ATE:
        fails.append(f"ATE {res['ate']} > {GATE_ATE}")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("mapping failed: " + "; ".join(fails))
    return res, traj


def phase_stages(frames, first):
    """Second mapping pass with stage timers that synchronise the card at
    every stage end, so each stage owns its device time; and whether it
    reproduced the first pass."""
    from os1_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer(sync=True)
    sys_, _, ok, _, _ = drive(frames, mapping=True, timer=timer)
    log("[stages] stage table (synchronised stages, second pass):\n" + timer.report())
    traj = sys_.frame_trajectory()
    states = "".join("O" if s else "." for s in ok)
    same_states = states == first["states"]
    return dict(stages={k: [timer.totals[k], timer.counts[k]] for k in timer.totals},
                states=states, same_states=same_states, traj=traj)


def phase_extractor_agreement(frames):
    """The card's extractor against the same code on the CPU, frame 0."""
    import torch

    from os1_tpu_torch.features.orb import OrbConfig, make_extractor

    cfg = OrbConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS)
    img = torch.as_tensor(frames[0])
    fg = make_extractor(cfg, "cuda")(img.cuda())
    fc = make_extractor(cfg, "cpu")(img)
    same_xy = float((fg.xy.cpu() == fc.xy).all(1).float().mean())
    same_desc = float((fg.desc.cpu() == fc.desc).all(1).float().mean())
    log(f"[extract] card vs CPU on frame 0: identical keypoints {same_xy:.4f}, "
        f"identical descriptors {same_desc:.4f}")
    if same_xy != 1.0 or same_desc != 1.0:
        raise RuntimeError("the card's extractor disagrees with the CPU's")
    return dict(same_xy=same_xy, same_desc=same_desc)


def render(n_frames):
    from os1_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    scene = synthetic.default_scene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, advance=0.05)
    frames = synthetic.render_sequence(scene, poses, BENCH_K, H, W)
    log(f"[render] {n_frames} frames {H}x{W} in {time.perf_counter() - t0:.3f}s")
    return frames, poses


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="write every number of the run to this file")
    args = parser.parse_args()

    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    out = dict(device=name, nvidia_smi=smi)
    out["build_s"] = phase_build()
    out["hamming"] = phase_kernel()
    out["patches"] = phase_patches()

    frames, poses = render(N_FRAMES)
    out["slice"] = phase_slice(frames, poses)
    out["extractor_agreement"] = phase_extractor_agreement(frames)

    frames, poses = render(N_FRAMES_MAP)
    out["mapping"], traj1 = phase_mapping(frames, poses)
    second = phase_stages(frames, out["mapping"])
    out["stages"] = second["stages"]
    same_traj = len(traj1) == len(second["traj"]) and all(
        a[1] == b[1] and np.array_equal(a[2], b[2]) for a, b in zip(traj1, second["traj"]))
    out["rerun_identical"] = dict(states=second["same_states"], poses_bitwise=same_traj)
    log(f"[stages] second pass vs first: same states {second['same_states']}, "
        f"bit-identical poses {same_traj}")
    out["seconds"] = time.perf_counter() - t_start

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)

    launches = out["mapping"]["launches"]
    big = next(r for r in out["hamming"] if r["shape"] == [4096, 1024])
    p1 = next(r for r in out["patches"]["p1"] if r["n"] == 1024)
    p2 = next(r for r in out["patches"]["p2"] if r["n"] == 1024)

    def entry(name, source, replaces, row, rows):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])

    kernels = [
        entry("hamming_matrix_cuda", "os1_tpu_torch/csrc/hamming.cu",
              "os1_tpu/ops/pallas_hamming.py:37", big, out["hamming"]),
        entry("extract_patches_cuda", "os1_tpu_torch/csrc/patches.cu", "profile_patch.py:94",
              p1, out["patches"]["p1"]),
        entry("sample_patches_cuda", "os1_tpu_torch/csrc/patches.cu", "profile_patch.py:177",
              p2, out["patches"]["p2"]),
    ]
    log(f"[done] {out['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
