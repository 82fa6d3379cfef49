"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (os1_tpu_torch, never JAX) at the bench
configuration (640x480, 1024 features, 8 levels, MapConfig(128, 16384)) and
fails (non-zero exit, no final result line) if any phase fails:

  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every csrc/*.cu for sm_90a from this checkout, one nvcc
     per source, and the host libraries (csrc/*.cpp) with g++, all started
     together;
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes and ragged ones, exactly, with the
     device time of both (CUDA-graph replay, CUDA events), the time of the
     one PyTorch call that computes the same function where there is one,
     the eager per-call time and the bound: K1's two epilogues, the Hamming
     table ([hamming]) and the fused gated best/second-best match ([match],
     in each of the four gate forms the matchers use); P1 the keypoint patch
     gather and P2 the BRIEF sample gather of the extractor ([patches]);
  4. slice: the 100-frame orbit tracked with mapping off, gated on
     initialization, every frame OK through frame 35, ATE and kernel
     launches (without a mapper the map stops growing and the run is lost
     once the camera leaves it);
  5. mapping: the bench's 300-frame orbit tracked with synchronous local
     mapping, gated on initialization by frame 10, every frame OK from the
     first OK one to the end, ATE <= 0.2 and launches of every kernel on this
     path; it also prints whether the run equals the one recorded on the card
     (RECORDED_RUN), which another host's float libraries may not reproduce;
  6. the card's extractor against the same code on the CPU;
  7. bow: the default vocabulary loaded through the port, and the host C++
     descent against the plain torch descent, exactly, on the descriptors of
     an orbit frame;
  8. coop, the shipped mode: System(cfg, pipelined=True, coop_mapping=True,
     enable_loop_closing=False) over the 300-frame orbit, twice on fresh
     systems (the second with synchronised stage timers for the stage table),
     gated on initialization by frame 10, OK on every frame from the first OK
     one, ATE <= 0.2, every keyframe materialized and the scheduler idle after
     flush, the two trajectories bit-identical, and launches of every kernel
     on the path;
  9. reloc, on the second coop system: 5 black frames must leave it LOST;
     the orbit replayed from frame 150 must relocalize within 10 frames, at
     the pose the pass recorded for that frame (0.05 rad, 0.2 units), with
     the fused match launched on the LOST frames and the table kernel never;
 10. loop, the shipped mode with loop closing on, System(cfg, pipelined=True,
     coop_mapping=True), over bench.py's loop sequence (room_scene(seed=3),
     loop_trajectory(300)), twice on fresh systems (the second with
     synchronised stage timers: loop detection, the Sim3 candidates, the
     correction, the essential graph, the global BA's chunks), gated as
     bench.py gates it: ATE <= 0.22 and at least one loop closed; the two
     trajectories bit-identical, the fused match launched during the Sim3
     evaluations, and launches of every kernel on the path. It prints each
     pass's Sim3 scale-guard readings (Horn's and the LM's scale of every
     candidate with 20 LM inliers, the verdicts with and without the guard)
     and the first pass's loop stages on the host clock. Then one global BA
     chunk on the final map, timed, with its peak device memory;
 11. mesh, the distributed back end on one card (8 shards on cuda:0 standing
     for the reference's 8-device mesh): (a) bench.py's loop sequence in the
     shipped mode with loop closing on over the mesh, System(cfg,
     pipelined=True, coop_mapping=True, distributed=True, mesh=...), one pass,
     gated as [loop] (ATE <= 0.22, a loop closed, every keyframe materialized
     and the scheduler idle after flush, launches of every kernel on the path)
     and on local BAs, global BA chunks and essential graphs routed through
     the mesh (counted), printed beside [loop]'s first pass; (b) the [loop]
     map's global BA single-device, over the 1-D mesh and over
     two_level_backend(2) (after the first 5-iteration chunk, poses within
     5e-4 and points within 5e-3 of single-device; after 20 iterations, the
     cost within 1e-4 of itself and 99.9% of the inlier flags equal), and the pass's first essential graph single-device and
     over the edge mesh (within 2e-3), each mesh solve rerun bit-identical,
     with device ms per chunk by CUDA events and the bytes each reduction
     sums; (c) DistKeyFrameDatabase over 8 shards loaded with the [loop]
     system's keyframe bows, every live keyframe queried: the ids equal to
     the host database's on the same bows cut to W_CAP words (up to
     near-ties), the scores within 1e-5, ms a query beside the host's;
 12. orbit with loop closing on: bench.py's own configuration (the shipped
     mode, loop closing on) over the 300-frame orbit, one pass, gated on ATE
     <= 0.2 and OK on every frame from the first OK one; a loop closed there
     is reported, not gated;
 13. osmap, Osmap persistence on the [loop] first pass's map (A) and the
     [orbit-loop] system's (O): A saved with options 0, FEATURES_FILE_DELIMITED
     and ONLY_MAPPOINTS_FEATURES and O with 0 (header counts = live counts,
     nothing pending; bytes and ms printed); A reloaded into a bare MapStore,
     exactly on the live slots (less the points with no observation, which
     the load's rebuild culls), in both layouts; A loaded into a fresh shipped
     system, LOST, then loop frames 150-209 replayed: OK within 10 frames, at
     the [loop] pass's pose (0.05 rad, 0.2 units), OK on 90% of the frames
     after, fused-match launches on the LOST frames; session B (a fresh shipped
     system over loop frames 180-299) saved and merged into a fresh load of A:
     aligned, more keyframes, finite, the joint keyframe ATE under 5% of the
     path, fused-match launches in the Sim3 evaluations; O merged into a fresh
     load of A: rolled back, the counts unchanged;
 14. threaded, run_slam's default mode (the reference's thread topology):
     System(cfg, pipelined=True, async_mapping=True), loop closing on, one
     pass over the bench orbit (after [orbit-loop]; init by frame 10, OK on
     85% of the frames from the first OK one, ATE <= 0.2) and one over the
     loop sequence (after [loop]; ATE <= 0.22, a loop closed, corrected on
     the LoopClosing thread, a global-BA thread spawned and joined, no frame
     lost in the 10 frames after the correction); both
     gated on every keyframe materialized and nothing pending after flush, no
     exception caught by a worker thread and launches of every kernel of the
     path. It prints frames/s, p50/p99, host reads and launches a frame by
     thread, the map-lock wait by thread and the worker queue depths, beside
     the shipped mode's frames/s over the same frames ([orbit-loop], [loop]'s
     first pass), and the host ms a call of the stages that update the
     points' derived state (the distinctive descriptor in host C++). The
     trajectory is not deterministic and not gated;
 15. photo, bench.py's third sequence (bench.py:95-113, gated at :148-155):
     the photo room (io/realimg.photo_room_scene(), walls textured with the
     packaged photographs) along loop_trajectory(300) in the shipped mode
     with loop closing on, one pass, gated as bench.py gates it: ATE <= 0.25
     Sim3-aligned, OK on 70% of the frames from the first OK one, a loop
     closed; also launches of every kernel on the path and the scheduler
     idle after flush. It prints frames/s, p50/p99, the loss events and the
     launches a frame;
 16. vocab, vocabulary training on the card (vocab/train.py): (a)
     training_descriptors() (40 textures at 240x320, 4 levels) on the card
     against the CPU extractor, the valid descriptors exactly; (b)
     build_vocabulary(k=10, L=4) on them on the card (each assignment one K1
     launch) and on the CPU (the plain assignment), identical in every array,
     and K1's assignment against the plain one at the trainer's shapes
     ([20480, 10], [1000000, 10], [1000, 7]), exactly, timed; (c) whether its
     binary equals the committed os1_tpu/data/default_vocab.bin (reported,
     not gated); (d) training_corpus(120) at 480x640 with 1024 features
     through the host C++ trainer (k=10, L=5): images/s, training seconds,
     nodes and words, the kernel launches, a bow.compute at that size;
 17. cli: ``python3 -m os1_tpu_torch.run_slam --synthetic --frames 120
     --save-trajectory T --save-map M`` as a subprocess (the threaded
     default): 120 frames, final state OK, 90% tracked, the ATE reported, the
     files written; then ``--load-map M --localization --frames 30``: it
     relocalizes and tracks, and the map's counts do not change; beside
     them ``--warmup``, which exits 0 with the four libraries built and
     ``System.warmup()`` run;
 18. warmup (run after [loop]): System.warmup() timed on a fresh shipped
     system with loop closing on, in a process of its own
     (``--warmup-pass``), K1, P1 and P2 launched inside it; then bench.py's
     loop sequence tracked once on that system, gated as [loop] (ATE <=
     0.22, a loop closed, launches of every kernel of the path); its first
     correction's loop.correct and loop.essential host ms beside [loop]'s
     first and second pass, and whether the first-correction gap closed
     (reported, not gated).

Every mapped path prints its local BA's LM iterations and bench.py's
local-BA iterations/s.

Every tracking path runs the fused match kernel (every matcher, one launch a
call; relocalization's five candidates are one 5-lane launch, checked in
[match] too), P1 and P2: those are the kernels each path's launch gate
requires. The table kernel (hamming_matrix_cuda) is launched on no path once
every matcher is fused; it stays checked in [hamming] and listed with 0
launches. [match] also checks loop closing's two forms (the bound-feature
match and the guided projection). The kernels line gives, as ``launches``, the launches of this slice's
paths, [photo] and [vocab] (the trainer's assignments are K1's fused match;
the corpus runs P1 and P2), and by path (``launches_by_path``) those and the
[threaded] loop pass's (run_slam's default mode); each wrapper counts its
launches by thread too, and all threads launch on the device's default
stream. The sequences are rendered in worker processes while the kernel
phases run (``Renderer``).

The last line is {"ok": true, "device": {...}}; the line before it gives the
card's name and power limit, and the one before that lists the kernels.
``--json PATH`` also writes every number of the run to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
GATE_OK_FRACTION = 1.0  # OK frames from the first OK one (bench.py counts them after flush)
N_BLACK = 5  # black frames that must leave the coop system LOST
RELOC_FROM = 150  # the orbit frame the replay starts from
GATE_RELOC_WITHIN = 10  # replayed frames to relocalize in
GATE_RELOC_RAD, GATE_RELOC_T = 0.05, 0.2  # the JAX relocalization test's pose bounds
JAX_CPU_LOST_AT = 42  # where the JAX package, mapping off, lost this sequence
N_FRAMES_LOOP = 300  # bench.py's loop sequence (bench.py:26, :80-91)
GATE_ATE_LOOP = 0.22  # bench.py GATE_ATE_LOOP
GATE_MIN_LOOPS = 1  # bench.py GATE_MIN_LOOPS
# The shipped mode's orbit ATE with loop closing off, as recorded on an NVIDIA H100
# 80GB HBM3 at 700 W.
ORBIT_ATE_LOOP_OFF = 0.195493
# [osmap]: the loop frames replayed after a load, session B's span and the merge gate.
OSMAP_RESUME = (150, 210)
OSMAP_B_SPANS = ((180, 300), (180, 260), (180, 230))  # session B, shortened if A + B overflow
GATE_RESUME_OK_AFTER = 0.9  # OK share of the replayed frames after the first OK one
GATE_MERGE_ATE = 0.05  # of the path length (tests/test_merge.py:56-64)
GATE_OK_THREADED = 0.85  # the threaded mode's bound (tests/test_async_pipeline.py:157)
CLI_FRAMES, CLI_LOC_FRAMES = 120, 30  # [cli]: the synthetic run, the localization run
GATE_CLI_TRACKED = 0.9
# [photo]: bench.py's photo-room gates (bench.py:148-155).
N_FRAMES_PHOTO = 300
GATE_ATE_PHOTO = 0.25
GATE_OK_PHOTO = 0.70
GATE_MIN_LOOPS_PHOTO = 1
# [vocab]: the default vocabulary's training (vocab/dbow2.py), the corpus of
# the reference-scale trainer cut to VOCAB_CORPUS_IMAGES images, and K1's
# assignment checked at the trainer's shapes (descriptors, centres).
VOCAB_DEFAULT = dict(branching=10, depth=4)
VOCAB_CORPUS_IMAGES, VOCAB_CORPUS_FEATURES = 120, 1024
VOCAB_NATIVE = dict(branching=10, depth=5)
ASSIGN_SHAPES = ((20480, 10), (1_000_000, 10), (1000, 7))
MESH_SHARDS = 8  # the reference's 8-device mesh (tests/conftest.py), as shards on one card
MESH_TWO_LEVEL = 2  # two_level_backend's hosts in [mesh]
GATE_MESH_POSE = 5e-4  # mesh vs single-device BA (tests/test_parallel.py:80-83)
GATE_MESH_POINTS = 5e-3
# The global BA's poses and points are held to the two tolerances above after
# its first chunk; after all its iterations, to the cost and the inlier flags.
# Late in the solve an LM step changes the cost by about 1e-7 of itself, so
# the order of a sum can flip an accept, and a two-view point whose depth
# along its ray is nearly free then moves by up to 1.0 while the cost agrees
# to 1e-6 (the [loop] map on the H100: 1 of 4,483 points over 5e-3).
GATE_MESH_COST = 1e-4  # relative, the final robust cost
GATE_MESH_INLIERS = 0.999
GATE_MESH_GRAPH = 2e-3  # mesh vs single-device essential graph (tests/test_parallel.py:169-171)
GATE_DB_SCORE = 1e-5
HAMMING_SHAPES = ((1024, 1024), (4096, 1024), (1000, 777))
# Fused match problems (batch, N, M, A shared, dense gate): the motion and
# local-map searches, a ragged one, the smallest, K9's fusion lanes and K8's
# neighbours (one new keyframe against 10, epipolar gate passed dense).
MATCH_SHAPES = ((1, 1024, 1024, False, False), (1, 4096, 1024, False, False),
                (1, 1000, 777, False, False), (1, 1, 1, False, False),
                (20, 1024, 1024, False, False), (10, 1024, 1024, True, True))
# Both paths as recorded on an NVIDIA H100 80GB HBM3 at 700 W with the
# table-then-torch matcher; the fused match kernel must reproduce them.
RECORDED_RUN = dict(init_frame=3, n_ok=297, ate=0.044866, keyframes=21, keyframes_culled=30,
                    points=1952)
RECORDED_SLICE = dict(lost_at=44, ate=0.072745)
PATCH_COUNTS = (1024, 1000)  # keypoints: the main path's, and a ragged count
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet, 700 W)
# H100 SXM dense int8 tensor-core rate (data sheet, 700 W). K1's distance core
# runs .b1 MMAs, for which NVIDIA publishes no H100 rate; this one stands in.
INT8_OPS_PER_S = 1979e12


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
    """Build every library from csrc/, the compilers run side by side: the
    CUDA kernels with nvcc, the host BoW library and the host helpers with
    g++."""
    from os1_tpu_torch.ops.cuda_build import load_libraries

    t0 = time.perf_counter()
    built = load_libraries(cuda=True)
    dt = time.perf_counter() - t0
    for source, seconds in built.items():
        target = "the host" if source.endswith(".cpp") else "sm_90a"
        done = f"{seconds:.3f}s" if seconds is not None else "already built in _build/"
        log(f"[build] os1_tpu_torch/csrc/{source} for {target}: {done}")
    log(f"[build] all kernels loaded in {dt:.3f}s")
    return dt


def _bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _bound(nbytes: float, int8_ops: float) -> dict:
    """The larger of the bytes bound and the int8 tensor-core bound."""
    by_bytes, by_ops = _bound_ms(nbytes), int8_ops / INT8_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops
                else "operations", bytes_bound_ms=by_bytes, ops_bound_ms=by_ops)


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


def _fmt_k1(row) -> str:
    return (f"{_fmt(row)}; bound by bytes {row['bytes_bound_ms']:.5f} ms, by int8 ops "
            f"{row['ops_bound_ms']:.5f} ms")


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def phase_kernel():
    """K1's table epilogue against the plain table, exactly."""
    import torch

    from os1_tpu_torch.ops.hamming import hamming_matrix
    from os1_tpu_torch.ops.pallas_hamming import hamming_matrix_cuda

    rng = np.random.default_rng(0)
    rows = []
    for n, m in HAMMING_SHAPES:
        a = torch.from_numpy(_words(rng, (n, 8)).view(np.int32)).cuda()
        b = torch.from_numpy(_words(rng, (m, 8)).view(np.int32)).cuda()
        if not (bool((a < 0).any()) and bool((b < 0).any())):
            raise RuntimeError("the random words do not exercise bit 31")
        ref = hamming_matrix(a, b)
        before = hamming_matrix_cuda.launches
        out = hamming_matrix_cuda(a, b)
        torch.cuda.synchronize()
        if hamming_matrix_cuda.launches != before + 1:
            raise RuntimeError("hamming_matrix_cuda did not count its launch")
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        if out.shape != (n, m) or err != 0:
            raise RuntimeError(f"table kernel disagrees with the plain version at [{n}, {m}]: "
                               f"max abs err {err}")
        # No single PyTorch call computes a popcount Hamming table.
        row = dict(shape=[n, m], max_abs_err=err,
                   **_timings(lambda: hamming_matrix_cuda(a, b), lambda: hamming_matrix(a, b)))
        # Bytes: both descriptor sets read once, the int32 table written once;
        # operations: 2 * N * M * 256 as int8 multiply-adds.
        row.update(_bound((n + m) * 32 + n * m * 4, 2 * n * m * 256))
        row["table_gbps"] = n * m * 4 / (row["ms"] * 1e-3) / 1e9
        log(f"[hamming] [{n}, {m}]: exact (max abs err {err}); {_fmt_k1(row)}; "
            f"table write {row['table_gbps']:.1f} GB/s")
        rows.append(row)
    return rows


def _match_problem(rng, nb, n, m, shared_a):
    """numpy inputs of ``nb`` projection matches: features on the 640x480
    pixel grid with octaves 0-7; points projected near a source feature with
    a radius of 4-15 px and an octave within one of it, some exactly on the
    window's edge, some one ulp outside, two far away (every column gated
    out); every third column a duplicate of its neighbour, at the same place
    (distance ties inside the window); bit 31 set."""
    b = _words(rng, (nb, m, 8))
    b[:, 1::3] = b[:, 0::3][:, :len(range(1, m, 3))]
    src = rng.integers(0, m, (nb, n))
    xy = np.stack([rng.integers(0, W, (nb, m)), rng.integers(0, H, (nb, m))], -1).astype(
        np.float32)
    octave_b = rng.integers(0, N_LEVELS, (nb, m)).astype(np.int32)
    for x in (xy, octave_b):  # each duplicate at its twin's place: ties inside the window
        x[:, 1::3] = x[:, 0::3][:, :len(range(1, m, 3))]
    flips = (rng.random((nb, n, 8)) < 0.1).astype(np.uint32) << _words(rng, (nb, n, 8)) % 32
    a = np.take_along_axis(b, src[..., None], 1) ^ flips
    a[..., 0] |= np.uint32(1 << 31)
    xy_src = np.take_along_axis(xy, src[..., None], 1)
    radius = rng.integers(4, 16, (nb, n)).astype(np.float32)
    uv = (xy_src + rng.normal(0, 3, (nb, n, 2))).astype(np.float32)
    k = n // 8
    uv[:, :k, 0] = xy_src[:, :k, 0] + radius[:, :k]
    uv[:, k:2 * k, 1] = np.nextafter(xy_src[:, k:2 * k, 1] - radius[:, k:2 * k],
                                     np.float32(-1e9))
    uv[:, 2 * k:2 * k + 2] = -1000.0
    octave_a = np.clip(np.take_along_axis(octave_b, src, 1) + rng.integers(-1, 2, (nb, n)), 0,
                       N_LEVELS - 1).astype(np.int32)
    return dict(a=a[:1] if shared_a else a, b=b, uv=uv, radius=radius, xy=xy, octave_a=octave_a,
                octave_b=octave_b, valid_a=rng.random((nb, n)) < 0.9,
                valid_b=rng.random((nb, m)) < 0.9)


def phase_match():
    """K1's fused epilogue (gated best/second-best and ratio test) against its
    plain version, exactly, in each gate form a matcher gives it: window and
    octave band (the projection and fusion searches), dense (triangulation),
    window alone with octave 0 folded into the masks (initialization) and
    the masks alone (the reference keyframe), each at its caller's
    thresholds."""
    import torch

    from os1_tpu_torch.ops import pallas_hamming as ph

    rng = np.random.default_rng(2)
    max_dist, ratio = 100, 0.8  # the local-map search's thresholds
    rows = []
    for nb, n, m, shared_a, dense in MATCH_SHAPES:
        p = _match_problem(rng, nb, n, m, shared_a)
        t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v).cuda()
             for k, v in p.items()}
        a, b = t.pop("a"), t.pop("b")
        gate = (ph.window_gate(t["uv"], t["xy"], t["radius"], t["valid_a"], t["valid_b"])
                & ph.octave_gate(t["octave_a"], t["octave_b"]))
        window = {k: t[k] for k in ("uv", "radius", "xy")}
        forms = dict(
            factored=(max_dist, ratio, t), dense=(max_dist, ratio, dict(gate=gate)),
            window=(50, 0.9, dict(valid_a=t["valid_a"] & (t["octave_a"] == 0),
                                  valid_b=t["valid_b"] & (t["octave_b"] == 0), **window)),
            masks=(50, 0.7, dict(valid_a=t["valid_a"], valid_b=t["valid_b"])))
        err = 0
        for form, (md, rt, kw) in forms.items():
            err = max(err, _launch_and_check(a, b, md, rt, kw,
                                             f"{form} gate at B={nb} [{n}, {m}]"))
        kw = forms["dense" if dense else "factored"][2]
        ref = ph.gated_match(a, b, max_dist, ratio, **kw)
        row = dict(batch=nb, shape=[n, m], shared_a=shared_a,
                   gate="dense" if dense else "factored", max_abs_err=err,
                   n_ok=int(ref.ok.sum()), n_gated_out=int((ref.dist == ph.BIG).sum()),
                   n_ties=int((ref.second == ref.dist).sum()),
                   **_timings(lambda: ph.gated_match_cuda(a, b, max_dist, ratio, **kw),
                              lambda: ph.gated_match(a, b, max_dist, ratio, **kw)))
        # Bytes: descriptors, the gate (dense: a byte a pair; factored: 17
        # bytes a row, 13 a column) and 17 bytes of outputs a row;
        # operations: 2 * B * N * M * 256 as int8 multiply-adds.
        gate_bytes = nb * n * m if dense else nb * (17 * n + 13 * m)
        row.update(_bound((a.shape[0] * n + nb * m) * 32 + gate_bytes + nb * n * 17,
                          2 * nb * n * m * 256))
        log(f"[match] B={nb} [{n}, {m}]{' shared A' if shared_a else ''}, {row['gate']} gate: "
            f"exact (max abs err {err}, all four gate forms; {row['n_ok']} ok, "
            f"{row['n_gated_out']} gated-out rows, {row['n_ties']} ties with the best); "
            f"{_fmt_k1(row)}")
        rows.append(row)
    rows.append(_reloc_match(rng))
    rows.extend(_loop_match(rng))
    return rows


def _launch_and_check(a, b, max_dist, ratio, kw, what):
    """One counted launch of the fused match against its plain version:
    the max abs error (0), or raise."""
    import torch

    from os1_tpu_torch.ops import pallas_hamming as ph

    ref = ph.gated_match(a, b, max_dist, ratio, **kw)
    before = ph.gated_match_cuda.launches
    got = ph.gated_match_cuda(a, b, max_dist, ratio, **kw)
    torch.cuda.synchronize()
    if ph.gated_match_cuda.launches != before + 1:
        raise RuntimeError("gated_match_cuda did not count its launch")
    err = 0
    for f, x, y in zip(ph.Top2._fields, got, ref):
        e = int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
        err = max(err, e)
        if x.dtype != y.dtype or x.shape != y.shape or e != 0:
            raise RuntimeError(f"fused kernel ({what}) disagrees with the plain version in {f}: "
                               f"max abs err {e}")
    return err


def _loop_match(rng):
    """Loop closing's two forms, at their shapes and thresholds: the
    bound-feature match of a Sim3 candidate (B=1 [1024, 1024], the masks
    gate, max_dist 50, ratio 0.75) and its guided projection (B=1
    [4096, 1024] loop-region points, an 8-pixel window, octave band -8..8
    around octave 0, max_dist 50, ratio 1.0)."""
    import torch

    from os1_tpu_torch.ops import pallas_hamming as ph

    rows = []
    p = _match_problem(rng, 1, 1024, 1024, shared_a=False)
    a, b = (torch.from_numpy(p[k].view(np.int32)).cuda() for k in ("a", "b"))
    kw = {k: torch.from_numpy(p[k]).cuda() for k in ("valid_a", "valid_b")}
    forms = [("bound-feature match", "masks", 50, 0.75, a, b, kw,
              lambda n, m: (n + m) * 32 + (n + m) + n * 17)]
    p = _match_problem(rng, 1, 4096, 1024, shared_a=False)
    a2, b2 = (torch.from_numpy(p[k].view(np.int32)).cuda() for k in ("a", "b"))
    kw2 = {k: torch.from_numpy(p[k]).cuda() for k in ("uv", "xy", "valid_a", "valid_b",
                                                       "octave_b")}
    kw2.update(radius=torch.full((1, 4096), 8.0, device="cuda"),
               octave_a=torch.zeros((1, 4096), dtype=torch.int32, device="cuda"), lo=-8, hi=8)
    forms.append(("guided projection", "factored", 50, 1.0, a2, b2, kw2,
                  lambda n, m: (n + m) * 32 + 17 * n + 13 * m + n * 17))
    for what, gate, md, rt, a, b, kw, nbytes in forms:
        ref = ph.gated_match(a, b, md, rt, **kw)
        err = _launch_and_check(a, b, md, rt, kw, f"loop closing's {what}")
        n, m = a.shape[1], b.shape[1]
        row = dict(batch=1, shape=[n, m], shared_a=False, gate=gate, form=f"loop: {what}",
                   max_abs_err=err, n_ok=int(ref.ok.sum()),
                   n_gated_out=int((ref.dist == ph.BIG).sum()),
                   n_ties=int((ref.second == ref.dist).sum()),
                   **_timings(lambda: ph.gated_match_cuda(a, b, md, rt, **kw),
                              lambda: ph.gated_match(a, b, md, rt, **kw)))
        row.update(_bound(nbytes(n, m), 2 * n * m * 256))
        log(f"[match] loop closing's {what} B=1 [{n}, {m}], {gate} gate, max_dist {md}, "
            f"ratio {rt}: exact (max abs err {err}; {row['n_ok']} ok, {row['n_gated_out']} "
            f"gated-out rows, {row['n_ties']} ties with the best); {_fmt_k1(row)}")
        rows.append(row)
    return rows


def _reloc_match(rng):
    """Relocalization's form: 5 candidate lanes, the frame's 1024 descriptors
    shared by all, the masks-only gate, max_dist 50, ratio 0.75."""
    import torch

    from os1_tpu_torch.ops import pallas_hamming as ph

    nb, n, m = 5, 1024, 1024
    p = _match_problem(rng, nb, n, m, shared_a=True)
    a, b = (torch.from_numpy(p[k].view(np.int32)).cuda() for k in ("a", "b"))
    kw = {k: torch.from_numpy(p[k]).cuda() for k in ("valid_a", "valid_b")}
    ref = ph.gated_match(a, b, 50, 0.75, **kw)
    err = _launch_and_check(a, b, 50, 0.75, kw, "relocalization's form")
    row = dict(batch=nb, shape=[n, m], shared_a=True, gate="masks", form="reloc",
               max_abs_err=err, n_ok=int(ref.ok.sum()), n_gated_out=int((ref.dist == ph.BIG).sum()),
               n_ties=int((ref.second == ref.dist).sum()),
               **_timings(lambda: ph.gated_match_cuda(a, b, 50, 0.75, **kw),
                          lambda: ph.gated_match(a, b, 50, 0.75, **kw)))
    # Bytes: the shared A and the 5 B's descriptors, a mask byte a row and a
    # column, 17 bytes of outputs a row; operations: 2 * B * N * M * 256.
    row.update(_bound((n + nb * m) * 32 + nb * (n + m) + nb * n * 17, 2 * nb * n * m * 256))
    log(f"[match] relocalization's form B={nb} [{n}, {m}] shared A, masks gate, max_dist 50, "
        f"ratio 0.75: exact (max abs err {err}; {row['n_ok']} ok, {row['n_gated_out']} gated-out "
        f"rows, {row['n_ties']} ties with the best); {_fmt_k1(row)}")
    return row


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


def build_system(device, mapping: bool, shipped: bool = False, loop: bool = False,
                 threaded: bool = False, mesh=None):
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
    if threaded:  # run_slam's default: the reference's thread topology
        return System(cfg, pipelined=True, async_mapping=True, enable_loop_closing=loop,
                      device=device)
    if shipped:
        dist = dict(distributed=True, mesh=mesh) if mesh is not None else {}
        return System(cfg, pipelined=True, coop_mapping=True, enable_loop_closing=loop,
                      device=device, **dist)
    return System(cfg, enable_mapping=mapping, enable_loop_closing=False, pipelined=False,
                  device=device)


# The local BA's stages whose host time bench.py's iterations/s divides by.
BA_STAGES = ("lm.ba.assemble", "lm.ba.dispatch", "lm.ba.fetch", "lm.local_ba")
# The mapping stages that call MapStore.update_point_derived (the host
# helper's distinctive descriptor), printed by [threaded].
DERIVED_STAGES = ("lm.materialize", "lm.tri.apply", "lm.fuse.apply")
GATE_AFTER_CORRECTION = 10  # [threaded] loop: no LOST frame this many frames after a correction

# The kernels both tracking paths launch; hamming_matrix_cuda is counted but
# no longer on them.
PATH_KERNELS = ("gated_match_cuda", "extract_patches_cuda", "sample_patches_cuda")


def _counters():
    from os1_tpu_torch.ops import patches
    from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda, hamming_matrix_cuda

    return {"gated_match_cuda": gated_match_cuda, "hamming_matrix_cuda": hamming_matrix_cuda,
            "extract_patches_cuda": patches.extract_patches_cuda,
            "sample_patches_cuda": patches.sample_patches_cuda}


def _reset_counts(counters):
    from os1_tpu_torch.ops.cuda_build import reset_launches

    for c in counters.values():
        reset_launches(c)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(frames, mapping: bool, device="cuda", timer=None, shipped: bool = False,
          loop: bool = False, on_build=None, threaded: bool = False, mesh=None):
    """Track ``frames`` through System.track_monocular, with every kernel
    launch count set to 0 just before and read just after. Returns the
    system, per-frame latency, OK flags, host reads and launch counts.
    Synchronous paths synchronise the card after every frame; the shipped
    (pipelined) and threaded modes keep their frames in flight, their latency
    is the call's, and they end with flush() and one synchronise, timed as
    ``wall_s``. The system also keeps the launches by thread
    (``launches_by_thread``) and, threaded, the worker queue depths after
    each frame (``queue_depths``: mapping, loop)."""
    from os1_tpu_torch.pipeline import TrackingState

    pipelined = shipped or threaded
    sys_ = build_system(device, mapping, shipped, loop, threaded, mesh)
    if timer is not None:
        sys_.set_timer(timer)
    if on_build is not None:
        on_build(sys_)
    counters = _counters()
    _reset_counts(counters)
    sys_.lock.reset_stats()
    lat, states, reads, depths = [], [], [], []
    mw, lw = sys_.mapping_worker, sys_.loop_worker
    t_start = time.perf_counter()
    for i, img in enumerate(frames):
        r0 = sys_.reads.count
        t0 = time.perf_counter()
        state, _ = sys_.track_monocular(img, timestamp=i / 30.0)
        if not pipelined:
            _sync(device)
        lat.append(time.perf_counter() - t0)
        states.append(state == TrackingState.OK)
        reads.append(sys_.reads.count - r0)
        if mw is not None:
            depths.append((mw.queue_size(), lw.queue_size() if lw is not None else 0))
    if pipelined:
        sys_.flush()
        _sync(device)
    sys_.wall_s = time.perf_counter() - t_start
    launches = {k: c.launches for k, c in counters.items()}
    sys_.launches_by_thread = {k: dict(c.launches_by_thread) for k, c in counters.items()}
    sys_.queue_depths = np.array(depths).reshape(-1, 2)
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
    ba_wall = sum(sys_.timer.totals.get(k, 0.0) for k in BA_STAGES)
    return dict(
        ba_iters=sys_.mapper.ba_iters,
        ba_iters_per_s=sys_.mapper.ba_iters / ba_wall if ba_wall > 0 else 0.0,
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
    log(f"[{tag}] local BA: {res['ba_iters']} LM iterations, {res['ba_iters_per_s']:.1f} "
        f"iterations/s of local-BA stage time (bench.py's local-BA iterations/s)")
    log(f"[{tag}] init at frame {res['init_frame']} (gate <= {GATE_INIT_BY}); lost at "
        f"{res['lost_at']}; {res['n_ok']} OK frames; {res['keyframes']} keyframes live, "
        f"{res['keyframes_culled']} culled, {res['points']} points; ATE {res['ate']:.6f}")
    a, b = res["stretch"]
    if res["p50_ms"] is None:
        log(f"[{tag}] no frame tracked by the fused step")
    else:
        log(f"[{tag}] OK stretch frames {a}..{b}: {res['fps_ok']:.3f} frames/s, "
            f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
            f"host reads/frame {res['host_reads_per_frame']:.3f}")
    n = len(res["states"])
    per_frame = {k: round(v / n, 3) for k, v in res["launches"].items()}
    log(f"[{tag}] kernel launches on this path: {res['launches']} ({per_frame} a frame over "
        f"{n} frames); peak device memory {res['peak_mem_bytes']} bytes")


def _launch_gate(res, fails):
    for k in PATH_KERNELS:
        if res["launches"][k] <= 0:
            fails.append(f"{k} never launched on this path")


def _compare_recorded(tag, res, recorded):
    """Whether this run equals the recorded one (printed, not gated)."""
    same = {k: (round(res[k], 6) if k == "ate" else res[k]) == v for k, v in recorded.items()}
    res["equals_recorded"] = same
    log(f"[{tag}] equal to the run recorded on the H100: {all(same.values())} {same}")


def phase_slice(frames, poses):
    """The mapping-off path (tracking alone) with its gates."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    sys_, lat, ok, reads, launches = drive(frames, mapping=False)
    res, _ = summarize(sys_, lat, ok, reads, launches, poses)
    res["jax_cpu_lost_at"] = JAX_CPU_LOST_AT
    res["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    _log_path("slice", res)
    _compare_recorded("slice", res, RECORDED_SLICE)
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
    _compare_recorded("mapping", res, RECORDED_RUN)
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


def phase_bow(frames, device="cuda"):
    """The default vocabulary through the port, and the host descent against
    the plain torch descent on the card, on an orbit frame's descriptors."""
    import torch

    from os1_tpu_torch.features.orb import OrbConfig, make_extractor
    from os1_tpu_torch.vocab import dbow2, native, tree
    from os1_tpu_torch.vocab.database import KeyFrameDatabase

    vocab = dbow2.default_vocabulary()  # the one the systems use (cached)
    path = next(os.path.join(dbow2.DATA_DIR, f) for f in dbow2.DEFAULT_FILES
                if os.path.exists(os.path.join(dbow2.DATA_DIR, f)))
    t0 = time.perf_counter()
    dbow2.load_binary(path)  # a fresh load, timed
    load_s = time.perf_counter() - t0
    cfg = OrbConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS)
    feats = make_extractor(cfg, device)(torch.as_tensor(frames[0]).to(device))
    desc, valid = feats.desc.cpu().numpy(), feats.valid.cpu().numpy()
    word, weight = native.bow_transform(vocab, desc, valid)
    tw, twt = tree.transform(vocab, feats.desc, feats.valid)
    same_w = bool(np.array_equal(tw.cpu().numpy(), word))
    same_wt = bool(np.array_equal(twt.cpu().numpy(), weight))
    db = KeyFrameDatabase(vocab, MAP_KEYFRAMES)

    def median_ms(fn, reps=21):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts) * 1e3)

    descent_ms = median_ms(lambda: native.bow_transform(vocab, desc, valid))
    kf_ms = median_ms(lambda: db.compute_bow(desc, valid))
    res = dict(nodes=len(vocab.node_desc), words=vocab.n_words, branching=vocab.branching,
               depth=vocab.depth, load_s=load_s, n_desc=int(valid.sum()), same_words=same_w,
               same_weights=same_wt, descent_ms=descent_ms, compute_bow_ms=kf_ms)
    log(f"[bow] vocabulary {vocab.n_words} words, {res['nodes']} nodes (k={vocab.branching}, "
        f"L={vocab.depth}), {os.path.basename(path)} loaded in {load_s:.3f}s; host descent of {res['n_desc']} "
        f"descriptors equals the plain torch descent on the card: words {same_w}, weights "
        f"{same_wt}; host clock, median of 21: {descent_ms:.3f} ms a descent, {kf_ms:.3f} ms "
        f"a keyframe (descent + sparse vector)")
    if not (same_w and same_wt):
        raise RuntimeError("the host BoW descent disagrees with the plain torch descent")
    return res


def _traj_sha(traj) -> str:
    import hashlib

    poses = np.stack([T for _, _, T in traj]) if traj else np.zeros((0, 4, 4))
    return hashlib.sha256(np.ascontiguousarray(poses, np.float32).tobytes()).hexdigest()


def _peak_mem(device, reset=False):
    import torch

    if torch.device(device).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return int(torch.cuda.max_memory_allocated())


def phase_coop(frames, poses, device="cuda"):
    """The shipped mode over the bench orbit, twice on fresh systems; the
    second pass with synchronised stage timers. Returns the numbers and the
    second system for the relocalization phase."""
    from os1_tpu_torch.utils.profiling import StageTimer

    passes = []
    for k in range(2):
        timer = StageTimer(sync=True) if k == 1 else None
        _peak_mem(device, reset=True)
        sys_, lat, ok, reads, launches = drive(frames, mapping=True, device=device, timer=timer,
                                               shipped=True)
        res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
        res["peak_mem_bytes"] = _peak_mem(device)
        res["frames"] = len(frames)
        res["wall_fps"] = len(frames) / sys_.wall_s
        res["sha256"] = _traj_sha(traj)
        st = sys_.store
        live = np.nonzero(st.kf_valid)[0]
        res["all_materialized"] = bool(all(st.kf_feat_valid[i].any() for i in live))
        res["idle_after_flush"] = (not sys_._pending_frames and not sys_.coop.busy()
                                   and not sys_.tracker._pending)
        tag = f"coop pass {k + 1}"
        _log_path(tag, res)
        log(f"[{tag}] whole run incl. flush {sys_.wall_s:.3f}s = {res['wall_fps']:.3f} frames/s; "
            f"trajectory sha256 {res['sha256'][:16]}; all keyframes materialized "
            f"{res['all_materialized']}; idle after flush {res['idle_after_flush']}")
        first = res["init_frame"]
        fails = []
        if first > GATE_INIT_BY:
            fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
        if ok[first:].mean() < GATE_OK_FRACTION or not sys_.state.name == "OK":
            fails.append(f"OK on {ok[first:].mean():.4f} of the frames from {first}")
        if not res["finite"]:
            fails.append("non-finite or misshaped poses")
        if not res["ate"] <= GATE_ATE:
            fails.append(f"ATE {res['ate']} > {GATE_ATE}")
        if not (res["all_materialized"] and res["idle_after_flush"]):
            fails.append("keyframes left unmaterialized or the scheduler busy after flush")
        _launch_gate(res, fails)
        if fails:
            raise RuntimeError(f"{tag} failed: " + "; ".join(fails))
        passes.append((res, sys_, timer))
    (r1, _, _), (r2, sys2, timer) = passes
    log("[coop] stage table (synchronised stages, second pass):\n" + timer.report())
    same = r1["sha256"] == r2["sha256"] and r1["states"] == r2["states"]
    log(f"[coop] second pass vs first: same states {r1['states'] == r2['states']}, "
        f"bit-identical trajectory {r1['sha256'] == r2['sha256']}")
    if not same:
        raise RuntimeError("coop: the two passes differ")
    out = dict(first=r1, second=r2, rerun_identical=same,
               stages={k: [timer.totals[k], timer.counts[k]] for k in timer.totals})
    return out, sys2


def phase_reloc(sys_, frames):
    """Black frames until LOST, then the orbit replayed from RELOC_FROM."""
    from os1_tpu_torch.pipeline import TrackingState

    recorded = {fid: T for _, fid, T in sys_.frame_trajectory()}
    counters = _counters()
    _reset_counts(counters)
    t = len(frames)
    timer = sys_.timer
    per_frame = []  # (frame, state after, relocalization ms, fused launches, candidates)

    def feed(img, ts, tag):
        n0, s0 = timer.counts["trk.relocalize"], timer.totals["trk.relocalize"]
        g0 = counters["gated_match_cuda"].launches
        sys_.relocalizer.last_n_candidates = -1
        state, Tcw = sys_.track_monocular(img, timestamp=ts)
        attempt = timer.counts["trk.relocalize"] > n0
        per_frame.append(dict(frame=tag, state=state.name,
                              relocalize_ms=(timer.totals["trk.relocalize"] - s0) * 1e3
                              if attempt else None,
                              candidates=sys_.relocalizer.last_n_candidates if attempt else None,
                              fused_launches=counters["gated_match_cuda"].launches - g0))
        return state, Tcw

    black = np.zeros((H, W), np.float32)
    for j in range(N_BLACK):
        feed(black, (t + j) / 30.0, f"black {j}")
    lost = sys_.state == TrackingState.LOST
    log(f"[reloc] after {N_BLACK} black frames: {sys_.state.name}; loss log "
        f"{sys_.tracker.loss_log[-2:]}")
    if not lost:
        raise RuntimeError(f"reloc: not LOST after {N_BLACK} black frames")
    recovered, Tcw, i = None, None, 0
    for i in range(GATE_RELOC_WITHIN):
        state, Tcw = feed(frames[RELOC_FROM + i], (t + N_BLACK + i) / 30.0,
                          f"orbit {RELOC_FROM + i}")
        if state == TrackingState.OK:
            recovered = i
            break
    launches = {k: c.launches for k, c in counters.items()}
    attempts = [f for f in per_frame if f["relocalize_ms"] is not None]
    res = dict(lost=lost, recovered_after=recovered, launches=launches, per_frame=per_frame,
               matched_kf=sys_.relocalizer.last_reloc_kf)
    for f in per_frame:
        log(f"[reloc] {f['frame']}: {f['state']}; relocalization "
            + (f"{f['relocalize_ms']:.3f} ms (synchronised), {f['candidates']} candidates"
               if f["relocalize_ms"] is not None else "not attempted")
            + f"; {f['fused_launches']} fused-match launches")
    if recovered is None:
        raise RuntimeError(f"reloc: not OK within {GATE_RELOC_WITHIN} replayed frames")
    ref = recorded[RELOC_FROM + recovered]
    dR = Tcw[:3, :3] @ ref[:3, :3].T
    res["rot_err_rad"] = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    res["t_err"] = float(np.linalg.norm(Tcw[:3, 3] - ref[:3, 3]))
    log(f"[reloc] OK at replayed frame {recovered} (orbit frame {RELOC_FROM + recovered}), "
        f"matched keyframe {res['matched_kf']}; pose against the pass's record: "
        f"{res['rot_err_rad']:.6f} rad, {res['t_err']:.6f} units; {len(attempts)} "
        f"relocalization attempts; launches from the first black frame to the recovery "
        f"{launches}")
    fails = []
    if res["rot_err_rad"] >= GATE_RELOC_RAD or res["t_err"] >= GATE_RELOC_T:
        fails.append("relocalized pose too far from the recorded one")
    if launches["gated_match_cuda"] <= 0 or launches["hamming_matrix_cuda"] != 0:
        fails.append("the LOST frames did not run the fused match kernel alone")
    if fails:
        raise RuntimeError("reloc failed: " + "; ".join(fails))
    return res


LOOP_STAGES = ("loop.detect", "loop.sim3", "loop.correct", "loop.essential",
               "loop.gba.assemble", "loop.gba.chunk", "loop.gba.fetch", "loop.gba.apply")


def _count_sim3_launches(sys_, tally):
    """Wrap the loop closer's Sim3 dispatch to count the fused-match launches
    it makes (the candidate program's two matches) and the evaluations."""
    from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda

    lc = sys_.loop_closer
    dispatch = lc._dispatch_sim3

    def counted(snap):
        g0 = gated_match_cuda.launches
        out = dispatch(snap)
        tally["sim3_evals"] += 1
        tally["sim3_fused_launches"] += gated_match_cuda.launches - g0
        return out

    lc._dispatch_sim3 = counted


def _scale_guard(lc) -> dict:
    """The Sim3 scale guard's readings from the loop closer's log: per
    evaluated candidate, Horn's scale, the LM's, and the verdicts without and
    with the guard (``loop_closing.lm_scale_consistent``)."""
    rows = [dict(kf=r[0], cand=r[1], n_match=r[2], n_inliers=r[3], n_total=r[4], s_horn=r[5],
                 s_lm=r[6], ratio=r[6] / r[5], success_ref=r[7], success=r[8])
            for r in lc.sim3_log]

    def span(sel):
        ratios = [r["ratio"] for r in rows if sel(r)]
        return [min(ratios), max(ratios)] if ratios else None

    return dict(evaluated=len(rows), accepted_ref=sum(r["success_ref"] for r in rows),
                rejected_by_guard=sum(r["success_ref"] and not r["success"] for r in rows),
                ratio_all=span(lambda r: True), ratio_accepted=span(lambda r: r["success"]),
                ratio_20_inliers=span(lambda r: r["n_inliers"] >= 20),
                rows=rows)


def phase_loop(frames, poses, device="cuda"):
    """bench.py's loop sequence in the shipped mode with loop closing on, twice
    on fresh systems; the second pass with synchronised stage timers. Then one
    global BA chunk on the second system's final map, timed, with its peak
    device memory. Returns the numbers and the first pass's system."""
    from os1_tpu_torch.utils.profiling import StageTimer

    passes = []
    for k in range(2):
        timer = StageTimer(sync=True) if k == 1 else None
        tally = dict(sim3_evals=0, sim3_fused_launches=0)
        _peak_mem(device, reset=True)
        sys_, lat, ok, reads, launches = drive(
            frames, mapping=True, device=device, timer=timer, shipped=True, loop=True,
            on_build=lambda s, t=tally: _count_sim3_launches(s, t))
        res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
        lc = sys_.loop_closer
        first = res["init_frame"]
        res.update(tally, peak_mem_bytes=_peak_mem(device), frames=len(frames),
                   wall_fps=len(frames) / sys_.wall_s, sha256=_traj_sha(traj),
                   ok_fraction=float(ok[first:].mean()) if first < len(ok) else 0.0,
                   n_loops_closed=lc.n_loops_closed, loop_edges=[list(e) for e in lc.loop_edges],
                   scale_guard=_scale_guard(lc),
                   idle_after_flush=(not sys_._pending_frames and not sys_.coop.busy()
                                     and not sys_.tracker._pending))
        tag = f"loop pass {k + 1}"
        _log_path(tag, res)
        log(f"[{tag}] whole run incl. flush {sys_.wall_s:.3f}s = {res['wall_fps']:.3f} frames/s; "
            f"OK fraction {res['ok_fraction']:.4f} from frame {first}; loss events "
            f"{res['loss_log']}; loops closed {res['n_loops_closed']} (edges "
            f"{res['loop_edges']}); {res['sim3_evals']} Sim3 candidate evaluations with "
            f"{res['sim3_fused_launches']} fused-match launches; trajectory sha256 "
            f"{res['sha256'][:16]}; idle after flush {res['idle_after_flush']}")
        g = res["scale_guard"]
        log(f"[{tag}] Sim3 scale guard: {g['evaluated']} candidates evaluated, "
            f"{g['accepted_ref']} accepted by the reference's tests, {g['rejected_by_guard']} of "
            f"them rejected by the guard; LM/Horn scale ratio over all {g['ratio_all']}, over "
            f"those with >= 20 LM inliers {g['ratio_20_inliers']}, over the accepted "
            f"{g['ratio_accepted']}")
        for r in g["rows"]:
            if r["n_inliers"] >= 20 or r["success_ref"]:
                log(f"[{tag}]   kf {r['kf']} cand {r['cand']}: matches {r['n_match']}, LM inliers "
                    f"{r['n_inliers']}, projected {r['n_total']}, scale Horn {r['s_horn']:.6f} "
                    f"LM {r['s_lm']:.6f} (ratio {r['ratio']:.6f}), reference "
                    f"{r['success_ref']}, guarded {r['success']}")
        fails = []
        if not res["ate"] <= GATE_ATE_LOOP:
            fails.append(f"ATE {res['ate']} > {GATE_ATE_LOOP}")
        if res["n_loops_closed"] < GATE_MIN_LOOPS:
            fails.append(f"{res['n_loops_closed']} loops closed < {GATE_MIN_LOOPS}")
        if not res["finite"]:
            fails.append("non-finite or misshaped poses")
        if res["sim3_fused_launches"] <= 0:
            fails.append("no fused-match launch during the Sim3 evaluations")
        if not res["idle_after_flush"]:
            fails.append("the scheduler busy after flush")
        _launch_gate(res, fails)
        if fails:
            raise RuntimeError(f"{tag} failed: " + "; ".join(fails))
        passes.append((res, sys_, timer))
    (r1, sys1, _), (r2, sys2, timer) = passes
    host = sys1.timer
    stages_host = {k: dict(total_s=host.totals[k], calls=host.counts[k],
                           ms_per_call=host.totals[k] / host.counts[k] * 1e3)
                   for k in ("lm.ba.dispatch",) + LOOP_STAGES if host.counts.get(k)}
    log("[loop] loop stages, ms a call (host clock, not synchronised, first pass): " + "; ".join(
        f"{k} {v['ms_per_call']:.3f} ({v['calls']} calls)" for k, v in stages_host.items()))
    log("[loop] stage table (synchronised stages, second pass):\n" + timer.report())
    stages = {k: dict(total_s=timer.totals[k], calls=timer.counts[k],
                      ms_per_call=timer.totals[k] / timer.counts[k] * 1e3)
              for k in LOOP_STAGES if timer.counts.get(k)}
    log("[loop] loop stages, ms a call (synchronised): " + "; ".join(
        f"{k} {v['ms_per_call']:.3f} ({v['calls']} calls)" for k, v in stages.items()))
    same = r1["sha256"] == r2["sha256"] and r1["states"] == r2["states"]
    log(f"[loop] second pass vs first: same states {r1['states'] == r2['states']}, "
        f"bit-identical trajectory {r1['sha256'] == r2['sha256']}")
    if not same:
        raise RuntimeError("loop: the two passes differ")
    gba = _gba_chunk(sys2, device)
    return dict(first=r1, second=r2, rerun_identical=same, stages=stages,
                stages_host=stages_host, gba=gba,
                all_stages={k: [timer.totals[k], timer.counts[k]] for k in timer.totals}), sys1


def _warmup_pass(path, out_path, device="cuda"):
    """[warmup]'s pass in a process of its own (``--warmup-pass NPZ``): a
    fresh shipped system with loop closing on, ``System.warmup()`` timed,
    then the loop sequence in NPZ tracked once on it. Writes its numbers to
    ``out_path``."""
    with np.load(path) as z:
        frames, poses = z["frames"], list(z["poses"])
    warm = {}

    def on_build(s):
        _sync(device)
        t0 = time.perf_counter()
        warm["seconds"] = s.warmup()
        _sync(device)
        warm.update(wall_s=time.perf_counter() - t0, launches=s.warmup_launches)

    _peak_mem(device, reset=True)
    sys_, lat, ok, reads, launches = drive(frames, mapping=True, device=device, shipped=True,
                                           loop=True, on_build=on_build)
    res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
    tm, lc = sys_.timer, sys_.loop_closer
    res.update(warmup=warm, sha256=_traj_sha(traj), peak_mem_bytes=_peak_mem(device), n_loops_closed=lc.n_loops_closed,
               loop_edges=[list(e) for e in lc.loop_edges], wall_fps=len(frames) / sys_.wall_s,
               stages_host={k: dict(total_s=tm.totals[k], calls=tm.counts[k],
                                    ms_per_call=tm.totals[k] / tm.counts[k] * 1e3)
                            for k in ("lm.ba.dispatch",) + LOOP_STAGES if tm.counts.get(k)})
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def phase_warmup(frames, poses, loop_res):
    """System.warmup() on a fresh shipped system with loop closing on, in a
    process of its own (a fresh process pays every first use, as a user's
    does): its seconds and the kernel launches inside it (K1, P1 and P2
    gated), then bench.py's loop sequence tracked once on that system, gated
    as [loop] is (ATE <= 0.22, a loop closed, launches of every kernel of the
    path). Prints the first correction's loop.correct and loop.essential host
    ms beside [loop]'s first pass (this process's first correction) and
    second, and whether the first-correction gap closed (reported, not
    gated: the warmed correction within 25% of [loop]'s second)."""
    tmp = tempfile.mkdtemp(prefix="os1_warmup_")
    try:
        path, out_path = os.path.join(tmp, "loop.npz"), os.path.join(tmp, "warmup.json")
        np.savez(path, frames=frames, poses=np.stack(poses))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmup-pass", path,
                               "--json", out_path], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"warmup: the pass failed (exit {proc.returncode}): "
                               f"{proc.stderr[-3000:]}")
        with open(out_path) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    warm = res["warmup"]
    res["process_s"] = secs
    log(f"[warmup] System.warmup() {warm['seconds']:.3f}s (synchronised {warm['wall_s']:.3f}s) "
        f"in a fresh process ({secs:.1f}s in all with the pass); kernel launches inside it "
        f"{warm['launches']}")
    _log_path("warmup pass", res)
    first, second = loop_res["stages_host"], loop_res["stages"]
    rows = {}
    for k in ("loop.correct", "loop.essential"):
        rows[k] = [res["stages_host"].get(k, {}).get("ms_per_call"),
                   first.get(k, {}).get("ms_per_call"), second.get(k, {}).get("ms_per_call")]
    log("[warmup] first correction, host ms a call (warmed pass; [loop] first pass, this "
        "process's first correction; [loop] second pass, synchronised): " + "; ".join(
            f"{k} {v}" for k, v in rows.items()))
    warmed, second_ms = rows["loop.correct"][0], rows["loop.correct"][2]
    res["gap_closed"] = (warmed is not None and second_ms is not None
                         and warmed <= 1.25 * second_ms)
    res["first_correction_ms"] = rows
    res["same_as_loop"] = res["sha256"] == loop_res["first"]["sha256"]
    log(f"[warmup] first-correction gap closed (within 25% of the second pass's): "
        f"{res['gap_closed']} (not gated); loops {res['loop_edges']}; trajectory equal to "
        f"[loop]'s {res['same_as_loop']} (not gated)")
    fails = []
    for k in PATH_KERNELS:
        if warm["launches"].get(k, 0) <= 0:
            fails.append(f"{k} never launched inside System.warmup()")
    if not res["ate"] <= GATE_ATE_LOOP:
        fails.append(f"ATE {res['ate']} > {GATE_ATE_LOOP}")
    if res["n_loops_closed"] < GATE_MIN_LOOPS:
        fails.append(f"{res['n_loops_closed']} loops closed < {GATE_MIN_LOOPS}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("warmup failed: " + "; ".join(fails))
    return res


def _gba_chunk(sys_, device):
    """One 5-iteration global BA chunk on the system's map: device time by
    CUDA events (the better of three) and the peak device memory over the
    assembly, the chunk and the result."""
    import torch

    from os1_tpu_torch.optim import ba_begin, ba_iterate, ba_result
    from os1_tpu_torch.pipeline.local_mapping import assemble_global_ba

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prob, _ = assemble_global_ba(sys_.store, sys_.cfg, device)
    state = ba_begin(prob)
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = ba_iterate(prob, state, 5)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    res = ba_result(prob, out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    C, P = prob.cam_T.shape[0], prob.points.shape[0]
    row = dict(cameras=C, points=P, observations=int(prob.obs_valid.sum()),
               chunk_ms=min(times), chunk_ms_runs=times, peak_bytes=int(peak),
               finite=bool(torch.isfinite(res.cam_T).all() and torch.isfinite(res.points).all()))
    log(f"[loop] global BA on the final map: {C} cameras, {P} points, "
        f"{row['observations']} observations; a 5-iteration chunk {row['chunk_ms']:.3f} ms "
        f"(runs {', '.join(f'{t:.3f}' for t in times)}; CUDA events); peak device memory "
        f"{peak} bytes above the {base} held before; finite {row['finite']}")
    if not row["finite"]:
        raise RuntimeError("loop: the global BA chunk gave non-finite values")
    return row


def _mesh(device, axes=("points",)):
    """MESH_SHARDS positions on one device, a 1-D mesh over ``axes``."""
    import torch

    from os1_tpu_torch.parallel import Mesh

    return Mesh(np.full(MESH_SHARDS, torch.device(device), dtype=object), axes)


def _count_mesh_solves(sys_, tally):
    """Route the system's solves through counting views of its backend: the
    mapper's ``shard`` (one a mesh-routed local BA) and the loop closer's
    ``iterate`` (one a global BA chunk); the methods are the backend's."""
    import types

    be = sys_.mesh_backend

    def counted(fn, key):
        def wrapper(*a, **kw):
            tally[key] += 1
            return fn(*a, **kw)
        return wrapper

    view = dict(mesh=be.mesh, shard=be.shard, begin=be.begin, iterate=be.iterate,
                reclassify=be.reclassify, result=be.result)
    sys_.mapper.mesh_backend = types.SimpleNamespace(
        **dict(view, shard=counted(be.shard, "mesh_local_ba")))
    sys_.loop_closer.mesh_backend = types.SimpleNamespace(
        **dict(view, iterate=counted(be.iterate, "mesh_gba_chunks")))


def _event_run(fn, device):
    """(fn(), device ms between two CUDA events around it); on the CPU, the
    host clock's ms."""
    import torch

    if torch.device(device).type != "cuda":
        return _timed(device, fn)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _mesh_gba_parity(sys_, device):
    """The [loop] map's global BA (the same assembly as the loop closer's)
    single-device, over the 1-D mesh and over two_level_backend(2), GBA_ITERS
    iterations in GBA_CHUNK chunks, each chunk timed by CUDA events; the 1-D
    mesh run twice."""
    import torch

    from os1_tpu_torch.optim import ba_begin, ba_iterate, ba_result
    from os1_tpu_torch.parallel import MeshBABackend, two_level_backend
    from os1_tpu_torch.pipeline.local_mapping import assemble_global_ba
    from os1_tpu_torch.pipeline.loop_closing import GBA_CHUNK, GBA_ITERS

    prob, _ = assemble_global_ba(sys_.store, sys_.cfg, device)
    be1 = MeshBABackend(_mesh(device))
    be2 = two_level_backend(MESH_TWO_LEVEL, [torch.device(device)] * MESH_SHARDS)
    single_gather = lambda sp, st: (st.cam_T, st.points, st.cost)  # noqa: E731
    forms = {"single": (lambda p: p, ba_begin, ba_iterate, ba_result, single_gather),
             "mesh_1d": (be1.shard, be1.begin, be1.iterate, be1.result, be1.gather),
             "mesh_1d_rerun": (be1.shard, be1.begin, be1.iterate, be1.result, be1.gather),
             "two_level": (be2.shard, be2.begin, be2.iterate, be2.result, be2.gather)}
    out = {}
    for name, (shard, begin, iterate, result, gather) in forms.items():
        _sync(device)
        sp = shard(prob)
        state = begin(sp)
        chunk_ms = []
        for c in range(GBA_ITERS // GBA_CHUNK):
            state, ms = _event_run(lambda: iterate(sp, state, GBA_CHUNK), device)
            chunk_ms.append(ms)
            if c == 0:
                first_chunk = gather(sp, state)
        res = result(sp, state)
        out[name] = (res, chunk_ms, first_chunk)
    single, _, single_first = out["single"]
    valid = prob.obs_valid
    C, P = prob.cam_T.shape[0], prob.points.shape[0]
    row = dict(cameras=C, points=P, observations=int(valid.sum()), shards=MESH_SHARDS,
               iters=GBA_ITERS,
               psum_bytes_per_iteration=dict(S=C * C * 36 * 4, b_red=C * 6 * 4, cost=4,
                                             parts=MESH_SHARDS))
    row["psum_bytes_per_iteration"]["summed"] = MESH_SHARDS * (C * C * 36 * 4 + C * 6 * 4 + 4)
    for name, (res, chunk_ms, first) in out.items():
        dp = (res.points - single.points).abs().amax(dim=1)
        row[name] = dict(
            chunk_ms=min(chunk_ms), chunk_ms_runs=chunk_ms,
            first_chunk_cam_T_max_abs_diff=float((first[0] - single_first[0]).abs().max()),
            first_chunk_points_max_abs_diff=float((first[1] - single_first[1]).abs().max()),
            cam_T_max_abs_diff=float((res.cam_T - single.cam_T).abs().max()),
            points_max_abs_diff=float(dp.max()),
            points_p999_abs_diff=float(torch.quantile(dp, 0.999)),
            points_over_gate=int((dp > GATE_MESH_POINTS).sum()),
            cost_rel_diff=float((res.cost - single.cost).abs() / single.cost.abs()),
            inlier_agreement=float((res.obs_inlier == single.obs_inlier)[valid].float().mean()),
            finite=bool(torch.isfinite(res.cam_T).all() and torch.isfinite(res.points).all()))
    a, b = out["mesh_1d"][0], out["mesh_1d_rerun"][0]
    row["rerun_identical"] = all(torch.equal(x, y) for x, y in zip(a, b))
    return row


def _mesh_graph_parity(args, device):
    """The essential graph of the [mesh] pass's first correction (its
    recorded inputs) single-device and over the edge mesh, the mesh twice,
    each timed by CUDA events."""
    import torch

    from os1_tpu_torch.optim.pose_graph import optimize_pose_graph
    from os1_tpu_torch.parallel import distributed_pose_graph

    g = {k: v for k, v in args.items() if k not in ("mesh", "iters", "edge_valid")}
    single, single_ms = _event_run(lambda: optimize_pose_graph(**g, iters=args["iters"]),
                                   device)
    emesh = _mesh(device, ("edges",))
    runs = [_event_run(lambda: distributed_pose_graph(**g, edge_valid=args["edge_valid"],
                                                      mesh=emesh, iters=args["iters"]),
                       device)
            for _ in range(2)]
    K, E = g["S"].shape[0], int(g["edge_i"].shape[0])
    return dict(keyframes=K, edges=E, iters=args["iters"], single_ms=single_ms,
                mesh_ms=[ms for _, ms in runs],
                max_abs_diff=float((runs[0][0] - single).abs().max()),
                rerun_identical=bool(torch.equal(runs[0][0], runs[1][0])),
                finite=bool(torch.isfinite(runs[0][0]).all()),
                psum_bytes_per_iteration=dict(H=K * K * 49 * 4, b=K * 7 * 4, cost=4,
                                              parts=MESH_SHARDS,
                                              summed=MESH_SHARDS * (K * K * 49 * 4 + K * 28 + 4)))


def _mesh_database(sys_, device):
    """DistKeyFrameDatabase over MESH_SHARDS positions loaded with the [loop]
    system's keyframe bows; each live keyframe queried (itself excluded)
    against the host database holding the same bows cut to W_CAP words (the
    reference's parity contract), and beside the whole bows' host query."""
    from os1_tpu_torch.parallel import DistKeyFrameDatabase
    from os1_tpu_torch.parallel.dist_database import W_CAP
    from os1_tpu_torch.vocab.database import KeyFrameDatabase, SparseBow

    host = sys_.db
    live = [k for k in range(MAP_KEYFRAMES) if host.active[k] and host.bows[k] is not None]
    dist = DistKeyFrameDatabase(_mesh(device, ("kfs",)), MAP_KEYFRAMES)
    capped = KeyFrameDatabase(host.vocab, MAP_KEYFRAMES)
    cap = {k: SparseBow(host.bows[k].words[:W_CAP], host.bows[k].weights[:W_CAP]) for k in live}
    for k in live:
        dist.add(k, host.bows[k])
        capped.add(k, cap[k])
    _, publish_ms = _timed(device, dist.publish)
    rows, t_dist, t_capped, t_host = [], [], [], []
    for k in live:
        t0 = time.perf_counter()
        ids, scores = dist.query(host.bows[k], exclude=[k])
        t_dist.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        capped.query(cap[k], exclude=[k])
        t_capped.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        h_ids, _ = host.query(host.bows[k], exclude=[k])
        t_host.append(time.perf_counter() - t0)
        ref = np.array([capped.score_kf(cap[k], j) if j != k else 0.0 for j in live], np.float32)
        order = np.argsort(-ref, kind="stable")
        order = order[ref[order] > 0][:64]
        ref_ids, ref_scores = np.asarray(live)[order], ref[order]
        exact = bool(np.array_equal(ids, ref_ids))
        close = (len(ids) == len(ref_ids) and set(ids.tolist()) == set(ref_ids.tolist())
                 and bool(np.allclose(scores, ref_scores, atol=GATE_DB_SCORE, rtol=0)))
        rows.append(dict(kf=k, n=len(ids), ids_exact=exact, ids_within_ties=exact or close,
                         max_score_diff=float(np.abs(scores - ref_scores).max())
                         if len(ids) == len(ref_ids) and len(ids) else 0.0,
                         top_equals_whole_bow_host=bool(len(ids) and len(h_ids)
                                                        and ids[0] == h_ids[0])))
    n_words = [len(host.bows[k].words) for k in live]
    return dict(keyframes=len(live), shards=MESH_SHARDS, w_cap=W_CAP,
                words_per_bow=[min(n_words), max(n_words)],
                bows_over_cap=sum(n > W_CAP for n in n_words), publish_ms=publish_ms,
                query_ms=float(np.median(t_dist) * 1e3),
                host_capped_query_ms=float(np.median(t_capped) * 1e3),
                host_query_ms=float(np.median(t_host) * 1e3),
                ids_exact=sum(r["ids_exact"] for r in rows),
                ids_within_ties=sum(r["ids_within_ties"] for r in rows),
                max_score_diff=max(r["max_score_diff"] for r in rows),
                top_equals_whole_bow_host=sum(r["top_equals_whole_bow_host"] for r in rows),
                rows=rows)


def phase_mesh(frames, poses, sys_loop, loop_ref, device="cuda"):
    """The distributed back end on one card: (a) bench.py's loop sequence in
    the shipped mode over an 8-shard mesh, System(distributed=True, mesh=...),
    gated as [loop] and on mesh-routed local BAs, global BA chunks and
    essential graphs; (b) the [loop] map's global BA and the pass's essential
    graph single-device and on the meshes, compared and rerun; (c) the sharded
    keyframe database on the [loop] system's bows."""
    from os1_tpu_torch.pipeline import loop_closing

    tally = dict(sim3_evals=0, sim3_fused_launches=0, mesh_local_ba=0, mesh_gba_chunks=0,
                 mesh_essential=0)
    graphs = []
    dpg = loop_closing.distributed_pose_graph

    def counted_graph(*a, **kw):
        tally["mesh_essential"] += 1
        if not graphs:
            graphs.append(kw)
        return dpg(*a, **kw)

    def on_build(s):
        _count_sim3_launches(s, tally)
        _count_mesh_solves(s, tally)

    loop_closing.distributed_pose_graph = counted_graph
    try:
        _peak_mem(device, reset=True)
        sys_, lat, ok, reads, launches = drive(frames, mapping=True, device=device, shipped=True,
                                               loop=True, on_build=on_build,
                                               mesh=_mesh(device))
    finally:
        loop_closing.distributed_pose_graph = dpg
    res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
    lc = sys_.loop_closer
    first = res["init_frame"]
    host = sys_.timer
    stages = {k: dict(total_s=host.totals[k], calls=host.counts[k],
                      ms_per_call=host.totals[k] / host.counts[k] * 1e3)
              for k in ("lm.ba.dispatch",) + LOOP_STAGES if host.counts.get(k)}
    res.update(tally, peak_mem_bytes=_peak_mem(device), frames=len(frames),
               wall_fps=len(frames) / sys_.wall_s, sha256=_traj_sha(traj),
               ok_fraction=float(ok[first:].mean()) if first < len(ok) else 0.0,
               n_loops_closed=lc.n_loops_closed, loop_edges=[list(e) for e in lc.loop_edges],
               idle_after_flush=(not sys_._pending_frames and not sys_.coop.busy()
                                 and not sys_.tracker._pending), stages_host=stages)
    _log_path("mesh", res)
    log(f"[mesh] 8 shards on {device}: whole run incl. flush {sys_.wall_s:.3f}s = "
        f"{res['wall_fps']:.3f} frames/s; OK fraction {res['ok_fraction']:.4f}; loss events "
        f"{res['loss_log']}; loops closed {res['n_loops_closed']} (edges {res['loop_edges']}); "
        f"mesh-routed local BAs {tally['mesh_local_ba']}, global BA chunks "
        f"{tally['mesh_gba_chunks']}, essential graphs {tally['mesh_essential']}; "
        f"{tally['sim3_evals']} Sim3 evaluations with {tally['sim3_fused_launches']} fused-match "
        f"launches; idle after flush {res['idle_after_flush']}")
    ref_stages = loop_ref["stages_host"]
    first_ref = loop_ref["first"]
    log(f"[mesh] beside [loop]'s first pass (single device, same frames): frames/s "
        f"{res['fps_ok']:.3f} vs {first_ref['fps_ok']:.3f}; p50 {res['p50_ms']:.3f} vs "
        f"{first_ref['p50_ms']:.3f} ms; p99 {res['p99_ms']:.3f} vs {first_ref['p99_ms']:.3f} ms; "
        + "; ".join(f"{k} {stages[k]['ms_per_call']:.3f} ({stages[k]['calls']} calls) vs "
                    + (f"{ref_stages[k]['ms_per_call']:.3f} ({ref_stages[k]['calls']} calls)"
                       if k in ref_stages else "not run")
                    for k in ("lm.ba.dispatch", "loop.gba.chunk", "loop.essential")
                    if k in stages) + " ms a call, host clock")
    fails = []
    if not res["ate"] <= GATE_ATE_LOOP:
        fails.append(f"ATE {res['ate']} > {GATE_ATE_LOOP}")
    if res["n_loops_closed"] < GATE_MIN_LOOPS:
        fails.append(f"{res['n_loops_closed']} loops closed < {GATE_MIN_LOOPS}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    if not res["idle_after_flush"]:
        fails.append("the scheduler busy after flush")
    for k in ("mesh_local_ba", "mesh_gba_chunks", "mesh_essential"):
        if tally[k] <= 0:
            fails.append(f"{k}: no solve routed through the mesh")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("mesh pipeline failed: " + "; ".join(fails))

    clock = "CUDA events" if device != "cpu" else "host clock"
    gba = _mesh_gba_parity(sys_loop, device)
    log(f"[mesh] global BA of the [loop] map: {gba['cameras']} cameras, {gba['points']} points, "
        f"{gba['observations']} observations; psum per LM iteration: S {gba['psum_bytes_per_iteration']['S']} B "
        f"+ b_red {gba['psum_bytes_per_iteration']['b_red']} B + cost 4 B a part, "
        f"{gba['psum_bytes_per_iteration']['summed']} B summed over {MESH_SHARDS} parts")
    for name in ("single", "mesh_1d", "mesh_1d_rerun", "two_level"):
        r = gba[name]
        log(f"[mesh]   {name}: chunk of 5 iterations {r['chunk_ms']:.3f} ms (runs "
            f"{', '.join(f'{t:.3f}' for t in r['chunk_ms_runs'])}; {clock}); vs single "
            f"after the first chunk max|dcam_T| {r['first_chunk_cam_T_max_abs_diff']:.3e}, "
            f"max|dpoints| {r['first_chunk_points_max_abs_diff']:.3e}; after "
            f"{gba['iters']} iterations max|dcam_T| {r['cam_T_max_abs_diff']:.3e}, |dpoints| max "
            f"{r['points_max_abs_diff']:.3e}, 99.9th percentile {r['points_p999_abs_diff']:.3e}, "
            f"{r['points_over_gate']} points over {GATE_MESH_POINTS}; cost relative diff "
            f"{r['cost_rel_diff']:.3e}; inlier agreement {r['inlier_agreement']:.6f}")
    log(f"[mesh]   mesh rerun bit-identical {gba['rerun_identical']}")
    graph = _mesh_graph_parity(graphs[0], device)
    log(f"[mesh] essential graph of the pass's first correction: {graph['keyframes']} keyframes, "
        f"{graph['edges']} edges, {graph['iters']} iterations; single {graph['single_ms']:.3f} "
        f"ms, mesh {', '.join(f'{t:.3f}' for t in graph['mesh_ms'])} ms ({clock}); "
        f"max|dS| {graph['max_abs_diff']:.3e}; rerun bit-identical {graph['rerun_identical']}; "
        f"psum per iteration H {graph['psum_bytes_per_iteration']['H']} B a part, "
        f"{graph['psum_bytes_per_iteration']['summed']} B summed")
    db = _mesh_database(sys_loop, device)
    log(f"[mesh] sharded keyframe database: {db['keyframes']} keyframes over {MESH_SHARDS} "
        f"shards, {db['words_per_bow']} words a bow ({db['bows_over_cap']} over W_CAP "
        f"{db['w_cap']}); ids equal to the host's on the capped bows: {db['ids_exact']} exactly, "
        f"{db['ids_within_ties']} within near-ties, of {db['keyframes']} queries; max score "
        f"diff {db['max_score_diff']:.3e}; top id equal to the whole-bow host query's "
        f"{db['top_equals_whole_bow_host']}; ms a query (host clock, median): sharded "
        f"{db['query_ms']:.3f}, host capped {db['host_capped_query_ms']:.3f}, host whole "
        f"{db['host_query_ms']:.3f}; publish {db['publish_ms']:.3f} ms")
    for name in ("mesh_1d", "two_level"):
        r = gba[name]
        if not (r["finite"] and r["first_chunk_cam_T_max_abs_diff"] <= GATE_MESH_POSE
                and r["first_chunk_points_max_abs_diff"] <= GATE_MESH_POINTS
                and r["cost_rel_diff"] <= GATE_MESH_COST
                and r["inlier_agreement"] >= GATE_MESH_INLIERS):
            fails.append(f"global BA {name} disagrees with single-device")
    if not gba["rerun_identical"]:
        fails.append("the mesh global BA rerun differs")
    if not (graph["finite"] and graph["max_abs_diff"] <= GATE_MESH_GRAPH):
        fails.append("the mesh essential graph disagrees with single-device")
    if not graph["rerun_identical"]:
        fails.append("the mesh essential graph rerun differs")
    if db["ids_within_ties"] != db["keyframes"] or db["max_score_diff"] > GATE_DB_SCORE:
        fails.append("the sharded database disagrees with the host database")
    if fails:
        raise RuntimeError("mesh failed: " + "; ".join(fails))
    return dict(pipeline=res, gba=gba, graph=graph, database=db)


def phase_orbit_loop(frames, poses, device="cuda"):
    """bench.py's orbit in bench.py's own configuration: the shipped mode with
    loop closing on, one pass. Returns the numbers and the system."""
    _peak_mem(device, reset=True)
    sys_, lat, ok, reads, launches = drive(frames, mapping=True, device=device, shipped=True,
                                           loop=True)
    res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
    res.update(peak_mem_bytes=_peak_mem(device), frames=len(frames),
               wall_fps=len(frames) / sys_.wall_s,
               n_loops_closed=sys_.loop_closer.n_loops_closed,
               loop_edges=[list(e) for e in sys_.loop_closer.loop_edges])
    _log_path("orbit-loop", res)
    log(f"[orbit-loop] whole run incl. flush {sys_.wall_s:.3f}s = {res['wall_fps']:.3f} "
        f"frames/s; loops closed {res['n_loops_closed']} (edges {res['loop_edges']}"
        f"{'; a closure on the orbit is a finding' if res['n_loops_closed'] else ''}); ATE "
        f"{res['ate']:.6f} with loop closing on against {ORBIT_ATE_LOOP_OFF} recorded with it off")
    first = res["init_frame"]
    fails = []
    if first > GATE_INIT_BY:
        fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
    if ok[first:].mean() < GATE_OK_FRACTION:
        fails.append(f"OK on {ok[first:].mean():.4f} of the frames from {first}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    if not res["ate"] <= GATE_ATE:
        fails.append(f"ATE {res['ate']} > {GATE_ATE}")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("orbit-loop failed: " + "; ".join(fails))
    return res, sys_


def _rot_t_err(T, ref):
    dR = T[:3, :3] @ ref[:3, :3].T
    return (float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))),
            float(np.linalg.norm(T[:3, 3] - ref[:3, 3])))


def _timed(device, fn):
    """(fn(), ms) on the host clock, the card synchronised before and after."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _save(sys_, base, options, device):
    header, ms = _timed(device, lambda: sys_.save_map(base, options))
    st = sys_.store
    sizes = {ext: os.path.getsize(base + ext)
             for ext in (".yaml", ".mappoints", ".keyframes", ".features")}
    ok = (header["nKeyframes"] == st.n_keyframes() and header["nMappoints"] == st.n_points()
          and not sys_._pending_frames)
    return dict(options=options, ms=ms, bytes=sizes, keyframes=header["nKeyframes"],
                points=header["nMappoints"], features=header["nFeatures"], counts_match=ok)


def _session(frames, lo, hi, device):
    """A fresh shipped system over loop frames lo..hi-1, timestamps from the
    global frame index, flushed."""
    sys_ = build_system(device, mapping=True, shipped=True, loop=True)
    ok = []
    for i in range(lo, hi):
        state, _ = sys_.track_monocular(frames[i], timestamp=i / 30.0)
        ok.append(state.name == "OK")
    sys_.flush()
    return sys_, np.array(ok)


def _resume(base, frames, recorded, device):
    """Load map A into a fresh shipped system and replay OSMAP_RESUME's frames:
    per frame the state and the fused-match launches made while it was LOST."""
    from os1_tpu_torch.pipeline import TrackingState

    sys_ = build_system(device, mapping=True, shipped=True, loop=True)
    counters = _counters()
    _reset_counts(counters)
    _, load_ms = _timed(device, lambda: sys_.load_map(base))
    lost_after_load = sys_.state == TrackingState.LOST
    states, lost_launches, first_ok, Tcw_first = [], 0, None, None
    lo, hi = OSMAP_RESUME
    for i in range(lo, hi):
        was_lost = sys_.state == TrackingState.LOST
        g0 = counters["gated_match_cuda"].launches
        state, Tcw = sys_.track_monocular(frames[i], timestamp=i / 30.0)
        if was_lost:
            lost_launches += counters["gated_match_cuda"].launches - g0
        states.append(state == TrackingState.OK)
        if first_ok is None and state == TrackingState.OK:
            first_ok, Tcw_first = i, Tcw
    sys_.flush()
    _sync(device)
    res = dict(load_ms=load_ms, lost_after_load=lost_after_load, first_ok=first_ok,
               lost_fused_launches=lost_launches,
               states="".join("O" if s else "." for s in states),
               launches={k: c.launches for k, c in counters.items()})
    if first_ok is not None:
        res["rot_err_rad"], res["t_err"] = _rot_t_err(Tcw_first, recorded[first_ok])
        after = states[first_ok - lo + 1:]
        res["ok_after"] = float(np.mean(after)) if after else 0.0
    return res


def _merge(base_a, base_b, device, tally):
    sys_ = build_system(device, mapping=True, shipped=True, loop=True)
    _count_sim3_launches(sys_, tally)
    sys_.load_map(base_a)
    st = sys_.store
    n_kf, n_pt = st.n_keyframes(), st.n_points()
    gba0 = sys_.timer.totals.get("merge.gba", 0.0)
    merged, ms = _timed(device, lambda: sys_.merge_session(base_b))
    return sys_, merged, ms, (sys_.timer.totals.get("merge.gba", 0.0) - gba0) * 1e3, n_kf, n_pt


def phase_osmap(sys_a, sys_o, frames, poses, device="cuda"):
    """Osmap persistence on the card. Map A is the [loop] first pass's system,
    map O the [orbit-loop] system's (another scene). Saves A (three layouts)
    and O; reloads A into a bare store, exactly; loads A into a fresh shipped
    system and replays loop frames OSMAP_RESUME (LOST after the load, then
    relocalization gated as [reloc]); merges session B (a fresh shipped
    system over the loop's frames 180-299) into a fresh load of A (gated on
    the alignment, the ATE against ground truth and the Sim3's fused
    launches); and merges O into a fresh load of A, which must roll back."""
    from os1_tpu_torch.io import osmap_io, synthetic
    from os1_tpu_torch.map.store import MapStore

    tmp = tempfile.mkdtemp(prefix="osmap_")
    try:
        fails, res = [], {}
        base = {k: os.path.join(tmp, k) for k in ("a", "a_delim", "a_mp", "o", "b")}
        res["save"] = {
            "A": _save(sys_a, base["a"], 0, device),
            "A delimited": _save(sys_a, base["a_delim"], osmap_io.FEATURES_FILE_DELIMITED, device),
            "A mappoint features": _save(sys_a, base["a_mp"], osmap_io.ONLY_MAPPOINTS_FEATURES,
                                         device),
            "O": _save(sys_o, base["o"], 0, device)}
        for tag, r in res["save"].items():
            log(f"[osmap] save {tag} (options {r['options']}): {r['keyframes']} keyframes, "
                f"{r['points']} points, {r['features']} features in {r['ms']:.3f} ms; bytes "
                f"{r['bytes']}; header counts = live counts and nothing pending "
                f"{r['counts_match']}")
            if not r["counts_match"]:
                fails.append(f"save {tag}: header counts or pending keyframes")

        st = sys_a.store
        live = np.nonzero(st.kf_valid)[0]
        # The load's rebuild culls points left with no observation (Osmap::
        # rebuild); every other live point comes back.
        kept = st.pt_valid & (st.pt_n_obs > 0)
        pts = np.nonzero(kept)[0]
        res["reload"] = {}
        for tag in ("a", "a_delim"):
            bare = MapStore(st.cfg)
            _, ms = _timed(device, lambda: osmap_io.load_map(bare, sys_a.cfg, base[tag]))
            _, rebuild_ms = _timed(device, lambda: osmap_io.rebuild(bare, sys_a.cfg))
            exact = bool(np.array_equal(bare.kf_valid, st.kf_valid)
                         and np.array_equal(bare.pt_valid, kept)
                         and all(np.array_equal(getattr(bare, f)[live], getattr(st, f)[live])
                                 for f in ("kf_T", "kf_obs_point", "kf_feat_valid", "kf_xy",
                                           "kf_desc"))
                         and np.array_equal(bare.pt_xyz[pts], st.pt_xyz[pts]))
            orphans = int(st.pt_valid.sum() - kept.sum())
            res["reload"][tag] = dict(load_ms=ms, rebuild_ms=rebuild_ms, exact=exact,
                                      orphans_culled=orphans)
            log(f"[osmap] reload {tag} into a bare MapStore: {ms:.3f} ms with the rebuild (a "
                f"rebuild alone {rebuild_ms:.3f} ms); kf_T, pt_xyz, kf_obs_point, kf_feat_valid, "
                f"kf_xy, kf_desc equal on the live slots, less the {orphans} points with no "
                f"observation that the rebuild culls: {exact}")
            if not exact:
                fails.append(f"reload {tag} differs from the saved map")

        recorded = {fid: T for _, fid, T in sys_a.frame_trajectory()}
        r = res["resume"] = _resume(base["a"], frames, recorded, device)
        log(f"[osmap] resume: load_map {r['load_ms']:.3f} ms; LOST after the load "
            f"{r['lost_after_load']}; replayed frames {OSMAP_RESUME[0]}..{OSMAP_RESUME[1] - 1}: "
            f"{r['states']}; first OK at frame {r['first_ok']}"
            + (f", {r['rot_err_rad']:.6f} rad and {r['t_err']:.6f} units from the [loop] pass's "
               f"pose; OK on {r['ok_after']:.4f} of the frames after it" if r["first_ok"] is not None
               else "")
            + f"; {r['lost_fused_launches']} fused-match launches on the LOST frames; launches "
            f"{r['launches']}")
        if not r["lost_after_load"]:
            fails.append("resume: not LOST after the load")
        if r["first_ok"] is None or r["first_ok"] - OSMAP_RESUME[0] >= GATE_RELOC_WITHIN:
            fails.append(f"resume: not OK within {GATE_RELOC_WITHIN} replayed frames")
        elif (r["rot_err_rad"] >= GATE_RELOC_RAD or r["t_err"] >= GATE_RELOC_T
              or r["ok_after"] < GATE_RESUME_OK_AFTER):
            fails.append("resume: relocalized pose too far or tracking not kept")
        if r["lost_fused_launches"] <= 0:
            fails.append("resume: no fused-match launch on the LOST frames")

        n_a = st.n_keyframes()
        counters = _counters()
        _reset_counts(counters)
        for lo, hi in OSMAP_B_SPANS:
            (sys_b, ok_b), b_ms = _timed(device, lambda: _session(frames, lo, hi, device))
            if n_a + sys_b.store.n_keyframes() <= st.cfg.max_keyframes:
                break
            log(f"[osmap] session B over {lo}..{hi - 1}: {sys_b.store.n_keyframes()} keyframes "
                f"do not fit beside A's {n_a} in {st.cfg.max_keyframes} slots; shortened")
        b = res["session_b"] = dict(span=[lo, hi], ms=b_ms, keyframes=sys_b.store.n_keyframes(),
                                    points=sys_b.store.n_points(),
                                    ok_fraction=float(ok_b.mean()))
        b["save"] = _save(sys_b, base["b"], 0, device)
        log(f"[osmap] session B over loop frames {lo}..{hi - 1} in {b_ms:.1f} ms: "
            f"{b['keyframes']} keyframes, {b['points']} points, OK on {b['ok_fraction']:.4f} of "
            f"its frames; saved in {b['save']['ms']:.3f} ms")
        del sys_b
        tally = dict(sim3_evals=0, sim3_fused_launches=0)
        sys_m, merged, ms, gba_ms, n_kf, n_pt = _merge(base["a"], base["b"], device, tally)
        sm = sys_m.store
        traj = sys_m.keyframe_trajectory()
        fids = [int(round(ts * 30.0)) for ts, _ in traj]
        gt = [poses[f] for f in fids]
        ate = synthetic.ate_rmse([np.linalg.inv(Twc) for _, Twc in traj], gt)
        centers = np.array([-T[:3, :3].T @ T[:3, 3] for T in gt])
        path = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
        m = res["merge"] = dict(
            merged=bool(merged), ms=ms, gba_ms=gba_ms, keyframes_before=n_kf,
            keyframes_after=sm.n_keyframes(), points_before=n_pt, points_after=sm.n_points(),
            pair=[int(x) for x in sys_m.loop_closer.loop_edges[-1]] if merged else None,
            ate=float(ate), path=path, **tally,
            finite=bool(np.isfinite(sm.kf_T[sm.kf_valid]).all()
                        and np.isfinite(sm.pt_xyz[sm.pt_valid]).all()),
            launches={k: c.launches for k, c in counters.items()})
        log(f"[osmap] merge B into A: {m['merged']} in {ms:.3f} ms (global BA {gba_ms:.3f} ms); "
            f"aligned pair {m['pair']}; keyframes {n_kf} -> {m['keyframes_after']}, points "
            f"{n_pt} -> {m['points_after']}; joint keyframe ATE {ate:.6f} over a {path:.4f}-unit "
            f"path ({ate / path:.6f}; gate {GATE_MERGE_ATE}); {m['sim3_evals']} Sim3 evaluations "
            f"with {m['sim3_fused_launches']} fused-match launches; finite {m['finite']}; "
            f"launches from session B to the merge {m['launches']}")
        if not merged:
            fails.append("merge: no alignment found")
        elif not (m["keyframes_after"] > n_kf and m["finite"] and ate < GATE_MERGE_ATE * path):
            fails.append("merge: keyframes not added, non-finite, or ATE over the gate")
        if m["sim3_fused_launches"] <= 0:
            fails.append("merge: no fused-match launch during the Sim3 evaluations")
        del sys_m

        tally = dict(sim3_evals=0, sim3_fused_launches=0)
        sys_r, merged, ms, _, n_kf, n_pt = _merge(base["a"], base["o"], device, tally)
        rb = res["rollback"] = dict(merged=bool(merged), ms=ms, **tally,
                                    unchanged=(sys_r.store.n_keyframes() == n_kf
                                               and sys_r.store.n_points() == n_pt))
        log(f"[osmap] merge O (the orbit's scene) into A: {rb['merged']} in {ms:.3f} ms after "
            f"{rb['sim3_evals']} Sim3 evaluations; keyframe and point counts unchanged "
            f"{rb['unchanged']}")
        if rb["merged"] or not rb["unchanged"]:
            fails.append("rollback: the disjoint map aligned or the counts changed")
        if fails:
            raise RuntimeError("osmap failed: " + "; ".join(fails))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_threaded(tag, frames, poses, coop_ref, device="cuda"):
    """run_slam's default mode, the reference's thread topology:
    System(cfg, pipelined=True, async_mapping=True), loop closing on, one
    pass over ``frames`` (tag "orbit" or "loop"). Gated, after flush(), on
    every live keyframe materialized, nothing pending, no exception caught by
    a worker thread and launches of every kernel of the path; the orbit on
    initialization by frame 10, OK on GATE_OK_THREADED of the frames from the
    first OK one and ATE <= 0.2; the loop sequence on ATE <= 0.22 and a loop
    closed, corrected on the LoopClosing thread, with a global-BA thread
    spawned and joined. Reports frames/s, p50/p99 of the call's host time,
    host reads and launches a frame by thread, the map-lock wait by thread,
    the worker queue depths, and ``coop_ref``'s (the shipped mode's first
    pass over the same frames in this call) frames/s beside its own."""
    import threading

    corrected_on, corrected_at = [], []

    def on_build(s):
        correct = s.loop_closer.correct

        def traced(*a, **kw):
            corrected_on.append(threading.current_thread().name)
            tr = s.tracker  # under the map lock: the last frame applied, the caller's frame
            corrected_at.append((tr.last.frame_id if tr.last is not None else -1,
                                 tr.frame_id - 1))
            return correct(*a, **kw)

        s.loop_closer.correct = traced

    _peak_mem(device, reset=True)
    sys_, lat, ok, reads, launches = drive(frames, mapping=True, device=device, loop=True,
                                           threaded=True, on_build=on_build)
    try:
        res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
        lc, st, n = sys_.loop_closer, sys_.store, len(frames)
        first = res["init_frame"]
        live = np.nonzero(st.kf_valid)[0]
        depths = sys_.queue_depths
        gba = lc._gba_thread
        res.update(
            peak_mem_bytes=_peak_mem(device), frames=n, wall_fps=n / sys_.wall_s,
            sha256=_traj_sha(traj), ok_fraction=float(ok[first:].mean()) if first < n else 0.0,
            n_loops_closed=lc.n_loops_closed, loop_edges=[list(e) for e in lc.loop_edges],
            corrected_on=corrected_on, gba_spawned=lc.gba_spawned,
            gba_joined=gba is None or not gba.is_alive(),
            all_materialized=bool(all(st.kf_feat_valid[i].any() for i in live)),
            idle_after_flush=(not sys_._pending_frames and not sys_.tracker._pending
                              and sys_.mapping_worker.queue_size() == 0
                              and sys_.loop_worker.queue_size() == 0),
            worker_errors=[f"{name} kf {kf}: {exc!r}" for name, kf, exc in sys_.worker_errors()],
            stale_binds=sys_.tracker.stale_binds,
            launches_by_thread=sys_.launches_by_thread,
            launches_per_frame_by_thread={k: {t: v / n for t, v in d.items()}
                                          for k, d in sys_.launches_by_thread.items()},
            lock_wait_s=dict(sys_.lock.wait_s), lock_waits=dict(sys_.lock.waits),
            queue_max=[sys_.mapping_worker.max_queue, sys_.loop_worker.max_queue],
            queue_mean=[float(x) for x in depths.mean(axis=0)] if len(depths) else None,
            coop_fps_ok=coop_ref["fps_ok"], coop_p50_ms=coop_ref["p50_ms"],
            coop_p99_ms=coop_ref["p99_ms"], coop_wall_fps=coop_ref["wall_fps"])
        res["tracker_lock_wait_ms_per_frame"] = res["lock_wait_s"].get("MainThread", 0.0) * 1e3 / n
        tm = sys_.timer
        res["derived_stages_ms"] = {k: tm.totals[k] / tm.counts[k] * 1e3
                                    for k in DERIVED_STAGES if tm.counts.get(k)}
        res["corrected_at"] = corrected_at
        res["lost_after_correction"] = sorted({
            int(f) for f, _ in sys_.tracker.loss_log for last, cur in corrected_at
            if last < int(f) <= cur + GATE_AFTER_CORRECTION})
        label = f"threaded {tag}"
        _log_path(label, res)
        log(f"[{label}] whole run incl. flush {sys_.wall_s:.3f}s = {res['wall_fps']:.3f} frames/s; "
            f"the shipped (coop) mode over the same frames in this call: {res['coop_fps_ok']:.3f} "
            f"frames/s, p50 {res['coop_p50_ms']:.3f} ms, p99 {res['coop_p99_ms']:.3f} ms, whole "
            f"run {res['coop_wall_fps']:.3f} frames/s")
        log(f"[{label}] OK fraction {res['ok_fraction']:.4f} from frame {first}; loss events "
            f"{res['loss_log']}; loops closed {res['n_loops_closed']} (edges {res['loop_edges']}), "
            f"corrected on {corrected_on}; global-BA threads {lc.gba_spawned}, joined "
            f"{res['gba_joined']}; trajectory sha256 {res['sha256'][:16]} (not gated)")
        log(f"[{label}] launches a frame by thread: {res['launches_per_frame_by_thread']}")
        log(f"[{label}] map-lock wait by thread: "
            + ", ".join(f"{t} {w * 1e3:.1f} ms over {res['lock_waits'][t]} waits"
                        for t, w in res["lock_wait_s"].items())
            + f" (tracker {res['tracker_lock_wait_ms_per_frame']:.3f} ms a frame); queue depth "
            f"(mapping, loop): max {res['queue_max']}, mean after a frame {res['queue_mean']}")
        log(f"[{label}] corrections at (last frame applied, frame in the call) "
            f"{corrected_at}; frames lost within {GATE_AFTER_CORRECTION} frames after one: "
            f"{res['lost_after_correction']}")
        log(f"[{label}] host ms a call of the stages that update the points' derived state "
            f"(the distinctive descriptor in host C++): " + "; ".join(
                f"{k} {v:.3f}" for k, v in res["derived_stages_ms"].items()))
        log(f"[{label}] all keyframes materialized {res['all_materialized']}; idle after flush "
            f"{res['idle_after_flush']}; worker errors {res['worker_errors']}; bindings dropped "
            f"because their point slot was refilled in flight {res['stale_binds']}")
        fails = []
        if tag == "orbit":
            if first > GATE_INIT_BY:
                fails.append(f"initialized at frame {first} > {GATE_INIT_BY}")
            if res["ok_fraction"] < GATE_OK_THREADED:
                fails.append(f"OK on {res['ok_fraction']:.4f} < {GATE_OK_THREADED} of the frames")
            if not res["ate"] <= GATE_ATE:
                fails.append(f"ATE {res['ate']} > {GATE_ATE}")
        else:
            if not res["ate"] <= GATE_ATE_LOOP:
                fails.append(f"ATE {res['ate']} > {GATE_ATE_LOOP}")
            if res["n_loops_closed"] < GATE_MIN_LOOPS:
                fails.append(f"{res['n_loops_closed']} loops closed < {GATE_MIN_LOOPS}")
            if not corrected_on or set(corrected_on) != {"LoopClosing"}:
                fails.append(f"corrections not on the LoopClosing thread: {corrected_on}")
            if lc.gba_spawned < 1 or not res["gba_joined"]:
                fails.append("no global-BA thread spawned and joined")
            if res["lost_after_correction"]:
                fails.append(f"frames {res['lost_after_correction']} lost within "
                             f"{GATE_AFTER_CORRECTION} frames after a correction")
        if not res["finite"]:
            fails.append("non-finite or misshaped poses")
        if not (res["all_materialized"] and res["idle_after_flush"]):
            fails.append("keyframes left unmaterialized or work pending after flush")
        if res["worker_errors"]:
            fails.append(f"worker threads caught exceptions: {res['worker_errors']}")
        _launch_gate(res, fails)
        if fails:
            raise RuntimeError(f"{label} failed: " + "; ".join(fails))
        return res
    finally:
        sys_.shutdown()


def phase_photo(frames, poses, device="cuda"):
    """bench.py's photo room (photo_room_scene() along loop_trajectory(300),
    bench.py:95-113) in the shipped mode with loop closing on, one pass,
    gated as bench.py gates it: Sim3-aligned ATE <= 0.25, OK on 70% of the
    frames from the first OK one, a loop closed; also the launches of every
    kernel on the path and the scheduler idle after flush."""
    tally = dict(sim3_evals=0, sim3_fused_launches=0)
    _peak_mem(device, reset=True)
    sys_, lat, ok, reads, launches = drive(
        frames, mapping=True, device=device, shipped=True, loop=True,
        on_build=lambda s: _count_sim3_launches(s, tally))
    res, traj = summarize(sys_, lat, ok, reads, launches, poses, stretch_end=len(frames))
    lc, first, n = sys_.loop_closer, res["init_frame"], len(frames)
    res.update(tally, peak_mem_bytes=_peak_mem(device), frames=n, wall_fps=n / sys_.wall_s,
               sha256=_traj_sha(traj),
               ok_fraction=float(ok[first:].mean()) if first < n else 0.0,
               n_loops_closed=lc.n_loops_closed, loop_edges=[list(e) for e in lc.loop_edges],
               launches_per_frame={k: v / n for k, v in launches.items()},
               idle_after_flush=(not sys_._pending_frames and not sys_.coop.busy()
                                 and not sys_.tracker._pending))
    _log_path("photo", res)
    log(f"[photo] whole run incl. flush {sys_.wall_s:.3f}s = {res['wall_fps']:.3f} frames/s; OK "
        f"fraction {res['ok_fraction']:.4f} from frame {first} (gate >= {GATE_OK_PHOTO}); loss "
        f"events {res['loss_log']}; loops closed {res['n_loops_closed']} (edges "
        f"{res['loop_edges']}); {res['sim3_evals']} Sim3 candidate evaluations with "
        f"{res['sim3_fused_launches']} fused-match launches; ATE {res['ate']:.6f} (gate <= "
        f"{GATE_ATE_PHOTO}); trajectory sha256 {res['sha256'][:16]}")
    fails = []
    if not res["ate"] <= GATE_ATE_PHOTO:
        fails.append(f"ATE {res['ate']} > {GATE_ATE_PHOTO}")
    if res["ok_fraction"] < GATE_OK_PHOTO:
        fails.append(f"OK on {res['ok_fraction']:.4f} < {GATE_OK_PHOTO} of the frames")
    if res["n_loops_closed"] < GATE_MIN_LOOPS_PHOTO:
        fails.append(f"{res['n_loops_closed']} loops closed < {GATE_MIN_LOOPS_PHOTO}")
    if not res["finite"]:
        fails.append("non-finite or misshaped poses")
    if not res["idle_after_flush"]:
        fails.append("the scheduler busy after flush")
    _launch_gate(res, fails)
    if fails:
        raise RuntimeError("photo failed: " + "; ".join(fails))
    return res


def _assign_check(rng):
    """K1's assignment (vocab/train.py::_assign_cuda: one fused-match launch,
    the nearest of k <= 10 centres) against the plain assignment on the card,
    exactly, at the trainer's shapes: the default vocabulary's root, a
    million descriptors (a grid of 62,500 row tiles) and a ragged one."""
    import torch

    from os1_tpu_torch.ops import hamming
    from os1_tpu_torch.vocab import train

    rows = []
    for m, k in ASSIGN_SHAPES:
        words = torch.as_tensor(_words(rng, (m, 8)).view(np.int32), device="cuda")
        centres = words[torch.as_tensor(rng.choice(m, k, replace=False), device="cuda")]
        centres[1:] ^= 1 << 7  # one bit from a descriptor: ties and near ties
        shifts = torch.arange(32, dtype=torch.int32, device="cuda")
        bits = ((words[..., None] >> shifts) & 1).reshape(m, 256).to(torch.uint8)
        cbits = ((centres[..., None] >> shifts) & 1).reshape(k, 256).to(torch.uint8)
        got = train._assign_cuda(words, centres)
        want = train._assign(bits, cbits)
        err = int((got != want).sum())
        row = dict(shape=[m, k], mismatches=err, max_abs_err=float(err))
        row.update(_timings(lambda: train._assign_cuda(words, centres),
                            lambda: train._assign(bits, cbits)))
        # Bytes: the descriptors and centres read once, idx, dist, ok and
        # second written; operations: a 256-bit AND and popcount a pair.
        row.update(_bound(m * 32 + k * 32 + m * 17, 2 * m * k * hamming.BITS))
        log(f"[vocab] K1 assignment [{m},{k}]: {err} mismatches; {_fmt_k1(row)}")
        if err:
            raise RuntimeError(f"vocab: K1's assignment disagrees at [{m},{k}]")
        rows.append(row)
    return rows


def phase_vocab(device="cuda"):
    """Vocabulary training on the card: (a) training_descriptors() on the
    card against the CPU extractor (the valid lanes, exactly); (b)
    build_vocabulary(k=10, L=4) on them on the card (K1 assigns) and on the
    CPU (the plain assignment): identical in every array; K1's assignment at
    the trainer's shapes against the plain one; (c) whether the result's
    binary equals the committed os1_tpu/data/default_vocab.bin (reported);
    (d) a training_corpus of 120 images at 480x640 through the host C++
    trainer (k=10, L=5): images/s, training seconds, nodes and words, the
    kernel launches, and bow.compute at that size."""
    from os1_tpu_torch.vocab import dbow2, train
    from os1_tpu_torch.vocab.database import KeyFrameDatabase

    counters = _counters()
    out = {}
    _reset_counts(counters)
    t0 = time.perf_counter()
    descs, docs = train.training_descriptors(device=device)
    t_card = time.perf_counter() - t0
    launches_a = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    descs_cpu, docs_cpu = train.training_descriptors(device="cpu")
    t_cpu = time.perf_counter() - t0
    same = descs.shape == descs_cpu.shape and bool(
        np.array_equal(descs, descs_cpu) and np.array_equal(docs, docs_cpu))
    out["descriptors"] = dict(n=len(descs), n_cpu=len(descs_cpu), identical=same,
                              card_s=t_card, cpu_s=t_cpu, launches=launches_a)
    log(f"[vocab] training_descriptors(): {len(descs)} valid descriptors from 40 textures "
        f"(240x320, 4 levels) on the card in {t_card:.3f}s, {len(descs_cpu)} on the CPU in "
        f"{t_cpu:.3f}s; identical {same}; launches {launches_a}")
    if not same:
        raise RuntimeError("vocab: the card's training descriptors differ from the CPU's")

    kw = dict(VOCAB_DEFAULT, n_docs=int(docs.max()) + 1, doc_ids=docs)
    _reset_counts(counters)
    t0 = time.perf_counter()
    v_card = train.build_vocabulary(descs, device=device, **kw)
    _sync(device)
    t_card = time.perf_counter() - t0
    launches_b = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    v_cpu = train.build_vocabulary(descs, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    fields = ("node_desc", "node_children", "node_weight", "node_word")
    equal = {f: bool(np.array_equal(getattr(v_card, f), getattr(v_cpu, f))) for f in fields}
    equal.update(n_words=v_card.n_words == v_cpu.n_words)
    out["build"] = dict(nodes=len(v_card.node_desc), words=v_card.n_words, card_s=t_card,
                        cpu_s=t_cpu, equal=equal, launches=launches_b)
    log(f"[vocab] build_vocabulary(k=10, L=4): {len(v_card.node_desc)} nodes, {v_card.n_words} "
        f"words; on the card (K1 assigns) {t_card:.3f}s with launches {launches_b}, on the CPU "
        f"(plain) {t_cpu:.3f}s; identical arrays {equal}")
    if not all(equal.values()):
        raise RuntimeError(f"vocab: the card's vocabulary differs from the CPU's: {equal}")
    if device == "cuda":
        if launches_b["gated_match_cuda"] <= 0:
            raise RuntimeError("vocab: K1 never launched while training on the card")
        out["assign"] = _assign_check(np.random.default_rng(5))

    tmp = tempfile.mkdtemp(prefix="os1_vocab_")
    try:
        path = os.path.join(tmp, "default_vocab.bin")
        dbow2.save_binary(v_card, path)
        mine = open(path, "rb").read()
        ref = open(os.path.join(dbow2.DATA_DIR, "default_vocab.bin"), "rb").read()
        recs = lambda b: [b[i:i + 45] for i in range(4, len(b), 45)]  # noqa: E731
        a, b = recs(mine), recs(ref)
        share = sum(x == y for x, y in zip(a, b)) / max(len(a), len(b))
        out["committed"] = dict(identical=mine == ref, bytes=len(mine), bytes_committed=len(ref),
                                equal_record_share=share, header_equal=mine[:4] == ref[:4])
        log(f"[vocab] its binary against the committed os1_tpu/data/default_vocab.bin (trained "
            f"on another device; reported, not gated): identical {mine == ref}; {len(mine)} "
            f"against {len(ref)} bytes; {share:.4f} of the 45-byte records equal")

        _reset_counts(counters)
        t0 = time.perf_counter()
        cdescs, cdocs = train.training_corpus(VOCAB_CORPUS_IMAGES, VOCAB_CORPUS_FEATURES,
                                              device=device)
        t_corpus = time.perf_counter() - t0
        launches_d = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        big = train.build_vocabulary_native(cdescs, n_docs=int(cdocs.max()) + 1, doc_ids=cdocs,
                                            **VOCAB_NATIVE)
        t_train = time.perf_counter() - t0
        bpath = os.path.join(tmp, "corpus_vocab.bin")
        dbow2.save_binary(big, bpath)
        db = KeyFrameDatabase(dbow2.load_binary(bpath), MAP_KEYFRAMES)
        sample = cdescs[np.random.default_rng(0).choice(len(cdescs), N_FEATURES, replace=False)]
        valid = np.ones(len(sample), bool)
        db.compute_bow(sample, valid)
        ts = []
        for _ in range(21):
            t0 = time.perf_counter()
            db.compute_bow(sample, valid)
            ts.append(time.perf_counter() - t0)
        out["corpus"] = dict(images=VOCAB_CORPUS_IMAGES, descriptors=len(cdescs),
                             corpus_s=t_corpus, images_per_s=VOCAB_CORPUS_IMAGES / t_corpus,
                             train_s=t_train, nodes=len(big.node_desc), words=big.n_words,
                             launches=launches_d, compute_bow_ms=float(np.median(ts) * 1e3),
                             bytes=os.path.getsize(bpath))
        log(f"[vocab] training_corpus({VOCAB_CORPUS_IMAGES}) at 480x640, "
            f"{VOCAB_CORPUS_FEATURES} features: {len(cdescs)} descriptors in {t_corpus:.3f}s "
            f"({out['corpus']['images_per_s']:.3f} images/s, rendering included) with launches "
            f"{launches_d}; build_vocabulary_native(k=10, L=5) {t_train:.3f}s: "
            f"{len(big.node_desc)} nodes, {big.n_words} words; bow.compute of {N_FEATURES} "
            f"descriptors {out['corpus']['compute_bow_ms']:.3f} ms (median of 21)")
        for k in ("extract_patches_cuda", "sample_patches_cuda"):
            if device == "cuda" and (launches_d[k] < VOCAB_CORPUS_IMAGES or launches_a[k] <= 0):
                raise RuntimeError(f"vocab: {k} not launched on every corpus image")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: launches_a[k] + launches_b[k] + launches_d[k] for k in counters}
    return out


def _run_cli(args, timeout=600):
    """One ``python3 -m os1_tpu_torch.run_slam`` process from this checkout:
    (exit code, seconds, stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "os1_tpu_torch.run_slam", *args], cwd=here,
                          env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, time.perf_counter() - t0, proc.stdout, proc.stderr


def _summary(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def phase_cli():
    """The user's entry point as a subprocess on the card, in its threaded
    default: the synthetic orbit (CLI_FRAMES frames, writing the trajectory
    and the map), the map reloaded in localization mode (CLI_LOC_FRAMES
    frames: it relocalizes, tracks, and the map's counts stay), and --warmup
    in a process beside those two."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="os1_cli_")
    side = ThreadPoolExecutor(1)
    warm = side.submit(_run_cli, ["--warmup"])
    try:
        traj, base = os.path.join(tmp, "kf_traj.txt"), os.path.join(tmp, "map")
        rc, secs, out, err = _run_cli(["--synthetic", "--frames", str(CLI_FRAMES),
                                       "--save-trajectory", traj, "--save-map", base])
        run = _summary(out)
        log(f"[cli] run_slam --synthetic --frames {CLI_FRAMES}: exit {rc} in {secs:.1f}s; {run}")
        fails = []
        if rc != 0 or run is None:
            raise RuntimeError(f"cli: run_slam failed (exit {rc}): {err[-2000:]}")
        if run["frames"] != CLI_FRAMES or run["final_state"] != "OK":
            fails.append(f"frames {run['frames']}, final state {run['final_state']}")
        if run["tracked_fraction"] < GATE_CLI_TRACKED:
            fails.append(f"tracked fraction {run['tracked_fraction']} < {GATE_CLI_TRACKED}")
        if "ate_rmse_vs_groundtruth" not in run:
            fails.append("no ATE against the ground truth")
        rows = [ln.split() for ln in open(traj)] if os.path.exists(traj) else []
        files = {ext: os.path.getsize(base + ext) if os.path.exists(base + ext) else None
                 for ext in (".yaml", ".keyframes", ".mappoints", ".features")}
        if len(rows) != run["keyframes"] or any(len(r) != 8 for r in rows):
            fails.append(f"trajectory file: {len(rows)} rows for {run['keyframes']} keyframes")
        if None in files.values():
            fails.append(f"map files missing: {files}")
        log(f"[cli] trajectory {len(rows)} keyframe rows; map files (bytes) {files}")

        rc, secs2, out, err = _run_cli(["--synthetic", "--frames", str(CLI_LOC_FRAMES),
                                        "--load-map", base + ".yaml", "--localization"])
        loc = _summary(out)
        log(f"[cli] run_slam --load-map --localization --frames {CLI_LOC_FRAMES}: exit {rc} in "
            f"{secs2:.1f}s; {loc}")
        if rc != 0 or loc is None:
            raise RuntimeError(f"cli: the localization run failed (exit {rc}): {err[-2000:]}")
        if loc["frames"] != CLI_LOC_FRAMES or loc["final_state"] != "OK" or \
                loc["tracked_fraction"] <= 0:
            fails.append(f"localization run: {loc}")
        if (loc["keyframes"], loc["map_points"]) != (run["keyframes"], run["map_points"]):
            fails.append("the frozen map's counts changed")

        rc, secs3, out, err = warm.result()
        log(f"[cli] run_slam --warmup: exit {rc} in {secs3:.1f}s; {out.strip()}")
        lines = out.splitlines()
        if rc != 0 or len(lines) < 2 or not lines[0].startswith("warmup: 4 libraries ready") \
                or not lines[1].startswith("warmup: System.warmup() in "):
            fails.append(f"--warmup: exit {rc}, {out.strip()} {err[-500:]}")
        if fails:
            raise RuntimeError("cli failed: " + "; ".join(fails))
        return dict(run=run, run_s=secs, localization=loc, localization_s=secs2, warmup_s=secs3,
                    trajectory_rows=len(rows), map_bytes=files)
    finally:
        side.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)


SCENES = ("orbit", "loop", "photo")
RENDER_WORKERS = 6  # processes rendering the sequences beside the card's phases


def _scene_and_poses(kind, n_frames):
    """bench.py's three sequences: the orbit (default_scene(seed=1)), the loop
    circuit in the room (room_scene(seed=3)) and in the photo room."""
    from os1_tpu_torch.io import realimg, synthetic

    if kind == "orbit":
        return synthetic.default_scene(seed=1), synthetic.orbit_trajectory(n_frames, advance=0.05)
    scene = synthetic.room_scene(seed=3) if kind == "loop" else realimg.photo_room_scene()
    return scene, synthetic.loop_trajectory(n_frames)


def _render_chunk(kind, n_frames, lo, hi, K, h, w):
    from os1_tpu_torch.io import synthetic

    scene, poses = _scene_and_poses(kind, n_frames)
    return synthetic.render_sequence(scene, poses[lo:hi], K, h, w)


class Renderer:
    """Renders sequences in worker processes (spawned, so no CUDA state is
    inherited), chunked over ``RENDER_WORKERS``; :meth:`submit` starts a
    sequence and :meth:`get` waits for it. A context manager: leaving it
    stops every worker."""

    def __init__(self, workers=RENDER_WORKERS):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
        self.workers = workers
        self.jobs = {}

    def submit(self, kind, n_frames):
        step = -(-n_frames // (2 * self.workers))
        futs = [self.pool.submit(_render_chunk, kind, n_frames, lo, min(lo + step, n_frames),
                                 BENCH_K, H, W) for lo in range(0, n_frames, step)]
        self.jobs[(kind, n_frames)] = (time.perf_counter(), futs)

    def get(self, kind, n_frames):
        if (kind, n_frames) not in self.jobs:
            self.submit(kind, n_frames)
        t0, futs = self.jobs.pop((kind, n_frames))
        t1 = time.perf_counter()
        frames = np.concatenate([f.result() for f in futs])
        _, poses = _scene_and_poses(kind, n_frames)
        log(f"[render] {kind}: {n_frames} frames {H}x{W}, {time.perf_counter() - t0:.3f}s since "
            f"submitted on {self.workers} processes, waited {time.perf_counter() - t1:.3f}s")
        return frames, poses

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for _, futs in self.jobs.values():
            for f in futs:
                f.cancel()
        self.pool.shutdown(wait=True, cancel_futures=True)
        return False


def _render_here(kind, n_frames):
    from os1_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    scene, poses = _scene_and_poses(kind, n_frames)
    frames = synthetic.render_sequence(scene, poses, BENCH_K, H, W)
    log(f"[render] {kind}: {n_frames} frames {H}x{W} in {time.perf_counter() - t0:.3f}s")
    return frames, poses


def render_loop(n_frames):
    return _render_here("loop", n_frames)


def render(n_frames):
    return _render_here("orbit", n_frames)


def render_photo(n_frames):
    return _render_here("photo", n_frames)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="write every number of the run to this file")
    parser.add_argument("--warmup-pass", metavar="NPZ", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.warmup_pass:  # [warmup]'s pass, in a process of its own
        return _warmup_pass(args.warmup_pass, args.json)

    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    out = dict(device=name, nvidia_smi=smi)
    with Renderer() as renders:  # bench.py's sequences, rendered beside the first phases
        for kind, n in (("orbit", N_FRAMES), ("orbit", N_FRAMES_MAP), ("loop", N_FRAMES_LOOP),
                        ("photo", N_FRAMES_PHOTO)):
            renders.submit(kind, n)
        out["build_s"] = phase_build()
        out["hamming"] = phase_kernel()
        out["match"] = phase_match()
        out["patches"] = phase_patches()

        frames, poses = renders.get("orbit", N_FRAMES)
        out["slice"] = phase_slice(frames, poses)
        out["extractor_agreement"] = phase_extractor_agreement(frames)

        frames, poses = renders.get("orbit", N_FRAMES_MAP)
        loop_frames, loop_poses = renders.get("loop", N_FRAMES_LOOP)
        photo_frames, photo_poses = renders.get("photo", N_FRAMES_PHOTO)
    out["mapping"], _ = phase_mapping(frames, poses)
    out["bow"] = phase_bow(frames)
    out["coop"], sys2 = phase_coop(frames, poses)
    out["reloc"] = phase_reloc(sys2, frames)
    del sys2
    out["orbit_loop"], sys_o = phase_orbit_loop(frames, poses)
    out["threaded_orbit"] = phase_threaded("orbit", frames, poses, out["orbit_loop"])

    frames, poses = loop_frames, loop_poses
    out["loop"], sys_a = phase_loop(frames, poses)
    out["warmup"] = phase_warmup(frames, poses, out["loop"])
    out["threaded_loop"] = phase_threaded("loop", frames, poses, out["loop"]["first"])
    out["osmap"] = phase_osmap(sys_a, sys_o, frames, poses)
    out["mesh"] = phase_mesh(frames, poses, sys_a, out["loop"])
    del sys_a, sys_o, frames, loop_frames
    out["photo"] = phase_photo(photo_frames, photo_poses)
    del photo_frames
    out["vocab"] = phase_vocab()
    out["cli"] = phase_cli()
    out["seconds"] = time.perf_counter() - t_start

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)

    # This slice's paths are the photo room and vocabulary training; the
    # threaded loop pass (run_slam's default mode) is listed beside them.
    by_path = dict(photo=out["photo"]["launches"], vocab=out["vocab"]["launches"],
                   threaded_loop=out["threaded_loop"]["launches"])
    big = next(r for r in out["hamming"] if r["shape"] == [4096, 1024])
    fused = next(r for r in out["match"] if r["batch"] == 1 and r["shape"] == [4096, 1024])
    p1 = next(r for r in out["patches"]["p1"] if r["n"] == 1024)
    p2 = next(r for r in out["patches"]["p2"] if r["n"] == 1024)

    def entry(name, source, replaces, row, rows):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=by_path["photo"][name] + by_path["vocab"][name],
                    launches_by_path={k: v[name] for k, v in by_path.items()},
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])

    kernels = [
        entry("gated_match_cuda", "os1_tpu_torch/csrc/hamming.cu",
              "os1_tpu/ops/pallas_hamming.py:37", fused, out["match"] + out["vocab"]["assign"]),
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
