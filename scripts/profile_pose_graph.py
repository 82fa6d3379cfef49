"""The pose solve (K6) on the card, eager against its CUDA graph replay.

    python3 scripts/profile_pose_graph.py [--n 1024 2048] [--reps 40] [--json PATH]

For each observation count N and each schedule (the shipped damped
Gauss-Newton 3 x 4 and the reference's LM 4 x 10 with accept/reject), on one
synthetic problem (``tests/test_torch_pose_graph.py``'s): whether the replay
equals the eager loop bit for bit; the host ms a call (enqueue, no
synchronise) and the wall ms a call ending in a synchronise; under
``torch.profiler``, the device ms a solve (the sum of its kernels) and its
kernel count; and the solve's lower bound, the larger of the bytes its
normal-system evaluations read at 3.35 TB/s and their float32 operations at
67 TFLOP/s. Needs a CUDA device; the numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# One normal-system evaluation an observation: the point, pixel, sigma2 and
# mask read once (12 + 8 + 4 + 1 bytes); transform, projection, residual,
# the 2 x 6 Jacobian, the Huber weight and cost, J^T W J (21 entries of the
# symmetric 6 x 6, 2 rows) and J^T W r: some 200 float operations.
BYTES_PER_OBS, FLOPS_PER_OBS = 25, 200


def evaluations(rounds: int, iters: int, accept_reject: bool) -> int:
    """Normal-system evaluations a solve: one an iteration (two with
    accept/reject) and one a round for the chi2 reclassification."""
    return rounds * (iters * (2 if accept_reject else 1) + 1)


def _device_ms(fn, reps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "CUDA" in str(e.device_type()) and not e.name().startswith(("Memcpy", "Memset"))]
    return sum(e.duration_ns() for e in kernels) * 1e-6 / reps, len(kernels) / reps


def _host_ms(fn, reps: int, sync: bool) -> float:
    import torch

    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    t.sort()
    return t[len(t) // 2] * 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[1024, 2048])
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--json", help="write the numbers to this file")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)

    from os1_tpu_torch.optim import pose_opt

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_pose_graph import _problem

    rows = []
    for n in args.n:
        for sched in ((3, 4, False), (4, 10, True)):
            prob = _problem(n, seed=n, device="cuda")
            kw = dict(zip(("rounds", "iters_per_round", "accept_reject"), sched))
            graph = lambda: pose_opt.optimize_pose(*prob, **kw)  # noqa: E731
            eager = lambda: pose_opt._optimize_pose_eager(*prob, *sched)  # noqa: E731
            g, e = graph(), eager()  # the first graph call captures
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(g, e))
            row = dict(n=n, schedule=list(sched), bit_equal=equal)
            for name, fn in (("eager", eager), ("graph", graph)):
                row[f"{name}_host_ms"] = _host_ms(fn, args.reps, sync=False)
                row[f"{name}_wall_ms"] = _host_ms(fn, args.reps, sync=True)
                row[f"{name}_device_ms"], row[f"{name}_kernels"] = _device_ms(fn, args.reps)
            ev = evaluations(*sched)
            row["bound_ms"] = max(ev * n * BYTES_PER_OBS / HBM_BPS,
                                  ev * n * FLOPS_PER_OBS / F32_FLOPS) * 1e3
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
