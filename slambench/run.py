"""Run one cell of the benchmark once, on the card this process is started
on, and print its result as the last line of standard output:

    python3 slambench/run.py --workload tum1.orbit --seed 1234 --seconds 45 --trace 0

The cell (``BENCHMARK.json``) names a configuration
(``slambench/configs/<config>.json``) and a traffic mix
(``slambench/traffic/<traffic>.json``). Set-up renders the mix's frames on
the card from the seed, builds the program's shipped system
(``os1_tpu_torch``: pipelined tracking, cooperative mapping, loop closing
on), runs ``System.warmup()`` and tracks the frames the mix pre-tracks. The
window then feeds frames to ``System.track_monocular`` for ``--seconds``.
``--trace 1`` adds a ``torch.profiler`` trace of a stretch of the window and
reports the per-layer metrics instead of the end-to-end ones. After the
window the plain reference under ``slambench/reference/`` checks what the
window produced (``slambench/check.py``), and each number compared is
printed with its limit.

Exits 2 without a result where no card is present, and 3 where a module of
JAX or of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import os


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    import time

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = {"jax", "jaxlib", "flax", "os1_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``os1_tpu_torch`` is the port's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(bench: dict, cell: dict, trace: bool, win, checked, device: dict) -> dict:
    from slambench import cells

    metrics = {}
    for m in cells.metrics_of(bench, cell, trace):
        value = cells.load_metric(m["name"]).read(win)
        if value is None:
            log(f"[metric] {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": checked.correct, "attempted": win.frames, "failed": win.failed,
           "metrics": metrics, "device": device}
    if trace and win.trace is not None:
        s = win.trace
        device.update(busy_s=s.busy_s, window_s=s.window_s)
        out["breakdown"] = {"device_ops": [[n, t] for n, t in s.device_ops],
                            "idle_gaps": [[n, t] for n, t in s.idle_gaps]}
    out["checks"] = checked.report()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from slambench import cells, harness, traffic

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(4)
    cfg, mix = cells.load_config(cell["config"]), traffic.load(cell["traffic"])
    win, checked, device = harness.run_cell(cell, cfg, mix, args.seed, args.seconds,
                                            bool(args.trace), "cuda", T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"no result: modules of JAX or of the JAX package are loaded: {', '.join(bad)}")
        return 3
    out = result_line(bench, cell, bool(args.trace), win, checked, device)
    for line in checked.lines():
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
