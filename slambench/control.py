"""The readings that the limits of ``slambench/limits/<cell>.json`` are set
from, for one cell on the card, all seeds in one process:

    python3 slambench/control.py --workload tum1.orbit --seeds 11 12 13 --json OUT

For each seed it renders the traffic, resets the program's shipped system
(built and warmed up once), runs one whole session through
``System.track_monocular`` as the window does, flushes it, and reads the
four numbers of ``check.py`` on what the session left:

- ``program``: the program as it runs (the lower readings);
- ``control``: the plain reference put in the program's place one precision
  below the configuration's: the extractor's float32 stages in bfloat16, the
  poses and map points held in bfloat16;
- ``frozen``: the fault "a step that returns its state unchanged": every
  tracked frame and keyframe left at the session's first pose;
- ``half``: the fault "half of the batch left out": the second half of
  every keyframe's feature lanes dropped;
- ``altered``: the fault "an answer altered where it is produced": one bit
  of every descriptor flipped;
- ``no_ba``: the fault "a step that returns its state unchanged" in local
  mapping: a second session on the same frames with the local BA's result
  never applied, so keyframe poses and points stay as tracking and
  triangulation left them.

There is one card, so the fault "the exchange between chips left out" has
no place in these cells. The benchmark's own runs never run this script.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from slambench import cells, check, harness, traffic  # noqa: E402


def bf16(a):
    import torch

    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def frozen(sn):
    """Every pose left at the session's first tracked pose."""
    T0 = sn.frame_T[min(sn.frame_T)] if sn.frame_T else np.eye(4)
    return dataclasses.replace(sn, frame_T={i: T0 for i in sn.frame_T},
                               kf_T=np.broadcast_to(T0, sn.kf_T.shape).copy())


def half(sn):
    valid = sn.kf_valid.copy()
    valid[:, valid.shape[1] // 2:] = False
    return dataclasses.replace(sn, kf_valid=valid)


def altered(sn):
    return dataclasses.replace(sn, kf_desc=sn.kf_desc ^ np.uint32(1))


@contextlib.contextmanager
def local_ba_skipped():
    """The mapper's local BA hands back its input: its result is dropped."""
    from os1_tpu_torch.pipeline.local_mapping import LocalMapper

    apply = LocalMapper._local_ba_apply
    LocalMapper._local_ba_apply = lambda self, res, meta: None
    try:
        yield
    finally:
        LocalMapper._local_ba_apply = apply


def session(sys_, seq):
    """One whole session of ``seq`` on a reset system: (its snapshot, the
    frames lost after its first OK frame)."""
    sys_.reset()
    drv = harness.Feeder(sys_, seq, fid0=sys_.tracker.frame_id)
    drv.open_window()
    for _ in range(len(seq.frames) - 1):
        drv.feed()
    drv.feed()  # the last frame ends the session: flush, snapshot, reset
    return drv.snapshots[-1], drv.failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    cfg = cells.load_config(cell["config"])
    mix = traffic.for_config(traffic.load(cell["traffic"]), cfg)
    sys_ = cells.build_system(cfg, args.device)
    sys_.warmup()
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        seq = traffic.generate(mix, cells.camera(cfg), seed, args.device)
        sn, failed = session(sys_, seq)
        row = dict(seed=seed, failed=failed,
                   program=check.numbers([(sn, seq)], cfg, args.device),
                   control=check.numbers([(sn, seq)], cfg, args.device, "bfloat16", state=bf16))
        for name, fault in (("frozen", frozen), ("half", half), ("altered", altered)):
            row[name] = check.numbers([(fault(sn), seq)], cfg, args.device)
        with local_ba_skipped():
            sn_no_ba, row["no_ba_failed"] = session(sys_, seq)
        row["no_ba"] = check.numbers([(sn_no_ba, seq)], cfg, args.device)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(0)
               if torch.cuda.is_available() else "cpu", rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
