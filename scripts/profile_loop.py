"""What loop closing costs on the card: the Sim3 candidate program and the
essential graph, on bench.py's loop sequence in the shipped mode.

    python3 scripts/profile_loop.py [--candidate 10] [--no-scale-guard]
        [--materialize-before-correction] [--json PATH]

Tracks bench.py's 300-frame loop sequence once at the bench configuration
with loop closing on. The ``--candidate``-th Sim3 candidate program is timed
three ways: its host time with the card synchronised before and after, the
same under torch.profiler, and the profiler's device time and device-side
event count (kernels and copies). Its snapshot's copy to the card is timed
two ways, one pageable copy per array and the packed single copy
(``utils/transfer.upload``): with the card idle, and the time until the call
returns with about 10 ms of work queued ahead. At the loop correction it prints the
tracker's state (its reference keyframe, the keyframes not yet
materialized, the remapped last pose). After the run it profiles the
essential graph's 20 LM iterations on the final map with its spanning-tree
edges, twice. It prints every Sim3 candidate's scale-guard reading.
``--no-scale-guard`` runs the sequence without the port's Sim3 scale guard
(``loop_closing.MAX_LM_SCALE_CHANGE``), as the reference package accepts.
``--materialize-before-correction`` materializes the keyframes still waiting
for their feature arrays right before the correction, so that it sees every
keyframe complete. The states of the frames after the correction are
printed. Needs a CUDA device; the numbers are the card's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the bench configuration and the loop sequence)


def _device_ms(prof) -> tuple[float, int]:
    """Device time (ms) and device-side event count of a profile."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in events) / 1e3,
            int(sum(e.count for e in events)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--candidate", type=int, default=10)
    parser.add_argument("--no-scale-guard", action="store_true")
    parser.add_argument("--materialize-before-correction", action="store_true")
    parser.add_argument("--json", help="write the numbers to this file")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = dict(device=smi, scale_guard=not args.no_scale_guard,
               materialize_before_correction=args.materialize_before_correction)
    if args.no_scale_guard:
        from os1_tpu_torch.pipeline import loop_closing

        loop_closing.MAX_LM_SCALE_CHANGE = math.inf
    from os1_tpu_torch.map.mirror import to_device
    from os1_tpu_torch.utils import transfer

    big = torch.randn(4096, 4096, device="cuda")

    def upload_ms(fn, queued: bool) -> float:
        """Best of five: host time of ``fn`` from an idle card to the end of
        its copy, or (queued) until ``fn`` returns behind queued work."""
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            if queued:
                for _ in range(4):
                    big @ big
            t0 = time.perf_counter()
            fn()
            if not queued:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return min(times)

    frames, poses = chip_smoke.render_loop(chip_smoke.N_FRAMES_LOOP)
    sys_ = chip_smoke.build_system("cuda", mapping=True, shipped=True, loop=True)
    tr, lc = sys_.tracker, sys_.loop_closer
    dispatch, calls = lc._dispatch_sim3, [0]

    def profiled_dispatch(snap):
        calls[0] += 1
        if calls[0] != args.candidate:
            return dispatch(snap)
        # The same program three times on the same draw (the sampler's state
        # restored each time), so the run goes on as an unprofiled one would.
        separate = lambda: {k: to_device(v, "cuda") for k, v in snap.items()}  # noqa: E731
        packed = lambda: transfer.upload(snap, "cuda")  # noqa: E731
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            big @ big
        torch.cuda.synchronize()
        out["upload"] = dict(
            arrays=len(snap), bytes=int(sum(v.nbytes for v in snap.values())),
            queued_work_ms=(time.perf_counter() - t0) * 1e3,
            separate_idle_ms=upload_ms(separate, False), packed_idle_ms=upload_ms(packed, False),
            separate_behind_queue_ms=upload_ms(separate, True),
            packed_behind_queue_ms=upload_ms(packed, True))
        print(f"[upload] candidate {args.candidate}: {out['upload']}", flush=True)
        gen = lc.sampler.generator
        draw = gen.get_state()
        dispatch(snap)
        torch.cuda.synchronize()
        gen.set_state(draw)
        t0 = time.perf_counter()
        dispatch(snap)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        gen.set_state(draw)
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            res = dispatch(snap)
            torch.cuda.synchronize()
        dev_ms, events = _device_ms(prof)
        out["sim3"] = dict(host_ms=host_ms, profiled_host_ms=(time.perf_counter() - t0) * 1e3,
                           device_ms=dev_ms, device_events=events)
        print(f"[sim3] candidate {args.candidate}: {host_ms:.3f} ms of host time "
              f"(synchronised), {dev_ms:.3f} ms of device time, {events} device-side "
              f"events", flush=True)
        return res

    lc._dispatch_sim3 = profiled_dispatch
    corrected = sys_._after_loop_correction

    def report_correction():
        corrected()
        st, r = sys_.store, tr.ref_kf
        obs = st.kf_obs_point[r]
        out["correction"] = dict(
            frame=tr.frame_id, ref_kf=r, ref_parent=int(st.kf_parent[r]),
            not_materialized=sorted(int(k) for k in sys_._pending_frames),
            ref_live_points=int(((obs >= 0) & st.pt_valid[np.clip(obs, 0, None)]).sum()),
            last_to_ref_t=float(np.linalg.norm((tr.last.Tcw @ np.linalg.inv(st.kf_T[r]))[:3, 3])))
        print(f"[correction] {out['correction']}", flush=True)

    sys_.loop_closer.on_corrected = report_correction
    if args.materialize_before_correction:
        correct = lc.correct

        def correct_materialized(*a):
            waiting = sorted(sys_._pending_frames)
            for k in waiting:
                sys_._materialize_kf(k)
            print(f"[correction] materialized {waiting} before it", flush=True)
            return correct(*a)

        lc.correct = correct_materialized
    states = []
    for i, img in enumerate(frames):
        states.append(sys_.track_monocular(img, timestamp=i / 30.0)[0].name)
    sys_.flush()
    if "correction" in out:
        c = out["correction"]["frame"] - 1  # the frame whose step ran the correction
        out["after_correction"] = states[c:c + 7]
        print(f"[correction] states of frames {c}..{c + 6}: {out['after_correction']}", flush=True)
    torch.cuda.synchronize()
    traj = sys_.frame_trajectory()
    from os1_tpu_torch.io import synthetic

    guard = chip_smoke._scale_guard(lc)
    for r in guard["rows"]:
        print(f"[sim3] {r}", flush=True)
    out["run"] = dict(loss_log=[list(map(str, e)) for e in tr.loss_log],
                      loop_edges=[list(e) for e in lc.loop_edges],
                      scale_guard=guard,
                      ate=synthetic.ate_rmse([T for _, _, T in traj],
                                             [poses[f] for _, f, _ in traj]))
    print(f"[run] {dict((k, v) for k, v in out['run'].items() if k != 'scale_guard')}; "
          f"scale guard: {dict((k, v) for k, v in guard.items() if k != 'rows')}", flush=True)

    from os1_tpu_torch.optim.pose_graph import optimize_pose_graph

    st = sys_.store
    K = st.cfg.max_keyframes
    live = np.nonzero(st.kf_valid)[0]
    S = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    S[live] = st.kf_T[live]
    child = [int(i) for i in live if st.kf_parent[i] >= 0 and st.kf_valid[st.kf_parent[i]]]
    ei = np.array([int(st.kf_parent[i]) for i in child])
    ej = np.array(child)
    eS = np.einsum("eij,ejk->eik", S[ej], np.linalg.inv(S[ei])).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[live[0]] = True
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    inputs = (d(S), d(st.kf_valid), d(fixed), d(ei), d(ej), d(eS))
    out["essential"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_pose_graph(*inputs, iters=20)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            optimize_pose_graph(*inputs, iters=20)
            torch.cuda.synchronize()
        dev_ms, events = _device_ms(prof)
        row = dict(edges=len(ei), nodes=K, host_ms=host_ms, device_ms=dev_ms,
                   device_events=events)
        out["essential"].append(row)
        print(f"[essential] {row}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
