"""Reference-scale vocabulary training with the port (vocab_1m's recipe),
then the vocabulary check on real photographs.

1. Writes ``--shards`` corpus shards of ``--images`` images each, ``--parallel``
   processes at a time: ``python3 -m os1_tpu_torch.vocab.train --shard I
   --n-shards N --images M --shard-dir D`` (each shard
   ``training_corpus(M, 1024, seed=1000 + 77 I)``, the seeds of
   scripts/gen_vocab_corpus.py; P1 and P2 on the card).
2. Trains from them: ``python3 -m os1_tpu_torch.vocab.train --from-shards D
   --native --depth 6 --iters 6 --seed 0 --out OUT`` (the host C++ trainer,
   k=10, L=6: scripts/train_vocab_1m.py's recipe).
3. Runs ``vocab/validate.py``'s ``validate()`` on OUT and on the shipped
   ``os1_tpu/data/vocab_1m.bin`` over the photo room's 24 views.

Shards (``_build/vocab_shards/{N}x{M}/``) and the binary
(``_build/vocab_k10_L6.bin``) go under ``os1_tpu_torch/_build/`` (gitignored);
an existing shard is kept. Prints every process's output, the card's name and
power limit, and with ``--json`` writes the numbers.

    python3 scripts/vocab_reference_scale.py [--shards 4] [--images 1500]
        [--parallel 4] [--device cpu] [--json PATH]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _module(args, device):
    cmd = [sys.executable, "-m", "os1_tpu_torch.vocab.train", *args]
    return cmd + (["--device", device] if device else [])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--images", type=int, default=1500)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import numpy as np

    from os1_tpu_torch.ops.cuda_build import BUILD_DIR, reset_launches
    from os1_tpu_torch.ops.patches import extract_patches_cuda, sample_patches_cuda
    from os1_tpu_torch.vocab import dbow2, validate

    # One directory a corpus: --from-shards trains from every shard in it.
    shard_dir = os.path.join(BUILD_DIR, "vocab_shards", f"{args.shards}x{args.images}")
    out_bin = os.path.join(BUILD_DIR, "vocab_k10_L6.bin")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    smi = None
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(smi.strip(), flush=True)
    res = dict(nvidia_smi=smi, shards=args.shards, images_per_shard=args.images, shard_runs=[])

    # 1. The shards, --parallel processes at a time.
    t0 = time.perf_counter()
    todo = list(range(args.shards))
    while todo:
        batch, todo = todo[:args.parallel], todo[args.parallel:]
        procs = [(i, subprocess.Popen(
            _module(["--shard", str(i), "--n-shards", str(args.shards), "--images",
                     str(args.images), "--shard-dir", shard_dir], args.device),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for i in batch]
        for i, p in procs:
            out, err = p.communicate()
            print(out.strip(), flush=True)
            if p.returncode != 0:
                print(err[-3000:], file=sys.stderr)
                return 1
            m = re.search(r"(\d+) descs from (\d+) images in ([\d.]+)s \(([\d.]+) images/s; "
                          r"launches P1 (\d+), P2 (\d+)\)", out)
            res["shard_runs"].append(dict(shard=i, line=out.strip(), **(dict(
                descriptors=int(m[1]), images=int(m[2]), seconds=float(m[3]),
                images_per_s=float(m[4]), p1=int(m[5]), p2=int(m[6])) if m else {})))
    res["corpus_s"] = time.perf_counter() - t0
    res["images_per_s"] = args.shards * args.images / res["corpus_s"]
    print(f"corpus: {args.shards} shards of {args.images} images in {res['corpus_s']:.3f}s "
          f"({res['images_per_s']:.3f} images/s over {min(args.parallel, args.shards)} "
          f"processes)", flush=True)

    # 2. Training, vocab_1m's recipe.
    t0 = time.perf_counter()
    p = subprocess.run(_module(["--from-shards", shard_dir, "--native", "--depth", "6",
                                "--iters", "6", "--seed", "0", "--out", out_bin], None),
                       cwd=ROOT, env=env, capture_output=True, text=True)
    print(p.stdout.strip(), flush=True)
    if p.returncode != 0:
        print(p.stderr[-3000:], file=sys.stderr)
        return 1
    res["train_process_s"] = time.perf_counter() - t0
    res["train_lines"] = p.stdout.strip().splitlines()

    # 3. Both vocabularies over the photo room.
    views = validate.render_views()
    res["validate"] = {}
    for name, path in (("trained", out_bin),
                       ("vocab_1m", os.path.join(dbow2.DATA_DIR, "vocab_1m.bin"))):
        for c in (extract_patches_cuda, sample_patches_cuda):
            reset_launches(c)
        r = validate.validate(path, device=args.device, views=views)
        r.update(p1=extract_patches_cuda.launches, p2=sample_patches_cuda.launches,
                 bytes=os.path.getsize(path))
        res["validate"][name] = r
        print(f"validate {name} ({path}, {r['bytes'] / 1e6:.3f} MB):", flush=True)
        validate.report(r)
        print(f"  {json.dumps({k: v for k, v in r.items()}, default=float)}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=lambda o: o.item() if isinstance(
                o, np.generic) else str(o))
    return 0


if __name__ == "__main__":
    sys.exit(main())
