"""Vocabulary training: hierarchical binary k-medians over ORB descriptors.
Port of os1_tpu/vocab/train.py.

DBoW2 builds its vocabulary by hierarchical k-means over training
descriptors; for binary descriptors the centre of a cluster is its bitwise
majority, the mean under the Hamming distance (k-medians). Two trainers:

- :func:`build_vocabulary` runs the JAX package's Python trainer. On the
  card each assignment is one launch of the fused Hamming match (K1,
  ``ops/pallas_hamming.py::gated_match_cuda``: the nearest centre of every
  descriptor, the lowest index among equal distances) and each centre update
  an integer majority count on the device. On the CPU the plain version
  (:func:`_assign`, the reference's popcount identity on 0/1 floats) runs.
  The initial centres are drawn on the host with
  ``np.random.default_rng(seed)`` in the reference's order, so both packages,
  and the card and the CPU, build the same tree.
- :func:`build_vocabulary_native` runs the host C++ trainer of
  ``csrc/bow.cpp`` (``vocab/native.py::vocab_train``), which trains a
  10^5-10^6-word tree in seconds; its idf counts documents per word through
  the host descent. Without the library it raises.

The corpus: :func:`training_descriptors` (textures at 240x320, the default
vocabulary's) and :func:`training_corpus` (textures and rendered scene
views at 480x640) run the port's extractor (P1 and P2 on the card) over the
port's renderer.

The reference-scale corpus is built in shards (the counterpart of
``scripts/gen_vocab_corpus.py``): :func:`write_corpus_shard` writes shard
``i`` as ``training_corpus(images, 1024, seed=1000 + 77 * i)`` into an
``.npz`` file, and :func:`load_corpus_shards` merges shards with the
document offsets of ``scripts/train_vocab_1m.py``.

    python -m os1_tpu_torch.vocab.train [--images N] [--features F]
        [--branching k] [--depth L] [--seed S] [--iters I] [--native]
        [--device cpu] [--out PATH]
    python -m os1_tpu_torch.vocab.train --shard I --n-shards N [--images M]
        [--shard-dir D] [--device cpu]
    python -m os1_tpu_torch.vocab.train --from-shards D [--depth L] [--seed S]
        [--iters I] [--native] [--out PATH]

The first renders and extracts a corpus, trains, writes the DBoW2 binary
(by default under ``_build/``) and prints the tree's statistics and the time
of each stage; the second writes one corpus shard; the third trains from
every shard in ``D``. ``vocab_1m``'s recipe is ``--from-shards D --native
--depth 6 --iters 6 --seed 0``, ``scripts/train_vocab.py``'s 100k one
``--images 1200 --depth 5 --native``.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from .. import default_device
from ..ops import hamming
from .tree import Vocabulary

BITS = hamming.BITS


def _unpack(descs: np.ndarray) -> np.ndarray:
    """[M, 8] uint32 -> [M, 256] uint8 bits."""
    return np.unpackbits(descs.view(np.uint8).reshape(len(descs), 32), axis=-1,
                         bitorder="little")


def _pack(bits: np.ndarray) -> np.ndarray:
    """[M, 256] bits -> [M, 8] uint32."""
    by = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return by.reshape(len(bits), 8, 4).view(np.uint32).reshape(len(bits), 8)


def _assign(bits: torch.Tensor, centers: torch.Tensor, chunk: int = 131072) -> torch.Tensor:
    """Plain nearest-centre assignment under the Hamming distance:
    |a ^ c| = |a| + |c| - 2 a.c on 0/1 floats (|a| is constant per row and
    drops out of the argmin), the lowest centre among equal distances. Every
    term is an integer below 2^24, so float32 is exact."""
    cf = centers.to(torch.float32)
    ones_c = cf.sum(1)
    out = torch.empty(len(bits), dtype=torch.int64, device=bits.device)
    for lo in range(0, len(bits), chunk):
        bf = bits[lo:lo + chunk].to(torch.float32)
        out[lo:lo + chunk] = torch.argmin(ones_c[None, :] - 2.0 * (bf @ cf.T), dim=1)
    return out


def _assign_cuda(words: torch.Tensor, center_words: torch.Tensor) -> torch.Tensor:
    """K1's assignment: one fused-match launch of [m, 8] descriptors against
    [k, 8] centres, no gate, the nearest column (lowest among equal minima)."""
    from ..ops.pallas_hamming import gated_match_cuda

    m, k = len(words), len(center_words)
    dev = words.device
    top = gated_match_cuda(words[None], center_words[None], max_dist=BITS, ratio=1.0,
                           valid_a=torch.ones((1, m), dtype=torch.bool, device=dev),
                           valid_b=torch.ones((1, k), dtype=torch.bool, device=dev))
    return top.idx[0]


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[k, 256] 0/1 -> [k, 8] packed int32 (two's complement of the uint32
    words)."""
    w = (bits.reshape(-1, hamming.WORDS, 32).to(torch.int64)
         << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _kmedians(bits: torch.Tensor, words, k: int, rng, iters: int = 8):
    """Binary k-medians over one node's descriptors: (centre bits [k', 256]
    uint8, assignment [M] int64), k' <= k (empty clusters dropped). ``words``
    are the same descriptors packed (CUDA only: K1 assigns them)."""
    m = len(bits)
    k = min(k, m)
    pick = torch.as_tensor(rng.choice(m, size=k, replace=False), device=bits.device)
    centers = bits[pick]

    def assign(c):
        return _assign(bits, c) if words is None else _assign_cuda(words, _pack_words(c))

    for _ in range(iters):
        a = assign(centers)
        ones = torch.zeros((len(centers), BITS), dtype=torch.int32, device=bits.device)
        ones.index_add_(0, a, bits.to(torch.int32))
        n = torch.bincount(a, minlength=len(centers))
        # sel.mean(0) >= 0.5 of the reference, in integers: 2 * ones >= n.
        keep = n > 0
        centers = (2 * ones >= n[:, None].to(torch.int32))[keep].to(torch.uint8)
        if len(centers) <= 1:
            break
    return centers, assign(centers)


def build_vocabulary(descs: np.ndarray, branching: int = 10, depth: int = 4, seed: int = 0,
                     n_docs: int | None = None, doc_ids: np.ndarray | None = None,
                     device=None) -> Vocabulary:
    """Train a (branching^depth)-word vocabulary from packed descriptors
    [M, 8] uint32, on ``device`` (None: the card). ``doc_ids`` (the source
    image of each descriptor) give the idf over documents; without them the
    idf counts descriptors. The same tree as the JAX package's for the same
    seed."""
    device = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(seed)
    descs = np.ascontiguousarray(descs, np.uint32)
    all_bits = torch.as_tensor(_unpack(descs), device=device)
    all_words = (torch.as_tensor(descs.view(np.int32), device=device)
                 if device.type == "cuda" else None)

    node_desc = [np.zeros(8, np.uint32)]  # the root has no descriptor
    node_children = [[]]
    node_is_leaf = [False]
    node_counts = [None]  # descriptor ids of a leaf

    def split(node_id, idx, level):
        if level == depth or len(idx) <= branching:
            node_is_leaf[node_id] = True
            node_counts[node_id] = idx.cpu().numpy()
            return
        words = all_words[idx] if all_words is not None else None
        centers, assign = _kmedians(all_bits[idx], words, branching, rng)
        packed = _pack(centers.cpu().numpy())
        for c in range(len(centers)):
            child = len(node_desc)
            node_desc.append(packed[c])
            node_children.append([])
            node_is_leaf.append(False)
            node_counts.append(None)
            node_children[node_id].append(child)
            split(child, idx[assign == c], level + 1)

    split(0, torch.arange(len(descs), device=device), 0)

    n = len(node_desc)
    children = np.full((n, branching), -1, np.int32)
    for i, ch in enumerate(node_children):
        children[i, :len(ch)] = ch
    word_id = np.full(n, -1, np.int32)
    weight = np.zeros(n, np.float32)
    w = 0
    n_docs_eff = n_docs if n_docs is not None else len(descs)
    for i in range(n):
        if node_is_leaf[i]:
            word_id[i] = w
            idx = node_counts[i]
            if doc_ids is not None:
                ni = len(np.unique(doc_ids[idx])) if len(idx) else 0
            else:
                ni = len(idx)
            weight[i] = np.log(max(n_docs_eff, 2) / max(ni, 1))
            w += 1
    return Vocabulary(node_desc=np.stack(node_desc), node_children=children,
                      node_weight=weight, node_word=word_id, n_words=w,
                      branching=branching, depth=depth)


def build_vocabulary_native(descs: np.ndarray, branching: int = 10, depth: int = 5,
                            seed: int = 0, n_docs: int | None = None,
                            doc_ids: np.ndarray | None = None, iters: int = 8) -> Vocabulary:
    """Reference-scale training through the host C++ trainer (a 10^5-10^6-word
    tree in seconds). The idf follows DBoW2's TF-IDF: log(N_docs / documents
    holding the word), the documents counted through the host descent; without
    ``doc_ids``, descriptors a leaf. Raises if the host library cannot be
    built."""
    from .native import bow_transform, vocab_train

    descs = np.ascontiguousarray(descs, np.uint32)
    node_desc, children, node_word, leaf_count, n_nodes, n_words = vocab_train(
        descs, branching, depth, seed=seed, iters=iters)
    weight = np.zeros(n_nodes, np.float32)
    leaves = node_word >= 0
    if doc_ids is not None:
        tree = Vocabulary(node_desc=node_desc, node_children=children,
                          node_weight=np.zeros(n_nodes, np.float32), node_word=node_word,
                          n_words=n_words, branching=branching, depth=depth)
        word_per_desc, _ = bow_transform(tree, descs, np.ones(len(descs), bool))
        n_docs_eff = n_docs if n_docs is not None else int(doc_ids.max()) + 1
        pairs = np.unique(doc_ids.astype(np.int64) * n_words + word_per_desc)
        n_per_word = np.bincount((pairs % n_words).astype(np.int64), minlength=n_words)
        weight[leaves] = np.log(max(n_docs_eff, 2)
                                / np.maximum(n_per_word[node_word[leaves]], 1))
    else:
        n_docs_eff = n_docs if n_docs is not None else len(descs)
        weight[leaves] = np.log(max(n_docs_eff, 2) / np.maximum(leaf_count[leaves], 1))
    return Vocabulary(node_desc=node_desc, node_children=children, node_weight=weight,
                      node_word=node_word, n_words=n_words, branching=branching, depth=depth)


def _extract_all(cfg, images, device):
    """Run the extractor over an iterable of float32 images: (descs [M, 8]
    uint32 of the valid lanes, doc ids [M])."""
    from ..features.orb import make_extractor

    extract = make_extractor(cfg, device)
    descs, docs = [], []
    for i, img in enumerate(images):
        f = extract(torch.as_tensor(img, device=device))
        v = f.valid.cpu().numpy()
        descs.append(f.desc.cpu().numpy()[v].view(np.uint32))
        docs.append(np.full(int(v.sum()), i))
    return np.concatenate(descs), np.concatenate(docs)


def training_descriptors(n_images: int = 40, n_features: int = 512, seed: int = 7,
                         device=None):
    """ORB descriptors of synthetic textures at 240x320 (4 levels), the
    default vocabulary's corpus. Returns (descs [M, 8] uint32, doc ids [M])."""
    from ..features.orb import OrbConfig
    from ..io.synthetic import smooth_texture

    device = torch.device(device) if device is not None else default_device()
    cfg = OrbConfig(height=240, width=320, n_features=n_features, n_levels=4)
    images = (smooth_texture(240, 320, 24 + (i % 5) * 8, seed=seed + i)
              for i in range(n_images))
    return _extract_all(cfg, images, device)


def _corpus_images(n_images: int = 800, seed: int = 11):
    """The images of :func:`training_corpus`, one at a time: every third a
    multi-scale texture, the others views of four textured-plane scenes and
    four rooms from random positions and headings, at 480x640."""
    from ..io import synthetic

    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    scenes = [synthetic.default_scene(seed=s) for s in range(4)]
    scenes += [synthetic.room_scene(seed=40 + s) for s in range(4)]
    for i in range(n_images):
        if i % 3 == 0:
            cells = int(rng.integers(16, 96))
            yield synthetic.smooth_texture(480, 640, cells, seed=seed + i)
            continue
        scene = scenes[int(rng.integers(len(scenes)))]
        pos = rng.normal(0, 1.0, 3) * np.array([1.5, 0.3, 1.5])
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ pos
        yield synthetic.render(scene, Tcw, K, 480, 640)


def training_corpus(n_images: int = 800, n_features: int = 1024, seed: int = 11,
                    device=None):
    """The reference-scale corpus: ORB descriptors (8 levels) of the images
    of :func:`_corpus_images`, about ``n_images`` * 1k descriptors. Returns
    (descs [M, 8] uint32, doc ids [M])."""
    from ..features.orb import OrbConfig

    device = torch.device(device) if device is not None else default_device()
    cfg = OrbConfig(height=480, width=640, n_features=n_features, n_levels=8)
    return _extract_all(cfg, _corpus_images(n_images, seed), device)




def shard_path(shard: int, images: int, out_dir: str | None = None) -> str:
    """Where :func:`write_corpus_shard` writes shard ``shard`` of ``images``
    images (by default ``_build/vocab_shards/``)."""
    from ..ops.cuda_build import BUILD_DIR

    out_dir = out_dir if out_dir is not None else os.path.join(BUILD_DIR, "vocab_shards")
    return os.path.join(out_dir, f"os1_vocab_shard_{shard}_{images}.npz")


def save_shard(path: str, descs: np.ndarray, docs: np.ndarray) -> None:
    """Write a corpus shard (``descs`` [M, 8] uint32, ``docs`` [M]) as the
    compressed ``.npz`` of the JAX package's shard script, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, descs=descs, docs=docs)
    os.replace(tmp, path)


def write_corpus_shard(shard: int, n_shards: int, images: int = 1500, out_dir: str | None = None,
                       device=None) -> str:
    """Shard ``shard`` of ``n_shards`` of the reference-scale corpus:
    ``training_corpus(images, 1024, seed=1000 + 77 * shard)`` on ``device``
    (None: the card), written by :func:`save_shard` to :func:`shard_path`.
    An existing shard is left as it is. Returns its path."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside 0..{n_shards - 1}")
    path = shard_path(shard, images, out_dir)
    if not os.path.exists(path):
        descs, docs = training_corpus(n_images=images, n_features=1024, seed=1000 + 77 * shard,
                                      device=device)
        save_shard(path, descs, docs)
    return path


def load_corpus_shards(paths):
    """Merge corpus shards in sorted path order: each shard's document ids
    shifted past the previous shard's largest (``scripts/train_vocab_1m.py``:
    ``doc_off = docs[-1].max() + 1``). Returns (descs [M, 8] uint32, docs
    [M], the number of documents)."""
    descs, docs = [], []
    doc_off = 0
    for p in sorted(paths):
        with np.load(p) as z:
            descs.append(z["descs"])
            docs.append(z["docs"] + doc_off)
        doc_off = int(docs[-1].max()) + 1
    return np.concatenate(descs), np.concatenate(docs), doc_off


def _train_and_report(descs, docs, n_docs, args, device) -> None:
    """Train on the corpus, write the binary, reload it and time
    ``bow.compute`` (the statistics of ``scripts/train_vocab_1m.py``)."""
    from ..ops.cuda_build import BUILD_DIR
    from . import dbow2
    from .database import KeyFrameDatabase

    out = args.out or os.path.join(BUILD_DIR, f"vocab_k{args.branching}_L{args.depth}.bin")
    t0 = time.perf_counter()
    kw = dict(branching=args.branching, depth=args.depth, seed=args.seed, n_docs=n_docs,
              doc_ids=docs)
    vocab = (build_vocabulary_native(descs, iters=args.iters, **kw) if args.native
             else build_vocabulary(descs, device=device, **kw))
    t_train = time.perf_counter() - t0
    print(f"trained ({'host C++' if args.native else device}): {len(vocab.node_desc)} nodes, "
          f"{vocab.n_words} words (k={vocab.branching}, L={vocab.depth}) in {t_train:.3f}s",
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    t0 = time.perf_counter()
    dbow2.save_binary(vocab, out)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.3f} MB, {time.perf_counter() - t0:.3f}s)",
          flush=True)
    t0 = time.perf_counter()
    v2 = dbow2.load_binary(out)
    print(f"reload: {time.perf_counter() - t0:.3f}s, {v2.n_words} words", flush=True)
    db = KeyFrameDatabase(v2, 128)
    n = min(1024, len(descs))
    desc = descs[np.random.default_rng(0).choice(len(descs), n, replace=False)]
    valid = np.ones(n, bool)
    db.compute_bow(desc, valid)
    t0 = time.perf_counter()
    for _ in range(20):
        _, _, bow = db.compute_bow(desc, valid)
    print(f"bow.compute @ {v2.n_words} words: {(time.perf_counter() - t0) / 20 * 1e3:.3f} ms/KF, "
          f"{len(bow.words)} distinct words/KF", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a DBoW2 vocabulary with the port: render "
                                 "and extract the corpus (or one shard of it), train, write the "
                                 "binary.")
    ap.add_argument("--images", type=int, default=None,
                    help="corpus images (default 120; a shard's default 1500)")
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0, help="the trainer's seed")
    ap.add_argument("--iters", type=int, default=None,
                    help="k-medians iterations a node (the host C++ trainer; default 8)")
    ap.add_argument("--native", action="store_true",
                    help="train with the host C++ trainer (the corpus still runs on --device)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="the DBoW2 binary (default os1_tpu_torch/_build/vocab_k{k}_L{L}.bin)")
    ap.add_argument("--shard", type=int, default=None, help="write this corpus shard and stop")
    ap.add_argument("--n-shards", type=int, default=None)
    ap.add_argument("--shard-dir", default=None,
                    help="where shards are written (default os1_tpu_torch/_build/vocab_shards)")
    ap.add_argument("--from-shards", metavar="DIR", default=None,
                    help="train from every shard in DIR")
    args = ap.parse_args(argv)
    if args.iters is not None and not args.native:
        ap.error("--iters needs --native (the Python trainer runs 8 iterations)")
    args.iters = 8 if args.iters is None else args.iters
    device = torch.device(args.device) if args.device else None

    if args.shard is not None:
        if args.n_shards is None:
            ap.error("--shard needs --n-shards")
        images = args.images or 1500
        path = shard_path(args.shard, images, args.shard_dir)
        if os.path.exists(path):
            print(f"{path} exists")
            return 0
        from ..ops.patches import extract_patches_cuda, sample_patches_cuda

        t0 = time.perf_counter()
        write_corpus_shard(args.shard, args.n_shards, images, args.shard_dir, device=device)
        secs = time.perf_counter() - t0
        with np.load(path) as z:
            n = len(z["descs"])
        print(f"shard {args.shard}/{args.n_shards}: {n} descs from {images} images in "
              f"{secs:.3f}s ({images / secs:.3f} images/s; launches P1 "
              f"{extract_patches_cuda.launches}, P2 {sample_patches_cuda.launches}) -> {path}",
              flush=True)
        return 0

    if args.from_shards is not None:
        paths = sorted(glob.glob(os.path.join(args.from_shards, "os1_vocab_shard_*.npz")))
        if not paths:
            ap.error(f"no os1_vocab_shard_*.npz in {args.from_shards}")
        t0 = time.perf_counter()
        descs, docs, n_docs = load_corpus_shards(paths)
        print(f"corpus: {len(descs)} descriptors / {n_docs} images from {len(paths)} shards "
              f"(loaded in {time.perf_counter() - t0:.3f}s)", flush=True)
    else:
        images = args.images or 120
        device = device if device is not None else default_device()
        t0 = time.perf_counter()
        descs, docs = training_corpus(images, args.features, device=device)
        t_corpus = time.perf_counter() - t0
        n_docs = int(docs.max()) + 1
        print(f"corpus: {len(descs)} descriptors / {images} images on {device} in "
              f"{t_corpus:.3f}s ({images / t_corpus:.3f} images/s)", flush=True)
    _train_and_report(descs, docs, n_docs, args, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
