"""Vocabulary health on real photographs. Port of
scripts/validate_vocab_real.py:28-106.

The port's extractor (P1 and P2 on the card) runs over views of the photo
room (``io/realimg.photo_room_scene()`` along ``loop_trajectory(n,
revolutions=1.0)``: real texture statistics through the pipeline's own
extractor) and the vocabulary is scored on:

- word coverage: the share of descriptors that reach a word (a leaf with
  weight > 0);
- quantization balance: distinct words over descriptors (higher: more
  discriminative retrieval);
- separation: the L1 BoW score of a view against itself (1.0), against the
  next view (the same wall, high) and against the view a quarter turn away
  (another wall, low), which drives loop-closure precision;
- the revisit query: view 0 against the database, its neighbours excluded
  (the top candidate should be the last view, back at the start).

    python -m os1_tpu_torch.vocab.validate [--vocab PATH] [--device cpu]

prints the numbers and ``VOCAB OK`` (exit 0) when the coverage is above 0.95
and the adjacent score above twice the opposite one, else ``VOCAB WEAK``
(exit 1); without the packaged photographs it exits 2.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import default_device

H, W = 480, 640
K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
DB_SIZE = 64
GATE_COVERAGE = 0.95
GATE_SEPARATION = 2.0  # adjacent score over opposite score


def render_views(n_views: int = 24) -> list[np.ndarray]:
    """The photo room's views along ``loop_trajectory(n_views,
    revolutions=1.0)``, [480, 640] uint8 (as the JAX script converts)."""
    from ..io import realimg, synthetic

    scene = realimg.photo_room_scene()
    poses = synthetic.loop_trajectory(n_views, revolutions=1.0)
    return [synthetic.render(scene, T, K, H, W).astype(np.uint8) for T in poses]


def view_bows(vocab, views, device):
    """Each view through the extractor on ``device`` and the vocabulary's
    host descent, each added to a ``KeyFrameDatabase(vocab, 64)`` under its
    index. Returns (database, per-view word ids [N], per-view SparseBow,
    per-view valid descriptors)."""
    from ..features.orb import OrbConfig, make_extractor
    from .database import KeyFrameDatabase

    extract = make_extractor(OrbConfig(height=H, width=W, n_features=1024, n_levels=8), device)
    db = KeyFrameDatabase(vocab, DB_SIZE)
    words, bows, descs = [], [], []
    for i, img in enumerate(views):
        feats = extract(torch.as_tensor(img, device=device))
        desc, valid = feats.desc.cpu().numpy(), feats.valid.cpu().numpy()
        w, _, bow = db.compute_bow(desc, valid)
        words.append(w)
        bows.append(bow)
        descs.append(desc[valid])
        db.add(i, bow)
    return db, words, bows, descs


def validate(vocab=None, n_views: int = 24, device=None, views=None) -> dict:
    """The health numbers of ``vocab`` (a Vocabulary, a DBoW2 path, or None
    for the default vocabulary) over ``n_views`` photo-room views (or the
    views of an earlier :func:`render_views`), the extractor on ``device``
    (None: the card)."""
    from . import dbow2
    from .database import sparse_l1_score

    device = torch.device(device) if device is not None else default_device()
    if vocab is None:
        vocab = dbow2.default_vocabulary(device)
    elif isinstance(vocab, str):
        vocab = dbow2.load_binary(vocab)
    t0 = time.perf_counter()
    views = render_views(n_views) if views is None else views
    n_views = len(views)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    db, _, bows, descs = view_bows(vocab, views, device)
    t_views = time.perf_counter() - t0

    n = sum(len(d) for d in descs)
    words = np.concatenate([db.compute_bow(d, np.ones(len(d), bool))[0] for d in descs])
    words = words[words >= 0]
    uniq = len(np.unique(words))
    self_s = float(np.mean([sparse_l1_score(b, b) for b in bows]))
    near = float(np.mean([sparse_l1_score(bows[i], bows[i + 1]) for i in range(len(bows) - 1)]))
    quarter = len(bows) // 4
    far = float(np.mean([sparse_l1_score(bows[i], bows[(i + quarter) % len(bows)])
                         for i in range(len(bows))]))
    ids, _ = db.query(bows[0], exclude=[0, 1, 2])
    coverage = len(words) / max(n, 1)
    return dict(
        views=n_views, vocab_words=int(vocab.n_words), vocab_nodes=int(len(vocab.node_desc)),
        descriptors=n, distinct_words=uniq, words_per_desc=uniq / max(len(words), 1),
        coverage=coverage, self=self_s, adjacent=near, opposite=far,
        near_far_ratio=near / max(far, 1e-6),
        revisit_top=int(ids[0]) if len(ids) else -1, revisit_expect=n_views - 1,
        ok=bool(coverage > GATE_COVERAGE and near > GATE_SEPARATION * far),
        render_s=t_render, views_s=t_views,
    )


def report(r: dict) -> None:
    """Print the numbers as scripts/validate_vocab_real.py does."""
    print(f"descriptors: {r['descriptors']}  distinct words: {r['distinct_words']} "
          f"({r['words_per_desc']:.3f} words/desc)")
    print(f"word coverage (weight>0 leaves): {r['coverage']:.3f}")
    print(f"L1 scores — self: {r['self']:.3f}  adjacent view: {r['adjacent']:.3f}  "
          f"opposite wall: {r['opposite']:.3f}  (near/far ratio {r['near_far_ratio']:.1f})")
    print(f"revisit query from frame 0 -> top candidate frame {r['revisit_top']} "
          f"(expect near {r['revisit_expect']})")
    print("VOCAB OK" if r["ok"] else "VOCAB WEAK", flush=True)


def main(argv=None) -> int:
    from ..io import realimg

    ap = argparse.ArgumentParser(description="Vocabulary health on real photographs.")
    ap.add_argument("--vocab", default=None, help="a DBoW2 binary (default: the default one)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not os.path.exists(realimg.PHOTOS):
        print("no real photos available in this environment", file=sys.stderr)
        return 2
    r = validate(args.vocab, device=args.device)
    report(r)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
