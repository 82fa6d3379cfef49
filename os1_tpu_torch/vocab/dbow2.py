"""DBoW2 binary vocabulary format. Port of os1_tpu/vocab/dbow2.py.

The os1 binary format (reference TemplatedVocabulary.h:1546-1560):

  header, 4 bytes:    k (branching), L (depth), scoring, weighting
  per node, 45 bytes: parent id (int32) | isLeaf (u8) | descriptor (32 B)
                      | weight (float64)

Parents precede their children; node ids are implicit (1-based, the root 0
has no record) and leaves are numbered as words in record order. Loading is
one mmap'd pass of the host library (``vocab/native.py``).
"""
from __future__ import annotations

import os

import numpy as np

from .native import load_vocabulary_arrays
from .tree import Vocabulary

_REC = np.dtype([("parent", "<i4"), ("is_leaf", "u1"), ("desc", "u1", 32), ("weight", "<f8")])

# The vocabularies shipped with the repository, in order of preference: the
# reference-scale tree (k=10, L=6, ~8.5e5 nodes), the mid-size one, the small
# texture-trained default. They are data in the reference's format, read by
# path.
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "os1_tpu", "data")
DEFAULT_FILES = ("vocab_1m.bin", "vocab_100k.bin", "default_vocab.bin")


def save_binary(vocab: Vocabulary, path: str) -> None:
    """Write ``vocab`` in node-id order (parents precede children). Word ids
    are implicit in the file, so a reloaded vocabulary numbers its words in
    record order."""
    n = len(vocab.node_desc)
    parent = np.full(n, -1, np.int64)
    for i in range(n):
        for c in vocab.node_children[i]:
            if c >= 0:
                parent[c] = i
    recs = np.zeros(n - 1, _REC)
    recs["parent"] = parent[1:]
    recs["is_leaf"] = (np.asarray(vocab.node_word[1:]) >= 0).astype(np.uint8)
    recs["desc"] = np.ascontiguousarray(vocab.node_desc[1:], dtype=np.uint32).view(
        np.uint8).reshape(n - 1, 32)
    recs["weight"] = np.asarray(vocab.node_weight[1:], np.float64)
    with open(path, "wb") as f:
        f.write(bytes([vocab.branching & 0xFF, vocab.depth & 0xFF, 0, 0]))  # L1-NORM, TF-IDF
        f.write(recs.tobytes())


def load_binary(path: str) -> Vocabulary:
    desc, children, weight, word, n_words, k, L = load_vocabulary_arrays(path)
    return Vocabulary(node_desc=desc, node_children=children, node_weight=weight,
                      node_word=word, n_words=n_words, branching=k, depth=L)


_DEFAULT_CACHE = {}
# Where a default vocabulary trained by this package is written (gitignored).
TRAINED_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "_build", "default_vocab.bin")


def default_vocabulary(device=None) -> Vocabulary:
    """The first of ``DEFAULT_FILES`` present in ``DATA_DIR``, loaded once per
    process. Without any of them, the default is trained as the reference
    trains it (``training_descriptors()``, then ``build_vocabulary(k=10,
    L=4)``, on ``device``; None: the card) into ``TRAINED_DEFAULT``, and read
    from there from then on."""
    paths = [os.path.join(DATA_DIR, name) for name in DEFAULT_FILES] + [TRAINED_DEFAULT]
    path = next((p for p in paths if os.path.exists(p)), None)
    if path is None:
        from .train import build_vocabulary, training_descriptors

        descs, docs = training_descriptors(device=device)
        vocab = build_vocabulary(descs, branching=10, depth=4, n_docs=int(docs.max()) + 1,
                                 doc_ids=docs, device=device)
        os.makedirs(os.path.dirname(TRAINED_DEFAULT), exist_ok=True)
        tmp = f"{TRAINED_DEFAULT}.tmp{os.getpid()}"
        save_binary(vocab, tmp)
        os.replace(tmp, TRAINED_DEFAULT)
        path = TRAINED_DEFAULT
    if path not in _DEFAULT_CACHE:
        _DEFAULT_CACHE[path] = load_binary(path)
    return _DEFAULT_CACHE[path]
