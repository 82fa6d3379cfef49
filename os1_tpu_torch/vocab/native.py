"""The host BoW library (``csrc/bow.cpp``): the DBoW2 binary loader, the
vocabulary-tree descent and the hierarchical k-medians trainer, built with g++
at first use into ``_build/`` and bound with ctypes. There is no fallback: if
the library cannot be built or a call fails, it raises."""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops.cuda_build import GXX_FLAGS, KernelLibrary, _gxx

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64

LIBRARY = KernelLibrary("bow.cpp", {
    "vocab_count": [ctypes.c_char_p, _P, _P, _P],
    "vocab_load": [ctypes.c_char_p, _P, _P, _P, _P, _I64, _I32, _P],
    "bow_transform": [_P, _P, _I64, _P, _P, _P, _P, _I32, _I32, _P, _P],
    "vocab_train": [_P, _I64, _I32, _I32, ctypes.c_uint32, _I32, _P, _P, _P, _P, _I64, _P],
}, compiler=_gxx, flags=GXX_FLAGS)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def load_vocabulary_arrays(path: str):
    """(node_desc [n, 8] uint32, node_children [n, k] int32, node_weight [n]
    float32, node_word [n] int32, n_words, k, L) of a DBoW2 binary file."""
    k, L, n = _I32(), _I32(), _I64()
    LIBRARY.launch("vocab_count", path.encode(), ctypes.byref(k), ctypes.byref(L),
                   ctypes.byref(n))
    n, kb = int(n.value), int(k.value)
    desc = np.zeros((n, 8), np.uint32)
    children = np.zeros((n, kb), np.int32)
    weight = np.zeros(n, np.float32)
    word = np.zeros(n, np.int32)
    n_words = _I64()
    LIBRARY.launch("vocab_load", path.encode(), _ptr(desc), _ptr(children), _ptr(weight),
                   _ptr(word), n, kb, ctypes.byref(n_words))
    return desc, children, weight, word, int(n_words.value), kb, int(L.value)


def bow_transform(vocab, desc: np.ndarray, valid: np.ndarray):
    """Host descent of [N, 8] uint32 descriptors -> (word [N] int32, weight
    [N] float32); the same words and weights as ``tree.transform``."""
    desc = np.ascontiguousarray(desc).view(np.uint32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    n = desc.shape[0]
    word = np.empty(n, np.int32)
    weight = np.empty(n, np.float32)
    arrays = [np.ascontiguousarray(a) for a in (vocab.node_desc, vocab.node_children,
                                                vocab.node_weight, vocab.node_word)]
    LIBRARY.launch("bow_transform", _ptr(desc), _ptr(valid), n, *map(_ptr, arrays),
                   int(vocab.branching), int(vocab.depth), _ptr(word), _ptr(weight))
    return word, weight


def vocab_train(descs: np.ndarray, branching: int, depth: int, seed: int = 0,
                iters: int = 8):
    """Hierarchical binary k-medians over packed descriptors [M, 8] uint32 in
    host C++. Returns (node_desc [n, 8] uint32, node_children [n, k] int32,
    node_word [n] int32, leaf_count [n] int32, n_nodes, n_words), the same
    tree as the JAX package's native trainer for the same seed."""
    descs = np.ascontiguousarray(descs, np.uint32)
    max_nodes = sum(branching ** lvl for lvl in range(depth + 1)) + 1
    node_desc = np.zeros((max_nodes, 8), np.uint32)
    children = np.zeros((max_nodes, branching), np.int32)
    node_word = np.zeros(max_nodes, np.int32)
    leaf_count = np.zeros(max_nodes, np.int32)
    n = _I64()
    LIBRARY.launch("vocab_train", _ptr(descs), len(descs), branching, depth, seed, iters,
                   _ptr(node_desc), _ptr(children), _ptr(node_word), _ptr(leaf_count),
                   max_nodes, ctypes.byref(n))
    n = int(n.value)
    return (node_desc[:n], children[:n], node_word[:n], leaf_count[:n], n,
            int((node_word[:n] >= 0).sum()))
