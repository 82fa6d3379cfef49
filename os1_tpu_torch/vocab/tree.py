"""Hierarchical BoW vocabulary: tree descent and dense scoring. Port of
os1_tpu/vocab/tree.py (reference DBoW2 TemplatedVocabulary).

The vocabulary is a flat general tree of host numpy arrays; node 0 is the root
and has no descriptor. The live descent is host C++ (``vocab/native.py``), as
the reference's KeyFrame::ComputeBoW runs on the CPU; :func:`transform` here
is its plain torch version, for the tests and for descriptors already in a
tensor. Dense vectors are L1-normalized; the L1 score is DBoW2's
s(v, w) = 1 - 0.5 * ||v - w||_1 in [0, 1].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..map.mirror import to_device
from ..ops.hamming import hamming_pairwise


class Vocabulary(NamedTuple):
    """Flat k-ary vocabulary tree (host numpy arrays)."""

    node_desc: np.ndarray  # [n_nodes, 8] uint32
    node_children: np.ndarray  # [n_nodes, kb] int32, -1 padded
    node_weight: np.ndarray  # [n_nodes] float32 (idf; 0 for non-leaves)
    node_word: np.ndarray  # [n_nodes] int32 word id, -1 for non-leaves
    n_words: int
    branching: int
    depth: int


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Packed int32 descriptors [N, 8] -> (word id [N] int32, -1 where
    invalid; weight [N] float32, 0 where invalid). Every descriptor descends
    ``depth`` levels to its nearest child by Hamming distance, the lowest
    child slot on ties, staying put at a node without children."""
    dev = desc.device
    node_desc = to_device(vocab.node_desc, dev)
    children = to_device(vocab.node_children, dev).long()
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
    for _ in range(vocab.depth):
        ch = children[cur]  # [N, kb]
        dist = hamming_pairwise(node_desc[torch.clamp(ch, min=0)], desc[:, None, :])
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, 1 << 20))
        chosen = torch.gather(ch, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        cur = torch.where(ch[:, 0] >= 0, chosen, cur)
    word = to_device(vocab.node_word, dev)[cur]
    weight = to_device(vocab.node_weight, dev)[cur]
    return (torch.where(valid, word, torch.full_like(word, -1)),
            torch.where(valid, weight, torch.zeros_like(weight)))


def bow_vector(word: torch.Tensor, weight: torch.Tensor, n_words: int) -> torch.Tensor:
    """(word, weight) pairs -> dense L1-normalized [W] tf-idf vector."""
    ok = word >= 0
    v = torch.zeros(n_words, dtype=torch.float32, device=word.device).index_add_(
        0, torch.where(ok, word, torch.zeros_like(word)).long(),
        torch.where(ok, weight, torch.zeros_like(weight)))
    s = torch.sum(v)
    return v / torch.where(s < 1e-12, torch.ones_like(s), s)


def l1_score(v: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of one vector against a [K, W] database -> [K]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(database - v[None, :]), dim=-1)


def shared_word_counts(v: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Number of words present in both ``v`` and each database row."""
    return torch.sum((database > 0) & (v[None, :] > 0), dim=-1).to(torch.int32)
