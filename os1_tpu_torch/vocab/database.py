"""Keyframe place-recognition database: sparse BoW vectors and an inverted
file. Port of os1_tpu/vocab/database.py (reference KeyFrameDatabase.cc).

Each keyframe stores its present words only; candidate retrieval walks the
inverted file (word -> {keyframe: weight}), and the two-stage protocol -
shared words >= 0.8 * max, then covisibility-group score accumulation with
the 0.75 * best threshold - mirrors DetectLoopCandidates
(KeyFrameDatabase.cc:74-197) and DetectRelocalizationCandidates (:199-336).
For L1-normalized vectors the DBoW2 L1 score is the sum over shared words of
min(a_w, b_w). Host numpy throughout; the descent is the host library's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .native import bow_transform
from .tree import Vocabulary


class SparseBow(NamedTuple):
    """L1-normalized sparse BoW vector (words sorted ascending)."""

    words: np.ndarray  # [n] int32
    weights: np.ndarray  # [n] float32, sums to 1


def _sparse_from_transform(word: np.ndarray, weight: np.ndarray) -> SparseBow:
    ok = word >= 0
    uw, inv = np.unique(word[ok], return_inverse=True)
    acc = np.zeros(len(uw), np.float32)
    np.add.at(acc, inv, weight[ok])
    s = acc.sum()
    if s > 1e-12:
        acc /= s
    return SparseBow(words=uw.astype(np.int32), weights=acc)


def sparse_l1_score(a: SparseBow, b: SparseBow) -> float:
    """s(a, b) = sum over shared words of min(a_w, b_w), in [0, 1]."""
    if len(a.words) == 0 or len(b.words) == 0:
        return 0.0
    ia = np.clip(np.searchsorted(a.words, b.words), 0, len(a.words) - 1)
    hit = a.words[ia] == b.words
    return float(np.minimum(a.weights[ia[hit]], b.weights[hit]).sum())


@dataclass
class KeyFrameDatabase:
    vocab: Vocabulary
    max_keyframes: int

    def __post_init__(self):
        self.active = np.zeros(self.max_keyframes, bool)
        self.bows = [None] * self.max_keyframes
        self.inverted: dict[int, dict[int, float]] = {}  # word -> {kf: weight}

    def compute_bow(self, desc, valid):
        """(word ids [N], weights [N], SparseBow) of one frame's descriptors
        ([N, 8] packed, numpy or tensor), by the host descent."""
        if isinstance(desc, torch.Tensor):
            desc = desc.cpu().numpy()
        if isinstance(valid, torch.Tensor):
            valid = valid.cpu().numpy()
        word, weight = bow_transform(self.vocab, desc, np.asarray(valid))
        return word, weight, _sparse_from_transform(word, weight)

    def add(self, kf: int, bow: SparseBow) -> None:
        if self.active[kf]:
            self.erase(kf)
        self.bows[kf] = bow
        self.active[kf] = True
        for w, wt in zip(bow.words.tolist(), bow.weights.tolist()):
            self.inverted.setdefault(w, {})[kf] = wt

    def erase(self, kf: int) -> None:
        bow = self.bows[kf]
        if bow is not None:
            for w in bow.words.tolist():
                post = self.inverted.get(w)
                if post is not None:
                    post.pop(kf, None)
                    if not post:
                        del self.inverted[w]
        self.bows[kf] = None
        self.active[kf] = False

    def clear(self) -> None:
        self.active[:] = False
        self.bows = [None] * self.max_keyframes
        self.inverted.clear()

    def score_kf(self, bow: SparseBow, kf: int) -> float:
        other = self.bows[kf]
        return sparse_l1_score(bow, other) if other is not None else 0.0

    def _shared_and_scores(self, bow: SparseBow, exclude=None):
        """Inverted-file walk: (shared-word count, L1 score) per keyframe
        (KeyFrameDatabase.cc:84-120)."""
        shared = np.zeros(self.max_keyframes, np.int32)
        score = np.zeros(self.max_keyframes, np.float32)
        for w, q_wt in zip(bow.words.tolist(), bow.weights.tolist()):
            for kf, wt in self.inverted.get(w, {}).items():
                shared[kf] += 1
                score[kf] += min(q_wt, wt)
        if exclude is not None and len(exclude):
            shared[np.asarray(exclude, np.int64)] = 0
        shared[~self.active] = 0
        return shared, score

    def query(self, bow: SparseBow, exclude=None, min_score: float = 0.0):
        """Shared words >= 0.8 * max and score >= min_score. Returns (kf ids
        by score, descending, stable; their scores)."""
        shared, score = self._shared_and_scores(bow, exclude)
        max_shared = shared.max() if shared.size else 0
        if max_shared == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        keep = (shared >= 0.8 * max_shared) & (score >= min_score) & (shared > 0)
        ids = np.nonzero(keep)[0]
        ids = ids[np.argsort(-score[ids], kind="stable")]
        return ids, score[ids]

    def _accumulate_groups(self, cand_ids, cand_scores, covis_fn, rel_factor: float = 0.75):
        """Covisibility-group accumulation (KeyFrameDatabase.cc:124-197): a
        candidate's score summed over its covisible group members that are
        candidates too; groups below rel_factor * the best are dropped; each
        group left contributes its best-scoring member."""
        if len(cand_ids) == 0:
            return np.empty(0, np.int64)
        in_cand = {int(k): float(s) for k, s in zip(cand_ids, cand_scores)}
        groups = []
        best_acc = 0.0
        for k in cand_ids:
            k = int(k)
            acc = best_s = in_cand[k]
            best_kf = k
            for k2 in covis_fn(k):
                s2 = in_cand.get(int(k2))
                if s2 is None:
                    continue
                acc += s2
                if s2 > best_s:
                    best_kf, best_s = int(k2), s2
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        th = rel_factor * best_acc
        out, seen = [], set()
        for acc, best_kf in groups:
            if acc >= th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return np.array(out, np.int64)

    def detect_loop_candidates(self, bow: SparseBow, exclude, min_score, covis_fn):
        """DetectLoopCandidates (KeyFrameDatabase.cc:74-197)."""
        ids, scores = self.query(bow, exclude=exclude, min_score=min_score)
        return self._accumulate_groups(ids, scores, covis_fn)

    def detect_reloc_candidates(self, bow: SparseBow, covis_fn):
        """DetectRelocalizationCandidates (KeyFrameDatabase.cc:199-336): the
        loop protocol without a minimum score."""
        ids, scores = self.query(bow)
        return self._accumulate_groups(ids, scores, covis_fn)
