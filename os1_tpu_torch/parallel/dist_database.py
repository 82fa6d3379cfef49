"""Keyframe-sharded BoW place-recognition database over a device mesh. Port
of os1_tpu/parallel/dist_database.py.

Config 5 of BASELINE.json: a multi-session map can hold 10^4+ keyframes, and
querying the place-recognition database then dominates loop detection and
relocalization. The host inverted file (``vocab/database.py``) walks Python
dicts serially. Here every keyframe's bag of words is a fixed-width sorted
row (``W_CAP`` words, -1 padded), the keyframe axis shards over the mesh, and
each position scores a query against all of its keyframes and returns its
own top k; the host merges the positions' short lists.

The score is the L1 min-intersection of ``KeyFrameDatabase.score_kf``. The
reference broadcasts a [Ks, W_CAP, W_CAP] word compare; since a keyframe's
words are sorted and distinct, each query word is looked up in the
keyframe's row instead (``torch.searchsorted``), which keeps the memory at
[Ks, W_CAP]. The per-position top k is a stable descending sort, so that
ties go to the lowest index as ``jax.lax.top_k`` puts them.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh

W_CAP = 512  # most distinct words kept per keyframe bow (a 1024-feature
#              frame gives at most 1024 words; the tail weights are small)
_ROW_END = torch.iinfo(torch.int32).max  # keeps a padded row ascending for the search


def _scores(kf_search, kf_words, kf_weights, q_words, q_weights):
    """[Ks] L1 min-intersection scores of one query against a shard's rows.
    Query padding is -2 and never equals a keyframe word or its -1 pad."""
    idx = torch.searchsorted(kf_search, q_words.expand(kf_search.shape[0], -1).contiguous())
    idx = idx.clamp_(max=kf_search.shape[1] - 1)
    hit = torch.gather(kf_words, 1, idx) == q_words[None]
    m = torch.minimum(torch.gather(kf_weights, 1, idx), q_weights[None])
    return torch.sum(torch.where(hit, m, torch.zeros_like(m)), dim=1)


class DistKeyFrameDatabase:
    """Sharded mirror of the place-recognition database.

    The host keeps the padded arrays (``words``, ``weights``, ``active``);
    :meth:`publish` sends each position its keyframe rows; :meth:`query`
    scores on every position and merges the per-position top k on the host.
    It stands beside the host inverted file, which answers faster at the
    scale of one session."""

    def __init__(self, mesh: Mesh, max_keyframes: int):
        if max_keyframes % mesh.size:
            raise ValueError("the keyframe capacity must divide over the mesh")
        self.mesh = mesh
        self.max_keyframes = max_keyframes
        self.words = np.full((max_keyframes, W_CAP), -1, np.int32)
        self.weights = np.zeros((max_keyframes, W_CAP), np.float32)
        self.active = np.zeros(max_keyframes, bool)
        self._device = None  # per position: (search rows, words, weights, active)

    # ---------------- host-side bookkeeping --------------------------- #
    def add(self, kf: int, bow) -> None:
        """Insert or replace a keyframe's sparse bow (words ascending)."""
        n = min(len(bow.words), W_CAP)
        self.words[kf] = -1
        self.weights[kf] = 0.0
        self.words[kf, :n] = bow.words[:n]
        self.weights[kf, :n] = bow.weights[:n]
        self.active[kf] = True
        self._device = None

    def erase(self, kf: int) -> None:
        self.active[kf] = False
        self._device = None

    def clear(self) -> None:
        self.active[:] = False
        self.words[:] = -1
        self._device = None

    def publish(self) -> None:
        """Send the database to the mesh (amortized over the queries)."""
        rows = self.max_keyframes // self.mesh.size
        search = np.where(self.words < 0, _ROW_END, self.words).astype(np.int32)
        self._device = []
        for s, d in enumerate(self.mesh.flat_devices):
            sl = slice(s * rows, (s + 1) * rows)
            self._device.append(tuple(torch.from_numpy(np.ascontiguousarray(a[sl])).to(d)
                                      for a in (search, self.words, self.weights, self.active)))

    # ---------------- queries ----------------------------------------- #
    def query(self, bow, exclude=None, min_score: float = 0.0, top: int = 64):
        """(ids, scores) of the best-matching keyframes, best first."""
        if self._device is None:
            self.publish()
        qw = np.full(W_CAP, -2, np.int32)  # -2: never matches a keyframe's padding
        qv = np.zeros(W_CAP, np.float32)
        n = min(len(bow.words), W_CAP)
        qw[:n] = bow.words[:n]
        qv[:n] = bow.weights[:n]
        devices = self.mesh.flat_devices
        q = {d: (torch.from_numpy(qw).to(d), torch.from_numpy(qv).to(d))
             for d in self.mesh.distinct_devices}
        rows = self.max_keyframes // self.mesh.size
        k = min(64, rows)
        vals, idx = [], []
        for (search, words, weights, active), d in zip(self._device, devices):
            s = _scores(search, words, weights, *q[d])
            s = torch.where(active, s, torch.full_like(s, -1.0))
            v, i = torch.sort(s, descending=True, stable=True)
            vals.append(v[:k].to(devices[0]))
            idx.append(i[:k].to(devices[0]))
        vals = torch.cat(vals).cpu().numpy()
        idx = torch.cat(idx).cpu().numpy()
        # Per-position local top k -> global ids, merged on the host.
        n_pos = len(devices)
        gids = (idx.reshape(n_pos, k) + np.arange(n_pos)[:, None] * rows).ravel()
        keep = vals > min_score
        if exclude is not None and len(exclude):
            keep &= ~np.isin(gids, np.asarray(exclude))
        gids, gvals = gids[keep], vals[keep]
        order = np.argsort(-gvals, kind="stable")[:top]
        return gids[order], gvals[order]
