"""The vocabulary trainer on the card (marked ``cuda``; skipped without an
NVIDIA GPU): its assignment, one launch of K1 (``gated_match_cuda``: the
nearest of at most ``branching`` centres, the lowest index among equal
distances), against the plain assignment on the same CUDA tensors, and the
whole trainer on the card against the trainer on the CPU. Exact (tolerance
0). No JAX is needed, so the file runs on the card's machine:
``python -m pytest --noconftest -m cuda tests/test_torch_vocab_card.py``.
"""
import numpy as np
import pytest
import torch

from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda
from os1_tpu_torch.vocab import train

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _random_descs(n, seed):
    d = np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d[::9] = d[1]  # duplicates: equal distances
    return d


@pytest.mark.parametrize("m,k", [(20480, 10), (1_000_000, 10), (1000, 7), (5, 2)])
def test_card_assignment_matches_plain(m, k):
    """A partial 8-column tile (k < 16) and, at a million rows, 62,500 row
    tiles in one grid."""
    d = _random_descs(m, seed=m)
    words = torch.as_tensor(d.view(np.int32)).cuda()
    bits = torch.as_tensor(train._unpack(d)).cuda()
    pick = torch.as_tensor(np.random.default_rng(k).choice(m, k, replace=False)).cuda()
    before = gated_match_cuda.launches
    got = train._assign_cuda(words, words[pick])
    assert gated_match_cuda.launches == before + 1
    assert torch.equal(got, train._assign(bits, bits[pick]))


def test_card_trainer_equals_cpu():
    descs, docs = train.training_descriptors(n_images=3, n_features=256, device="cpu")
    kw = dict(branching=10, depth=4, n_docs=int(docs.max()) + 1, doc_ids=docs)
    before = gated_match_cuda.launches
    v, w = (train.build_vocabulary(descs, device=d, **kw) for d in ("cuda", "cpu"))
    assert gated_match_cuda.launches > before
    for f in ("node_desc", "node_children", "node_weight", "node_word"):
        assert np.array_equal(getattr(v, f), getattr(w, f)), f
    assert v.n_words == w.n_words
