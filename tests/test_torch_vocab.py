"""Port parity of place recognition (os1_tpu_torch.vocab) against the JAX
package's os1_tpu.vocab, on the vocabularies shipped in os1_tpu/data.

Exact throughout (tolerance 0): the DBoW2 binary loader gives the same arrays;
a save/load round trip gives back the same tree; the plain torch descent, the
host C++ descent and the JAX package's ``transform`` give the same words and
the same float32 weights, on random descriptors (bit 31 set) and on the
descriptors of a rendered frame; dense BoW vectors, L1 scores and shared-word
counts are equal; ``query`` and ``detect_reloc_candidates`` on the same
keyframe BoWs and covisibility return the same candidate lists. The host
library has no fallback: without a compiler it raises.
"""
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from os1_tpu.vocab import database as jdb  # noqa: E402
from os1_tpu.vocab import dbow2 as jdbow2  # noqa: E402
from os1_tpu.vocab import tree as jtree  # noqa: E402
from os1_tpu_torch.ops import cuda_build  # noqa: E402
from os1_tpu_torch.vocab import database, dbow2, native, tree  # noqa: E402

SMALL = os.path.join(dbow2.DATA_DIR, "default_vocab.bin")
FIELDS = ("node_desc", "node_children", "node_weight", "node_word")


@pytest.fixture(scope="module")
def vocabs():
    return {"small": (dbow2.load_binary(SMALL), jdbow2.load_binary(SMALL)),
            "default": (dbow2.default_vocabulary(), jdbow2.default_vocabulary())}


def _descriptors(rng, n):
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d[::3, 0] |= np.uint32(1 << 31)
    return d, rng.random(n) < 0.9


def test_load_binary_equals_jax(vocabs):
    for v, jv in vocabs.values():
        for f in FIELDS:
            a, b = getattr(v, f), np.asarray(getattr(jv, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (v.n_words, v.branching, v.depth) == (jv.n_words, jv.branching, jv.depth)


def test_default_vocabulary_prefers_the_largest(vocabs):
    v, _ = vocabs["default"]
    assert os.path.exists(os.path.join(dbow2.DATA_DIR, dbow2.DEFAULT_FILES[0]))
    assert v is dbow2.default_vocabulary()
    assert v.n_words > 500_000 and (v.branching, v.depth) == (10, 6)


def test_save_load_round_trip(vocabs, tmp_path):
    v, _ = vocabs["small"]
    path = str(tmp_path / "v.bin")
    dbow2.save_binary(v, path)
    back = dbow2.load_binary(path)
    for f in FIELDS:
        assert np.array_equal(getattr(back, f), getattr(v, f)), f
    assert os.path.getsize(path) == os.path.getsize(SMALL)
    # The reference package reads the port's file to the same tree.
    jback = jdbow2.load_binary(path)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jback, f)), getattr(v, f)), f


@pytest.mark.parametrize("which", ["small", "default"])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_descents_agree(vocabs, which, seed):
    v, jv = vocabs[which]
    desc, valid = _descriptors(np.random.default_rng(seed), 1024)
    w_host, wt_host = native.bow_transform(v, desc, valid)
    w_t, wt_t = tree.transform(v, torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid))
    w_j, wt_j = jtree.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    for w, wt in ((w_t.numpy(), wt_t.numpy()), (np.asarray(w_j), np.asarray(wt_j))):
        assert np.array_equal(w, w_host)
        assert wt.dtype == np.float32 and np.array_equal(wt, wt_host)
    assert (w_host[~valid] == -1).all() and (w_host[valid] >= 0).all()


def test_descent_of_a_rendered_frame(vocabs):
    """Real ORB descriptors (the port's extractor on a rendered view), through
    the database's host descent and the JAX package's."""
    from os1_tpu.io import synthetic
    from os1_tpu_torch.features.orb import OrbConfig, make_extractor

    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    img = synthetic.render(synthetic.default_scene(seed=3), synthetic.orbit_trajectory(2)[0],
                           K, 240, 320)
    feats = make_extractor(OrbConfig(height=240, width=320, n_features=512, n_levels=4),
                           "cpu")(torch.as_tensor(img))
    v, jv = vocabs["default"]
    word, weight, bow = database.KeyFrameDatabase(v, 4).compute_bow(feats.desc, feats.valid)
    jword, jweight, jbow = jdb.KeyFrameDatabase(jv, 4).compute_bow(
        feats.desc.numpy().view(np.uint32), feats.valid.numpy())
    assert np.array_equal(word, np.asarray(jword)) and np.array_equal(weight, np.asarray(jweight))
    assert np.array_equal(bow.words, jbow.words) and np.array_equal(bow.weights, jbow.weights)
    assert len(bow.words) > 100


def test_dense_vectors_and_scores(vocabs):
    v, jv = vocabs["small"]
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(4):
        desc, valid = _descriptors(rng, 300)
        w, wt = native.bow_transform(v, desc, valid)
        rows.append((w, wt))
    vt = torch.stack([tree.bow_vector(torch.from_numpy(w), torch.from_numpy(wt), v.n_words)
                      for w, wt in rows])
    vj = jnp.stack([jtree.bow_vector(jnp.asarray(w), jnp.asarray(wt), jv.n_words)
                    for w, wt in rows])
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tree.l1_score(vt[0], vt).numpy(),
                               np.asarray(jtree.l1_score(vj[0], vj)), atol=1e-6)
    assert np.array_equal(tree.shared_word_counts(vt[0], vt).numpy(),
                          np.asarray(jtree.shared_word_counts(vj[0], vj)))


def test_database_candidates_equal_jax(vocabs):
    """Eight keyframes that share descriptors in overlapping groups, one
    erased; the same covisibility graph for both databases."""
    v, jv = vocabs["small"]
    rng = np.random.default_rng(4)
    pool, _ = _descriptors(rng, 2000)
    db, jdb_ = database.KeyFrameDatabase(v, 16), jdb.KeyFrameDatabase(jv, 16)
    bows = {}
    for k in range(8):
        idx = np.concatenate([np.arange(50 * k, 50 * k + 400),
                              rng.integers(0, 2000, 50)])
        desc, valid = pool[idx], np.ones(len(idx), bool)
        _, _, b = db.compute_bow(desc, valid)
        _, _, jb = jdb_.compute_bow(desc, valid)
        assert np.array_equal(b.words, jb.words) and np.array_equal(b.weights, jb.weights)
        db.add(k, b)
        jdb_.add(k, jb)
        bows[k] = b
    db.erase(3)
    jdb_.erase(3)
    covis = {k: [j for j in (k - 1, k + 1, k + 2) if 0 <= j < 8] for k in range(8)}
    q, _ = _descriptors(rng, 10)
    query_desc = np.concatenate([pool[300:700], q])
    _, _, qb = db.compute_bow(query_desc, np.ones(len(query_desc), bool))
    ids, scores = db.query(qb)
    jids, jscores = jdb_.query(qb)
    assert len(ids) >= 2 and np.array_equal(ids, jids) and np.array_equal(scores, jscores)
    cands = db.detect_reloc_candidates(qb, covis_fn=lambda k: covis[k])
    jcands = jdb_.detect_reloc_candidates(qb, covis_fn=lambda k: covis[k])
    assert len(cands) >= 1 and np.array_equal(cands, jcands)
    loop = db.detect_loop_candidates(qb, exclude=[2], min_score=0.01, covis_fn=lambda k: covis[k])
    jloop = jdb_.detect_loop_candidates(qb, exclude=[2], min_score=0.01,
                                        covis_fn=lambda k: covis[k])
    assert np.array_equal(loop, jloop)
    assert database.sparse_l1_score(bows[1], bows[2]) == jdb.sparse_l1_score(bows[1], bows[2])
    db.clear()
    assert db.query(qb)[0].size == 0


def test_host_library_has_no_fallback(monkeypatch, tmp_path):
    """Without g++ the host library cannot be built, and the descent raises
    instead of running another way."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    lib = cuda_build.KernelLibrary("bow.cpp", native.LIBRARY.functions,
                                   compiler=cuda_build._gxx, flags=cuda_build.GXX_FLAGS)
    monkeypatch.setattr(native, "LIBRARY", lib)
    desc, valid = _descriptors(np.random.default_rng(0), 4)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.bow_transform(jdbow2.load_binary(SMALL), desc, valid)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        dbow2.load_binary(SMALL)
