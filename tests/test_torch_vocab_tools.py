"""The port's vocabulary tools against the JAX package's scripts, on the CPU:
the sharded reference-scale trainer (``os1_tpu_torch.vocab.train``:
``write_corpus_shard``, ``load_corpus_shards`` and the ``--shard`` /
``--from-shards`` command line; scripts/gen_vocab_corpus.py and
scripts/train_vocab_1m.py) and the vocabulary check on real photographs
(``os1_tpu_torch.vocab.validate``; scripts/validate_vocab_real.py).

Every comparison is exact unless it says otherwise:

- Three shards of seeded random descriptors (15 images, about 200,000
  descriptors, so the k=10 tree reaches its sixth level; the last image of
  one shard and a middle image of another hold no descriptor), written in
  the shard format: ``load_corpus_shards`` equals train_vocab_1m.py's merge
  (:30-39, reproduced here), whose offset skips a shard's trailing empty
  image; ``build_vocabulary_native(k=10, L=6, iters=6, seed=0)`` on the
  merged corpus equals the JAX package's, array by array, and the DBoW2
  binaries are byte-equal; the command line's ``--from-shards`` writes the
  same binary.
- ``write_corpus_shard`` at two images equals ``training_corpus(2, 1024,
  seed=1000 + 77 * shard)``, and an existing shard is left alone.
- ``validate(default vocabulary, n_views=6, device="cpu")``: every view's
  word ids equal the JAX package's extractor and
  ``KeyFrameDatabase.compute_bow`` on the same renders, and every number of
  the script (descriptors, distinct words, coverage, the self, adjacent and
  opposite L1 scores, the revisit query) agrees within 1e-6.
- ``scripts/validate_vocab_real.py --cpu`` as a subprocess against the
  port's 24-view numbers: marked ``slow`` (24 views at 480x640 through both
  extractors on the CPU and the JAX compiles take several minutes, too long
  for tier-1).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from os1_tpu.features.orb import OrbConfig as JOrb  # noqa: E402
from os1_tpu.features.orb import make_extractor as jmake_extractor  # noqa: E402
from os1_tpu.vocab import database as jdatabase  # noqa: E402
from os1_tpu.vocab import dbow2 as jdbow2  # noqa: E402
from os1_tpu.vocab import train as jtrain  # noqa: E402
from os1_tpu_torch.io import realimg  # noqa: E402
from os1_tpu_torch.vocab import dbow2, train, validate  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("node_desc", "node_children", "node_weight", "node_word")
SCORE_ATOL = 1e-6
# (images, the image with no descriptor) of each synthetic shard.
SHARDS = ((5, None), (4, 3), (6, 2))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def shard_dir(tmp_path):
    rng = np.random.default_rng(3)
    for i, (n_img, empty) in enumerate(SHARDS):
        counts = rng.integers(10000, 16000, n_img)
        if empty is not None:
            counts[empty] = 0
        docs = np.repeat(np.arange(n_img), counts)
        descs = rng.integers(0, 2**32, (len(docs), 8), dtype=np.uint64).astype(np.uint32)
        descs[::97] = descs[1]  # duplicates: a cluster no split separates
        train.save_shard(train.shard_path(i, n_img, str(tmp_path)), descs, docs)
    return tmp_path


def _merge_as_train_vocab_1m(paths):
    """scripts/train_vocab_1m.py:30-39."""
    descs, docs = [], []
    doc_off = 0
    for s in sorted(paths):
        z = np.load(s)
        descs.append(z["descs"])
        docs.append(z["docs"] + doc_off)
        doc_off = int(docs[-1].max()) + 1
    return np.concatenate(descs), np.concatenate(docs), doc_off


def test_load_corpus_shards_equals_train_vocab_1m(shard_dir):
    paths = [str(p) for p in shard_dir.glob("os1_vocab_shard_*.npz")]
    descs, docs, n_docs = train.load_corpus_shards(paths[::-1])
    jd, jdocs, joff = _merge_as_train_vocab_1m(paths)
    assert descs.dtype == np.uint32 and np.array_equal(descs, jd)
    assert docs.dtype == jdocs.dtype and np.array_equal(docs, jdocs)
    # The offset follows the largest id: shard 1's trailing empty image is
    # dropped, shard 2's empty middle image leaves a gap.
    assert n_docs == joff == 5 + 3 + 6
    assert len(np.unique(docs)) == n_docs - 1


def test_sharded_depth6_tree_equals_jax(shard_dir, tmp_path, capsys):
    paths = [str(p) for p in shard_dir.glob("os1_vocab_shard_*.npz")]
    descs, docs, n_docs = train.load_corpus_shards(paths)
    kw = dict(branching=10, depth=6, seed=0, n_docs=n_docs, doc_ids=docs, iters=6)
    v = train.build_vocabulary_native(descs, **kw)
    jv = jtrain.build_vocabulary_native(descs, **kw)
    for f in FIELDS:
        a, b = getattr(v, f), np.asarray(getattr(jv, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (v.n_words, v.branching, v.depth) == (jv.n_words, 10, 6)
    # About 200,000 descriptors: the tree reaches its sixth level.
    parent = np.full(len(v.node_desc), -1)
    for i, ch in enumerate(v.node_children):
        parent[ch[ch >= 0]] = i
    level = np.zeros(len(parent), int)
    for i in range(1, len(parent)):
        level[i] = level[parent[i]] + 1
    assert level.max() == 6
    dbow2.save_binary(v, str(tmp_path / "port.bin"))
    jdbow2.save_binary(jv, str(tmp_path / "jax.bin"))
    port_bytes = (tmp_path / "port.bin").read_bytes()
    assert port_bytes == (tmp_path / "jax.bin").read_bytes()
    # The command line's vocab_1m recipe from the shard directory.
    out = tmp_path / "cli.bin"
    assert train.main(["--from-shards", str(shard_dir), "--native", "--depth", "6", "--iters",
                       "6", "--seed", "0", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"corpus: {len(descs)} descriptors / {n_docs} images from 3 shards" in text
    for key in ("nodes", "words (k=10, L=6)", "MB", "reload:", "bow.compute @", "ms/KF"):
        assert key in text, key
    assert out.read_bytes() == port_bytes


def test_write_corpus_shard_equals_training_corpus(tmp_path, capsys):
    path = train.write_corpus_shard(1, 4, images=2, out_dir=str(tmp_path), device="cpu")
    assert os.path.basename(path) == "os1_vocab_shard_1_2.npz"
    want, want_docs = train.training_corpus(2, 1024, seed=1000 + 77 * 1, device="cpu")
    with np.load(path) as z:
        assert np.array_equal(z["descs"], want) and np.array_equal(z["docs"], want_docs)
    assert len(want) > 1000 and set(want_docs.tolist()) == {0, 1}
    stamp = os.stat(path).st_mtime_ns
    assert train.write_corpus_shard(1, 4, images=2, out_dir=str(tmp_path), device="cpu") == path
    assert os.stat(path).st_mtime_ns == stamp
    assert train.main(["--shard", "1", "--n-shards", "4", "--images", "2", "--shard-dir",
                       str(tmp_path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"{path} exists"
    with pytest.raises(ValueError):
        train.write_corpus_shard(4, 4, images=2, out_dir=str(tmp_path), device="cpu")
    # The default place is under the package's gitignored _build/.
    assert train.shard_path(0, 1500).endswith(os.path.join(
        "os1_tpu_torch", "_build", "vocab_shards", "os1_vocab_shard_0_1500.npz"))
    with pytest.raises(SystemExit):
        train.main(["--images", "2", "--iters", "6", "--device", "cpu"])  # --iters needs --native


# --------------------------------------------------------------------------- #
# Vocabulary health on real photographs
# --------------------------------------------------------------------------- #
def _jax_numbers(jvocab, views):
    """scripts/validate_vocab_real.py:58-101 over ``views``: (per-view word
    ids, the script's numbers)."""
    extract = jmake_extractor(JOrb(height=480, width=640, n_features=1024, n_levels=8))
    db = jdatabase.KeyFrameDatabase(jvocab, 64)
    words, bows, descs = [], [], []
    for i, img in enumerate(views):
        feats = extract(jnp.asarray(img))
        desc, valid = np.asarray(feats.desc), np.asarray(feats.valid)
        w, _, bow = db.compute_bow(desc, valid)
        words.append(w)
        bows.append(bow)
        descs.append(desc[valid])
        db.add(i, bow)
    n = len(np.concatenate(descs))
    all_words = np.concatenate([db.compute_bow(d, np.ones(len(d), bool))[0] for d in descs])
    all_words = all_words[all_words >= 0]
    uniq = len(np.unique(all_words))
    quarter = len(bows) // 4
    ids, _ = db.query(bows[0], exclude=[0, 1, 2])
    return words, dict(
        descriptors=n, distinct_words=uniq, words_per_desc=uniq / max(len(all_words), 1),
        coverage=len(all_words) / max(n, 1),
        self=np.mean([jdatabase.sparse_l1_score(b, b) for b in bows]),
        adjacent=np.mean([jdatabase.sparse_l1_score(bows[i], bows[i + 1])
                          for i in range(len(bows) - 1)]),
        opposite=np.mean([jdatabase.sparse_l1_score(bows[i], bows[(i + quarter) % len(bows)])
                          for i in range(len(bows))]),
        revisit_top=ids[0] if len(ids) else -1)


def test_validate_matches_jax_script():
    vocab = dbow2.default_vocabulary("cpu")
    views = validate.render_views(6)
    _, words, _, _ = validate.view_bows(vocab, views, "cpu")
    jwords, want = _jax_numbers(jdbow2.default_vocabulary(), views)
    for i, (w, jw) in enumerate(zip(words, jwords)):
        assert np.array_equal(w, np.asarray(jw)), i
    got = validate.validate(vocab, n_views=6, device="cpu")
    for k in ("descriptors", "distinct_words", "revisit_top"):
        assert got[k] == want[k], k
    for k in ("words_per_desc", "coverage", "self", "adjacent", "opposite"):
        assert abs(got[k] - want[k]) <= SCORE_ATOL, (k, got[k], want[k])
    assert got["views"] == 6 and got["revisit_expect"] == 5
    assert got["vocab_words"] == vocab.n_words
    assert got["ok"] == (got["coverage"] > 0.95 and got["adjacent"] > 2 * got["opposite"])


def test_validate_main_exits(monkeypatch, capsys):
    """VOCAB OK exits 0, VOCAB WEAK 1, no photographs 2; the printed lines
    are the script's."""
    base = dict(views=24, descriptors=100, distinct_words=50, words_per_desc=0.5,
                coverage=0.99, self=1.0, adjacent=0.3, opposite=0.1, near_far_ratio=3.0,
                revisit_top=23, revisit_expect=23)
    seen = []
    for ok, code in ((True, 0), (False, 1)):
        monkeypatch.setattr(validate, "validate",
                            lambda v, device, ok=ok: seen.append((v, device)) or dict(base, ok=ok))
        assert validate.main(["--vocab", "x.bin", "--device", "cpu"]) == code
        out = capsys.readouterr().out.splitlines()
        assert out[0] == "descriptors: 100  distinct words: 50 (0.500 words/desc)"
        assert out[1] == "word coverage (weight>0 leaves): 0.990"
        assert out[2] == ("L1 scores — self: 1.000  adjacent view: 0.300  opposite wall: 0.100"
                          "  (near/far ratio 3.0)")
        assert out[3] == "revisit query from frame 0 -> top candidate frame 23 (expect near 23)"
        assert out[4] == ("VOCAB OK" if ok else "VOCAB WEAK")
    assert seen == [("x.bin", "cpu")] * 2
    monkeypatch.setattr(realimg, "PHOTOS", "/nonexistent/photos.npz")
    assert validate.main(["--device", "cpu"]) == 2


@pytest.mark.slow
def test_validate_script_matches_port_24_views():
    """The JAX script as a subprocess against the port's 24 views, its
    printed numbers (rounded as it prints them) equal."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "scripts/validate_vocab_real.py", "--cpu"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=3000)
    lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith("E")]
    r = validate.validate(n_views=24, device="cpu")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        validate.report(r)
    assert proc.returncode == (0 if r["ok"] else 1), proc.stderr[-2000:]
    mine = buf.getvalue().splitlines()
    theirs = [ln for ln in lines if re.match(r"(descriptors|word coverage|L1 scores|revisit|VOCAB)",
                                             ln)]
    assert theirs == mine
