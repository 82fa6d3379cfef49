"""Port parity of vocabulary training (os1_tpu_torch.vocab.train and the
trainer of csrc/bow.cpp) against the JAX package's os1_tpu.vocab.train and
os1_tpu.native, at a small size on the CPU.

Every comparison is exact (tolerance 0): the training descriptors and their
document ids; the Python trainer's tree (node descriptors, children, idf
weights, words) and its DBoW2 binary, byte for byte, on rendered and on
seeded random descriptors; the host C++ trainer's arrays against the JAX
package's native trainer's, on both sides of its two-thread threshold; the
native trainer's idf, with and without documents; the default vocabulary
trained when no file exists. The trainer's assignment on the card, one
launch of K1 (``gated_match_cuda``), is held against the plain one in
``tests/test_torch_vocab_card.py``. The host library has no fallback:
without g++ the trainer raises.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from os1_tpu import native as jnative  # noqa: E402
from os1_tpu.vocab import dbow2 as jdbow2  # noqa: E402
from os1_tpu.vocab import train as jtrain  # noqa: E402
from os1_tpu_torch.ops import cuda_build  # noqa: E402
from os1_tpu_torch.vocab import dbow2, native, train  # noqa: E402

FIELDS = ("node_desc", "node_children", "node_weight", "node_word")


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rendered():
    """(port's, JAX package's) training_descriptors(n_images=3, n_features=256)."""
    torch.set_num_threads(2)
    return (train.training_descriptors(n_images=3, n_features=256, device="cpu"),
            jtrain.training_descriptors(n_images=3, n_features=256))


def _random_descs(n=2000, seed=0):
    d = np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    d[::9] = d[1]  # duplicates: equal distances and identical draws
    return d


def _assert_same(v, jv):
    for f in FIELDS:
        a, b = getattr(v, f), np.asarray(getattr(jv, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (v.n_words, v.branching, v.depth) == (jv.n_words, jv.branching, jv.depth)


def _save_bytes(save, vocab, path):
    save(vocab, str(path))
    with open(path, "rb") as f:
        return f.read()


def test_training_descriptors_equal_jax(rendered):
    """The port's extractor over the port's textures gives the JAX package's
    valid descriptors and document ids, exactly."""
    (d, docs), (jd, jdocs) = rendered
    assert d.dtype == np.uint32 and d.shape == jd.shape and d.shape[1] == 8
    assert np.array_equal(d, jd)
    assert np.array_equal(docs, jdocs)


def test_pack_unpack_equal_jax():
    d = _random_descs(64)
    bits = train._unpack(d)
    assert np.array_equal(bits, jtrain._unpack(d))
    assert np.array_equal(train._pack(bits), jtrain._pack(bits))
    assert np.array_equal(train._pack(bits), d)


def test_plain_assignment_equals_jax():
    """The plain assignment (the CPU's) picks the JAX package's centre, the
    lowest among equal distances, on centres drawn from the descriptors."""
    bits = train._unpack(_random_descs(3000, seed=1))
    centres = bits[[5, 9, 1, 10, 500]]  # rows 1 and 10 are equal: a tie on every duplicate
    got = train._assign(torch.as_tensor(bits), torch.as_tensor(centres)).numpy()
    assert np.array_equal(got, jtrain._assign(bits, centres))


@pytest.mark.parametrize("which", ["rendered", "random"])
def test_build_vocabulary_equals_jax(which, rendered, tmp_path):
    """k=5, L=3 (as tests/test_vocab.py builds them): the same tree, idf and
    DBoW2 binary as the JAX package's Python trainer."""
    if which == "rendered":
        (descs, docs), _ = rendered
        kw = dict(n_docs=int(docs.max()) + 1, doc_ids=docs)
    else:
        descs, kw = _random_descs(), {}
    v = train.build_vocabulary(descs, branching=5, depth=3, device="cpu", **kw)
    jv = jtrain.build_vocabulary(descs, branching=5, depth=3, **kw)
    _assert_same(v, jv)
    assert (_save_bytes(dbow2.save_binary, v, tmp_path / "port.bin")
            == _save_bytes(jdbow2.save_binary, jv, tmp_path / "jax.bin"))


@pytest.mark.parametrize("m,k,L,seed", [(3000, 5, 3, 3), (70000, 10, 3, 0), (500, 10, 4, 7)])
def test_vocab_train_equals_jax_native(m, k, L, seed):
    """The host C++ trainer copies the JAX package's draw order and its
    two-thread assignment (above 65,536 descriptors): the same arrays."""
    d = _random_descs(m, seed=seed)
    got = native.vocab_train(d, k, L, seed=seed)
    want = jnative.vocab_train_native(d, k, L, seed=seed)
    assert want is not None, "the JAX package's native library did not build"
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[4:] == tuple(want[4:])


@pytest.mark.parametrize("docs", [True, False])
def test_build_vocabulary_native_equals_jax(docs, rendered, tmp_path):
    """build_vocabulary_native, idf included: over documents through the host
    descent, or over descriptors a leaf."""
    (descs, doc_ids), _ = rendered
    kw = dict(n_docs=int(doc_ids.max()) + 1, doc_ids=doc_ids) if docs else {}
    v = train.build_vocabulary_native(descs, branching=5, depth=3, **kw)
    jv = jtrain.build_vocabulary_native(descs, branching=5, depth=3, **kw)
    _assert_same(v, jv)
    assert (_save_bytes(dbow2.save_binary, v, tmp_path / "port.bin")
            == _save_bytes(jdbow2.save_binary, jv, tmp_path / "jax.bin"))


def test_default_vocabulary_trains_when_missing(monkeypatch, tmp_path):
    """Without any vocabulary file the default is trained as the JAX package
    trains it (training_descriptors(), then k=10, L=4), written to the
    package's build directory and loaded from there the next time; byte for
    byte the JAX package's own training on the same textures. (The textures
    are the port's: its numpy bicubic resize differs from OpenCV's by up to
    8e-4 grey levels, which flips 18 of the 20,480 descriptors of the 40
    default textures.)"""
    from os1_tpu.io import synthetic as jsynthetic
    from os1_tpu_torch.io import synthetic

    monkeypatch.setattr(jsynthetic, "smooth_texture", synthetic.smooth_texture)
    empty = tmp_path / "data"
    empty.mkdir()
    target = tmp_path / "_build" / "default_vocab.bin"
    monkeypatch.setattr(dbow2, "DATA_DIR", str(empty))
    monkeypatch.setattr(dbow2, "TRAINED_DEFAULT", str(target))
    monkeypatch.setattr(dbow2, "_DEFAULT_CACHE", {})
    v = dbow2.default_vocabulary(device="cpu")
    assert target.exists() and not any(empty.iterdir())
    assert (v.branching, v.depth) == (10, 4)
    descs, docs = jtrain.training_descriptors()
    jv = jtrain.build_vocabulary(descs, branching=10, depth=4, n_docs=int(docs.max()) + 1,
                                 doc_ids=docs)
    assert target.read_bytes() == _save_bytes(jdbow2.save_binary, jv, tmp_path / "jax.bin")
    assert dbow2.default_vocabulary(device="cpu") is v


def test_main_trains_and_writes(tmp_path, capsys):
    """``python -m os1_tpu_torch.vocab.train``: the corpus, both trainers,
    the binary, the statistics and the stage times."""
    out = tmp_path / "v.bin"
    for extra in ([], ["--native"]):
        assert train.main(["--images", "2", "--features", "256", "--branching", "4",
                           "--depth", "2", "--device", "cpu", "--out", str(out), *extra]) == 0
        text = capsys.readouterr().out
        assert "corpus:" in text and "images/s" in text and "trained" in text
        v = dbow2.load_binary(str(out))
        assert (v.branching, v.depth) == (4, 2) and v.n_words > 1
    descs, docs = train.training_corpus(2, 256, device="cpu")
    want = train.build_vocabulary_native(descs, branching=4, depth=2,
                                         n_docs=int(docs.max()) + 1, doc_ids=docs)
    assert out.read_bytes() == _save_bytes(dbow2.save_binary, want, tmp_path / "want.bin")


def test_trainer_has_no_fallback(monkeypatch, tmp_path):
    """Without g++ the host library cannot be built: the native trainer
    raises instead of training another way."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    lib = cuda_build.KernelLibrary("bow.cpp", native.LIBRARY.functions,
                                   compiler=cuda_build._gxx, flags=cuda_build.GXX_FLAGS)
    monkeypatch.setattr(native, "LIBRARY", lib)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.vocab_train(_random_descs(100), 4, 2)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        train.build_vocabulary_native(_random_descs(100), 4, 2)


def test_card_assignment_raises_on_cpu_tensors():
    """K1's assignment takes CUDA tensors only: on a CPU tensor it raises
    rather than running the plain version."""
    d = torch.as_tensor(_random_descs(32).view(np.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        train._assign_cuda(d, d[:4])
