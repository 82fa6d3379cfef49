"""Port parity: packed-descriptor Hamming distances (os1_tpu_torch.ops).

The plain torch version must equal both JAX forms exactly (integer
distances, tolerance 0), with bit 31 of the packed words set. The CUDA
kernel is held against the plain version on the card (marked ``cuda``).
JAX is imported inside the parity tests only, so the kernel test also runs
where JAX is absent.
"""
import numpy as np
import pytest
import torch

from os1_tpu_torch.ops import hamming as th
from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda, hamming_matrix_cuda

SHAPES = [(300, 512), (128, 128), (1000, 777), (1, 5), (37, 129)]


def _words(rng, n):
    w = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    w[0, :] |= np.uint32(1 << 31)  # bit 31 always exercised
    return w


@pytest.fixture
def jax_hamming():
    pytest.importorskip("jax")
    from os1_tpu.ops import hamming as jh

    return jh


@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_matches_jax_forms(jax_hamming, n, m):
    import jax.numpy as jnp

    rng = np.random.default_rng(n * 1000 + m)
    a, b = _words(rng, n), _words(rng, m)
    ref_vpu = np.asarray(jax_hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref_mxu = np.asarray(jax_hamming.hamming_matrix_mxu(jnp.asarray(a), jnp.asarray(b)))
    out = th.hamming_matrix(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    assert out.dtype == torch.int32 and out.shape == (n, m)
    np.testing.assert_array_equal(out.numpy(), ref_vpu)
    np.testing.assert_array_equal(out.numpy(), ref_mxu)


def test_plain_matches_pallas_interpret(jax_hamming):
    """The TPU kernel itself, in interpret mode, on a 128-aligned shape."""
    import jax.numpy as jnp
    from os1_tpu.ops.pallas_hamming import hamming_matrix_pallas

    rng = np.random.default_rng(7)
    a, b = _words(rng, 300), _words(rng, 256)
    ref = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = th.hamming_matrix(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_pack_unpack_roundtrip_and_jax_layout(jax_hamming):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    bits = rng.random((50, 256)) < 0.5
    bits[:, 31] = True  # the sign bit of word 0
    packed = th.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.int32
    ref = np.asarray(jax_hamming.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(th.unpack_bits(packed).numpy(), bits)


def test_pairwise_matches_jax(jax_hamming):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    a, b = _words(rng, 64), _words(rng, 64)
    ref = np.asarray(jax_hamming.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
    out = th.hamming_pairwise(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cuda_wrapper_refuses_cpu_tensors():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_matrix_cuda(a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1024, 1024), (4096, 1024), (1000, 777), (1, 1)])
def test_cuda_kernel_matches_plain(n, m):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(n + m)
    a = torch.from_numpy(_words(rng, n).view(np.int32)).cuda()
    b = torch.from_numpy(_words(rng, m).view(np.int32)).cuda()
    before = hamming_matrix_cuda.launches
    out = hamming_matrix_cuda(a, b)
    torch.cuda.synchronize()
    assert hamming_matrix_cuda.launches == before + 1
    assert torch.equal(out, th.hamming_matrix(a, b))


@pytest.mark.cuda
def test_cuda_matcher_ties_match_cpu():
    """On the card the matcher breaks distance, column and histogram ties as
    on the CPU (lowest index first), with the fused kernel under it, in one
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from os1_tpu_torch.matching import core

    rng = np.random.default_rng(4)
    n, m = 400, 300
    b = _words(rng, m)
    b[1::3] = b[0::3][: len(b[1::3])]  # duplicate rows: exact distance ties
    src = rng.integers(0, m, n)
    a = b[src] ^ (np.uint32(1) << rng.integers(0, 32, (n, 8)).astype(np.uint32))
    gate = torch.from_numpy(rng.random((n, m)) < 0.3)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    bins = np.repeat(np.array([2, 9, 17, 25]), n // 4)  # four equal histogram bins
    ang_b = torch.from_numpy(rng.uniform(0, 6.2, m).astype(np.float32))
    rot = torch.from_numpy(((bins + 0.5) * (2 * np.pi / 30)).astype(np.float32))

    def run(dev):
        r = core.match_with_gate(ta.to(dev), tb.to(dev), gate.to(dev), 256, 0.95)
        r = core.mutual_best(r, m)
        ang_a = ang_b.to(dev)[r.idx] + rot.to(dev)
        r = core.rotation_consistency(ang_a, ang_b.to(dev), r)
        return [x.cpu() for x in r]

    before = gated_match_cuda.launches
    for x, y in zip(run("cpu"), run("cuda")):
        assert torch.equal(x, y)
    assert gated_match_cuda.launches == before + 1
