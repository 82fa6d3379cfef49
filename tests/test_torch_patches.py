"""Port parity of the extractor's two gathers (os1_tpu_torch.ops.patches)
against the TPU kernels they replace, P1 and P2 of ``profile_patch.py``.

Importing ``profile_patch.py`` would run its whole TPU benchmark, so the file
is parsed with ``ast`` and only its imports, its literal constants and the
kernel bodies ``_dma_kernel`` (P1) and ``_gather_kernel`` (P2) are executed.
Each body then runs through ``pl.pallas_call`` in interpret mode, P1 with
``pltpu.InterpretParams()`` (which simulates its DMAs and semaphores), P2 with
``interpret=True``. Both are gathers, so the tolerance is 0: the plain
versions must equal the kernels exactly. P1's TPU kernel slices without
clamping, so it is held against interior keypoints; keypoints on and past
the edges are held against ``lax.dynamic_slice`` with
``allow_negative_indices=False``, whose clamping the port keeps. (With its
default, dynamic_slice first wraps a negative start around the axis, as the
JAX extractor's traced starts are; only padding lanes, which no matcher
reads, ever start before an edge.) P2 returns raw samples and the port
rounds them to bf16, so the port is held against the kernel's output rounded
the same way.

The CUDA kernels are held against the plain versions on the card (marked
``cuda``): exact, at the main path's shapes and a ragged one.
"""
import ast
import os

import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import _rotated_patch_table
from os1_tpu_torch.ops import patches as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 32


def _stack(rng, L, H, W):
    return rng.normal(size=(L, H, W)).astype(np.float32)


def _keypoints(rng, n, L, H, W, edges=False):
    k = np.stack([rng.integers(0, L, n), rng.integers(15, H - 17, n),
                  rng.integers(15, W - 17, n)], 1).astype(np.int32)
    if edges:  # on and past every edge, as padding lanes may sit
        e = np.array([[0, 0, 0], [L - 1, H - 1, W - 1], [0, -40, 5], [L - 1, 3, W + 50],
                      [0, H - 16, 14], [L - 1, 14, W - 16], [0, 15, 15], [L - 1, H - 17, W - 17]],
                     np.int32)
        k[: len(e)] = e
    return k


@pytest.fixture(scope="module")
def tpu_kernels():
    """The TPU kernel bodies of profile_patch.py, without running the file."""
    pytest.importorskip("jax")
    path = os.path.join(ROOT, "profile_patch.py")
    tree = ast.parse(open(path).read(), path)

    def literal(node):
        return isinstance(node, ast.Assign) and all(
            isinstance(v, ast.Constant) for v in ast.walk(node.value)
            if not isinstance(v, (ast.Tuple, ast.Load)))

    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom)) or literal(n)
            or (isinstance(n, ast.FunctionDef) and n.name in ("_dma_kernel", "_gather_kernel"))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    assert ns["PS"] == PS and "_dma_kernel" in ns and "_gather_kernel" in ns
    return ns


def _p1_interpret(ns, stack, kps, B=8):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n = kps.shape[0]
    return np.asarray(pl.pallas_call(
        ns["_dma_kernel"],
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n // B,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((B, PS, PS), lambda i, k: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((B, PS, PS), jnp.float32),
                            pltpu.SemaphoreType.DMA((B,))]),
        out_shape=jax.ShapeDtypeStruct((n, PS, PS), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(kps), jnp.asarray(stack)))


def _p2_interpret(ns, flat, idx, B=8):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n, S = idx.shape
    return pl.pallas_call(
        ns["_gather_kernel"],
        out_shape=jax.ShapeDtypeStruct((n, S), jnp.float32),
        in_specs=[pl.BlockSpec((B, PS * PS), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((B, S), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((B, S), lambda i: (i, 0), memory_space=pltpu.VMEM),
        grid=(n // B,), interpret=True,
    )(jnp.asarray(flat), jnp.asarray(idx))


def test_extract_patches_equals_p1_interpret(tpu_kernels):
    rng = np.random.default_rng(0)
    L, H, W = 2, 64, 80
    stack, kps = _stack(rng, L, H, W), _keypoints(rng, 16, L, H, W)
    ref = _p1_interpret(tpu_kernels, stack, kps)
    out = tp.extract_patches(torch.from_numpy(stack), torch.from_numpy(kps))
    assert out.shape == (16, PS, PS)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_extract_patches_clamps_like_dynamic_slice():
    jax = pytest.importorskip("jax")
    rng = np.random.default_rng(1)
    L, H, W = 3, 64, 80
    stack, kps = _stack(rng, L, H, W), _keypoints(rng, 24, L, H, W, edges=True)
    kps[:, 0] = np.clip(kps[:, 0], 0, L - 1)

    @jax.jit
    def slices(stack, kps):  # traced starts, as in the extractor
        return jax.vmap(lambda l, y, x: jax.lax.dynamic_slice(
            stack, (l, y - 15, x - 15), (1, PS, PS), allow_negative_indices=False)[0])(
            kps[:, 0], kps[:, 1], kps[:, 2])

    ref = np.asarray(slices(stack, kps))
    out = tp.extract_patches(torch.from_numpy(stack), torch.from_numpy(kps))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sample_patches_equals_p2_interpret(tpu_kernels):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    n = 16
    flat = rng.normal(size=(n, PS * PS)).astype(np.float32)
    table = _rotated_patch_table(42)
    abin = rng.integers(0, 64, n).astype(np.int32)
    raw = _p2_interpret(tpu_kernels, flat, table[abin])
    ref = np.asarray(raw.astype(jnp.bfloat16).astype(jnp.float32))
    out = tp.sample_patches(torch.from_numpy(flat), torch.from_numpy(abin), torch.from_numpy(table))
    assert out.shape == (n, 512)
    np.testing.assert_array_equal(out.numpy(), ref)
    # Rounding after the gather is the extractor's rounding before it.
    before = torch.from_numpy(flat).to(torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(
        out.numpy(), torch.gather(before, 1, torch.from_numpy(table[abin]).long()).numpy())


def test_cuda_wrappers_refuse_cpu_tensors():
    stack = torch.zeros((1, 40, 40))
    kps = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        tp.extract_patches_cuda(stack, kps)
    with pytest.raises(ValueError):
        tp.sample_patches_cuda(torch.zeros((4, PS * PS)), torch.zeros(4, dtype=torch.int32),
                               torch.zeros((64, 512), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1000])
def test_cuda_kernels_match_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(n)
    L, H, W = 8, 480, 640
    stack = torch.from_numpy(_stack(rng, L, H, W)).cuda()
    kps = torch.from_numpy(_keypoints(rng, n, L, H, W, edges=True)).cuda()
    before = tp.extract_patches_cuda.launches
    out = tp.extract_patches_cuda(stack, kps)
    torch.cuda.synchronize()
    assert tp.extract_patches_cuda.launches == before + 1
    assert torch.equal(out, tp.extract_patches(stack, kps))

    flat = out.reshape(n, PS * PS)
    table = torch.from_numpy(_rotated_patch_table(42)).cuda()
    abin = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).cuda()
    before = tp.sample_patches_cuda.launches
    samples = tp.sample_patches_cuda(flat, abin, table)
    torch.cuda.synchronize()
    assert tp.sample_patches_cuda.launches == before + 1
    assert torch.equal(samples, tp.sample_patches(flat, abin, table))
