"""os1_tpu_torch: the PyTorch + CUDA port of os1-tpu for NVIDIA Hopper.

The JAX package ``os1_tpu`` is the reference and stays unchanged; this package
mirrors its layout (``geometry/``, ``ops/``, ``features/``, ``matching/``,
``optim/``, ``solvers/``, ``map/``, ``pipeline/``, ``io/``, ``utils/``) so each
module's counterpart sits at the same path. It imports ``torch`` and never
``jax`` or ``os1_tpu``.

Kernels written by hand for ``sm_90a`` live under ``csrc/`` and are built on
first use into ``_build/``. A wrapper launches its kernel for a CUDA tensor or
raises; it uses its plain PyTorch version only for a tensor on the CPU.

The slice ported so far is synchronous tracking with local mapping:
``System(cfg, enable_mapping=True, enable_loop_closing=False,
pipelined=False).track_monocular`` (mapping off runs too). Every entry point
runs on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry accuracy is the product: reduced-precision (TF32) matmuls and
# convolutions corrupt small-matrix f32 geometry, the same finding that made
# the reference force float32 matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def default_device() -> _torch.device:
    """``cuda``, or a RuntimeError when no card is present: the port runs on
    the CPU only when the caller passes ``device="cpu"`` itself."""
    if not _torch.cuda.is_available():
        raise RuntimeError("os1_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return _torch.device("cuda")
