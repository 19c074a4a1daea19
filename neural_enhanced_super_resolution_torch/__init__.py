"""neural_enhanced_super_resolution_torch — NESR on PyTorch and CUDA.

The PyTorch port of ``neural_enhanced_super_resolution_tpu``: the same
public contract (``SuperResolutionPipeline``, config keys, CLI), with the
JAX package's Pallas kernels replaced by hand-written Hopper kernels
(``csrc/``). This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from neural_enhanced_super_resolution_torch.pipeline import (  # noqa: E402
    SuperResolutionPipeline)

__all__ = ["SuperResolutionPipeline", "__version__"]
