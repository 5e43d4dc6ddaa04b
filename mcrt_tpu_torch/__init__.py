"""mcrt_tpu_torch: the path tracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``mcrt_tpu``, with the same module
tree and function names.  It imports torch and numpy only.  The
intersector's kernels (K1-K3 of the blocked visit-list walk, K4/K5 of the
dense small-scene path, K6/K7 of the two-level instanced walk) are CUDA C++
(``csrc/``), built with nvcc at first use on a CUDA device; on the CPU the
same queries run the kernels' plain PyTorch versions.  Entry points run on
the CUDA card unless the caller names another device.
"""

from .config import (AccelType, FilterType, IntegratorType, RenderConfig,
                     SamplerType)
from .renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "AccelType",
    "FilterType",
    "IntegratorType",
    "RenderConfig",
    "Renderer",
    "SamplerType",
]
