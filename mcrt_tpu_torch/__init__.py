"""mcrt_tpu_torch: the path tracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``mcrt_tpu``, with the same module
tree and function names.  It imports torch and numpy only.  The blocked
intersector's kernels K1-K3 are CUDA C++ (``csrc/``), built with nvcc at
first use on a CUDA device; on the CPU the same queries run the kernels'
plain PyTorch versions.
"""

from .config import (AccelType, FilterType, IntegratorType, RenderConfig,
                     SamplerType)
from .renderer import Renderer

__all__ = [
    "AccelType",
    "FilterType",
    "IntegratorType",
    "RenderConfig",
    "Renderer",
    "SamplerType",
]
