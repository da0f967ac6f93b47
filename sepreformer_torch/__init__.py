"""PyTorch/CUDA port of SepReformer: the eval forward (``api``), the
train step and the run loop (``engine``), the data pipeline (``data``)
and the command line (``python -m sepreformer_torch.cli``).

Imports ``torch`` and nothing of the JAX package.  The kernels on these
paths are hand-written CUDA for Hopper (``csrc/``), built with plain
``nvcc`` at first use; each has a plain PyTorch version that the CPU
runs.
"""

from sepreformer_torch.api import Separator, load_separator
from sepreformer_torch.config import ModelConfig, VariantConfig, get_variant
from sepreformer_torch.models import SepReformer, build_model, from_jax_params

__all__ = [
    "ModelConfig", "SepReformer", "Separator", "VariantConfig",
    "build_model", "from_jax_params", "get_variant", "load_separator",
]
