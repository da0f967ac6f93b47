"""PyTorch/CUDA port of SepReformer (eval forward).

Imports ``torch`` and nothing of the JAX package.  The kernels on the
eval path are hand-written CUDA for Hopper (``csrc/``), built with plain
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
