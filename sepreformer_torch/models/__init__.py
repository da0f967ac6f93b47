from sepreformer_torch.models.convert import from_jax_params
from sepreformer_torch.models.sepreformer import SepReformer, build_model

__all__ = ["SepReformer", "build_model", "from_jax_params"]
