"""Model configuration of the PyTorch port.

The port's own copy of the hyperparameters of SepReformer (the JAX
package's ``config.py`` holds the same numbers; the port imports nothing
from it).  Only the knobs the eval forward of Base reads are kept: the
TPU implementation selectors of the JAX package have no counterpart
here, because the port has one path per module, and the Large variants
(F=256, one speaker-split block per stage) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class ModelConfig:
    """Network hyperparameters (reference ``configs.yaml:30-93``)."""

    num_stages: int = 4           # R: down/up stages
    num_spks: int = 2
    enc_dim: int = 256            # N: encoder channels
    enc_kernel: int = 16          # L
    enc_stride: int = 4           # S
    feat_dim: int = 128           # F: separator width
    num_heads: int = 8
    pos_maxlen: int = 2000        # rel-pos table half-size
    local_kernel: int = 65        # CLA depthwise kernel
    down_kernel: int = 5          # DownConvLayer kernel
    layer_scale_init: float = 1.0e-5
    norm_eps: float = 1.0e-5      # LayerNorm / BatchNorm
    group_norm_eps: float = 1.0e-8

    @property
    def head_dim(self) -> int:
        return self.feat_dim // self.num_heads

    def padded_frames(self, num_frames: int) -> int:
        """Frames zero-padded to a multiple of 2**num_stages (no pad when
        already divisible), as the separator's ``pad_signal`` does."""
        mult = 2 ** self.num_stages
        return -(-num_frames // mult) * mult


@dataclass(frozen=True)
class VariantConfig:
    name: str
    model: ModelConfig = field(default_factory=ModelConfig)


_PRESETS: Dict[str, VariantConfig] = {
    "SepReformer_Base_WSJ0": VariantConfig("SepReformer_Base_WSJ0"),
    # the Base block structure at a width and depth the CPU tests afford
    "tiny": VariantConfig("tiny", model=ModelConfig(
        num_stages=2, enc_dim=16, feat_dim=16, num_heads=2, pos_maxlen=64,
        local_kernel=9)),
}


def available_variants() -> List[str]:
    return sorted(_PRESETS)


def get_variant(name: str) -> VariantConfig:
    """Look up a preset by name."""
    if name not in _PRESETS:
        raise KeyError(
            f"Unknown variant {name!r}; available: {available_variants()}")
    return _PRESETS[name]
