"""Configuration of the PyTorch port.

The port's own copy of the hyperparameters of SepReformer (the JAX
package's ``config.py`` holds the same numbers; the port imports nothing
from it).  Only the knobs the port reads are kept: the TPU
implementation selectors of the JAX package have no counterpart here,
because the port has one path per module.  In training that path is the
JAX package's ``fused_ffn="off"``: the GCFN runs its plain composition.
The Large variants (F=256, one speaker-split block per stage) are not
ported yet, nor ``OptimConfig.flat_opt_state`` (a TPU lever the JAX
package measured neutral).
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
    dropout: float = 0.05         # Base 0.05 / Large 0.1
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
class StftLossConfig:
    """STFT of the per-stage magnitude losses (configs.yaml:98-100)."""

    frame_length: int = 512
    frame_shift: int = 128
    window: str = "hann"


@dataclass(frozen=True)
class CriterionConfig:
    stft: StftLossConfig = field(default_factory=StftLossConfig)
    scale_inv: bool = True
    mel_opt: bool = False
    # progressive multi-loss weighting (reference engine.py:72)
    alpha: float = 0.4
    alpha_decay_start_epoch: int = 100
    alpha_decay_factor: float = 0.8
    alpha_decay_every: int = 5


@dataclass(frozen=True)
class OptimConfig:
    """Global-norm clip + AdamW + warmup (reference configs.yaml:112-128)."""

    lr: float = 1.0e-3            # Base 1e-3 / Large 2e-4
    weight_decay: float = 1.0e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1.0e-8
    clip_norm: float = 5.0        # engine.clip_norm (configs.yaml:137)
    warmup_steps: int = 1000      # WarmupConstantSchedule (configs.yaml:128)
    plateau_factor: float = 0.8
    plateau_patience: int = 2
    plateau_min_lr: float = 1.0e-10
    # the train step splits the batch into this many sequential
    # micro-batches and applies one update on the mean gradient; BatchNorm
    # running statistics update per micro-batch (not in the reference)
    accum_steps: int = 1


@dataclass(frozen=True)
class DatasetConfig:
    """The data settings the train step reads (reference configs.yaml:5-22)."""

    max_len: int = 32000          # 4 s crop at 8 kHz
    batch_size: int = 2


@dataclass(frozen=True)
class VariantConfig:
    name: str
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)


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
