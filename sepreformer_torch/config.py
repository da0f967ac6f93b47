"""Configuration of the PyTorch port.

The port's own copy of the hyperparameters of SepReformer (the JAX
package's ``config.py`` holds the same numbers; the port imports nothing
from it), with its ``--set`` overrides (``apply_override``) and its
reader of the reference's ``configs.yaml`` (``from_reference_yaml``).
Only the knobs the port reads are kept: the TPU implementation selectors
of the JAX package have no counterpart here, because the port has one
path per module, the JAX package's default one (in training the GCFN
takes the hash-dropout kernels K7/K8).  The Large variants (F=256, one
speaker-split block per stage) are not ported yet, nor
``OptimConfig.flat_opt_state`` (a TPU lever the JAX package measured
neutral), ``EngineConfig.steps_per_dispatch`` (ROADMAP A.4),
``EngineConfig.dummy_len`` (the startup summary, A.10) and the sharding
settings (A.9).
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple


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
    """Data pipeline settings (reference configs.yaml:5-22)."""

    max_len: int = 32000          # 4 s crop at 8 kHz
    sampling_rate: int = 8000
    scp_dir: str = "data/scp_ss_8k"
    train_mixture: str = "tr_mix.scp"
    train_sources: Tuple[str, ...] = ("tr_s1.scp", "tr_s2.scp")
    valid_mixture: str = "cv_mix.scp"
    valid_sources: Tuple[str, ...] = ("cv_s1.scp", "cv_s2.scp")
    test_mixture: str = "tt_mix.scp"
    test_sources: Tuple[str, ...] = ("tt_s1.scp", "tt_s2.scp")
    dynamic_mixing: bool = False
    # dynamic-mixing flavor: "wsj0" | "wsj0_base" | "wham" | "whamr"
    dm_flavor: str = "wsj0"
    train_noise: Optional[str] = None       # WHAM/WHAMR: "tr_n.scp"
    # WHAMR: reverberant sources build the mixture; the anechoic scps stay
    # the targets
    train_reverb_sources: Tuple[str, ...] = ()
    batch_size: int = 2
    num_workers: int = 8
    # test utterances per batch (length-sorted, bucket-padded; metrics at
    # true length); 1 is the reference's behaviour (dataset.py:30)
    eval_batch_size: int = 1


@dataclass(frozen=True)
class EngineConfig:
    """Run-loop settings (reference configs.yaml:133-139)."""

    max_epoch: int = 200
    start_scheduling: int = 50    # plateau LR active for epoch > this
    test_epochs: Tuple[int, ...] = (100, 120, 150, 170)
    mvn: bool = False
    # reference quirk (engine.py:194): the best tracker restarts from an
    # initial validation pass, so any epoch that beats it saves
    strict_reference_best: bool = False
    # a running-mean loss line every N train steps (0 = per epoch only)
    log_every_steps: int = 0
    # also checkpoint every Nth epoch whatever the valid loss (0 = off)
    save_every_n_epochs: int = 0


@dataclass(frozen=True)
class VariantConfig:
    name: str
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


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


def from_reference_yaml(path: str | pathlib.Path,
                        name: str = "custom") -> VariantConfig:
    """A VariantConfig from a reference-format ``configs.yaml`` (the JAX
    package's ``config.from_reference_yaml``): only the knobs the model
    exposes are read.  PyYAML is imported here, not with the module."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = raw["config"]
    m = cfg["model"]
    sep = m["module_separator"]
    rel = sep["relative_positional_encoding"]
    if rel.get("embed_v", False):
        raise ValueError("embed_v is not ported (ROADMAP A.7)")
    model = ModelConfig(
        num_stages=m["num_stages"],
        num_spks=m["num_spks"],
        enc_dim=m["module_audio_enc"]["out_channels"],
        enc_kernel=m["module_audio_enc"]["kernel_size"],
        enc_stride=m["module_audio_enc"]["stride"],
        feat_dim=m["module_feature_projector"]["out_channels"],
        num_heads=rel["num_heads"],
        pos_maxlen=rel["maxlen"],
        local_kernel=sep["enc_stage"]["local_blocks"]["kernel_size"],
        down_kernel=sep["enc_stage"]["down_conv_layer"]["samp_kernel_size"],
        dropout=sep["enc_stage"]["global_blocks"]["dropout_rate"],
    )
    mag = cfg.get("criterion", {}).get("PIT_SISNR_mag", {})
    criterion = CriterionConfig(
        stft=StftLossConfig(
            frame_length=mag.get("frame_length", 512),
            frame_shift=mag.get("frame_shift", 128),
            window=mag.get("window", "hann"),
        ),
        scale_inv=mag.get("scale_inv", True),
        mel_opt=mag.get("mel_opt", False),
    )
    opt = cfg.get("optimizer", {}).get("AdamW", {})
    sched = cfg.get("scheduler", {})
    plateau = sched.get("ReduceLROnPlateau", {})
    optim = OptimConfig(
        lr=float(opt.get("lr", 1e-3)),
        weight_decay=float(opt.get("weight_decay", 1e-2)),
        clip_norm=float(cfg.get("engine", {}).get("clip_norm", 5)),
        warmup_steps=int(
            sched.get("WarmupConstantSchedule", {}).get("warmup_steps", 1000)),
        plateau_factor=float(plateau.get("factor", 0.8)),
        plateau_patience=int(plateau.get("patience", 2)),
        plateau_min_lr=float(plateau.get("min_lr", 1e-10)),
    )
    ds = cfg.get("dataset", {})
    dataset = DatasetConfig(
        max_len=ds.get("max_len", 32000),
        sampling_rate=ds.get("sampling_rate", 8000),
        scp_dir=ds.get("scp_dir", "data/scp_ss_8k"),
        dynamic_mixing=ds.get("train", {}).get("dynamic_mixing", False),
        batch_size=cfg.get("dataloader", {}).get("batch_size", 2),
    )
    eng = cfg.get("engine", {})
    engine = EngineConfig(
        max_epoch=eng.get("max_epoch", 200),
        start_scheduling=eng.get("start_scheduling", 50),
        test_epochs=tuple(eng.get("test_epochs", (100, 120, 150, 170))),
        mvn=eng.get("mvn", False),
    )
    return VariantConfig(name=name, model=model, dataset=dataset,
                         criterion=criterion, optim=optim, engine=engine)


def _coerce(raw: str, current: Any) -> Any:
    """A CLI string as the type of the field's current value."""
    if isinstance(current, bool):
        if raw.lower() in ("true", "1", "yes", "on"):
            return True
        if raw.lower() in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"expected bool, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        elems = [e for e in raw.split(",") if e != ""]
        elem_type = type(current[0]) if current else str
        return tuple(elem_type(e) for e in elems)
    if isinstance(current, str) or current is None:
        return raw
    raise ValueError(f"cannot coerce {raw!r} to {type(current).__name__}")


def apply_override(cfg: VariantConfig, dotted: str, raw: str
                   ) -> VariantConfig:
    """Override one field by dotted path, e.g. ``apply_override(cfg,
    "optim.warmup_steps", "100")`` (the CLI's ``--set``).  The value takes
    the type of the field's current value; an unknown path raises."""

    def rec(obj: Any, path: Sequence[str]) -> Any:
        k = path[0]
        if not dataclasses.is_dataclass(obj) or k not in {
                f.name for f in dataclasses.fields(obj)}:
            raise KeyError(f"no config field {dotted!r} (failed at {k!r} on "
                           f"{type(obj).__name__})")
        cur = getattr(obj, k)
        if len(path) == 1:
            if dataclasses.is_dataclass(cur):
                raise KeyError(f"{dotted!r} is a section, not a field")
            return replace(obj, **{k: _coerce(raw, cur)})
        return replace(obj, **{k: rec(cur, path[1:])})

    return rec(cfg, dotted.split("."))
