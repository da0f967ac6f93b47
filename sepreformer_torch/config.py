"""Configuration of the PyTorch port.

The port's own copy of the hyperparameters of SepReformer (the JAX
package's ``config.py`` holds the same numbers; the port imports nothing
from it), with its ``--set`` overrides (``apply_override``) and its
reader of the reference's ``configs.yaml`` (``from_reference_yaml``).
Only the knobs the port reads are kept, and the dtype policy
(``ModelConfig.compute_dtype``, ``scores_dtype``).  Of the
JAX package's implementation selectors the port keeps the two attention
routes, ``attention_impl`` and ``attention_train_impl``, and the two
fused eval blocks, ``fused_local`` (the CLA through K15) and
``fused_pair`` (the EGA tail and the GCFN through K16), with their names
and defaults;
every other module has one path, the JAX package's default one (in
training the GCFN takes the hash-dropout kernels K7/K8).  The presets
are the JAX package's Base and Large families (``_large``: F=256, head
width 32, dropout 0.1, lr 2e-4, dynamic mixing; ``Large_DM_WHAM`` with
one speaker-split block per stage, ``per_stage_spk_split``); the Large
family serves and trains on the card on every attention route (K13/K14
at head width 32 on "pallas" and "single").  The T, S and M presets
(F 64, 96 and 160 in 8 heads of 8, 12 and 20, enc_dim 256, 4 stages;
Base's other fields) serve on the card on the default eval route (K1 at
their widths, K2, K3 and K12 at their head widths, float32); their
training and other routes raise naming ROADMAP "T/S/M", bfloat16 naming
"bfloat16 streams".
``ModelConfig.embed_v`` adds the rel-pos value table ``pe_v``, which
exists and converts but is never read, as in the reference and the JAX
package.  Not ported: ``OptimConfig.flat_opt_state`` (a TPU lever the
JAX package measured neutral), ``EngineConfig.steps_per_dispatch``,
``EngineConfig.dummy_len`` (the startup summary) and the sharding
settings (``parallel/``).
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple


# the values of ModelConfig's two attention routes; the JAX package's
# "*_interpret" values have no counterpart (on the CPU the port always
# runs its kernels' plain versions)
ATTENTION_IMPLS = ("auto", "fused_pv", "pallas", "single", "xla")
ATTENTION_TRAIN_IMPLS = ("auto", "fused_pv", "pallas", "xla")
# the values of the two fused-block selectors: "auto" is off, as the JAX
# package resolves it; "interpret" has no counterpart either
FUSED_BLOCK_MODES = ("auto", "on", "off")
# the activation dtypes, and the storage dtypes of the scores tensor
COMPUTE_DTYPES = ("float32", "bfloat16")
SCORES_DTYPES = ("auto", "float32", "bfloat16")


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
    # a rel-pos value table pe_v beside pe_k: created and converted, never
    # read (the reference's attention takes pos_k alone); no preset sets it
    embed_v: bool = False
    local_kernel: int = 65        # CLA depthwise kernel
    down_kernel: int = 5          # DownConvLayer kernel
    dropout: float = 0.05         # Base 0.05 / Large 0.1
    layer_scale_init: float = 1.0e-5
    norm_eps: float = 1.0e-5      # LayerNorm / BatchNorm
    group_norm_eps: float = 1.0e-8
    # global attention in eval (and in train at dropout 0 for "single"):
    # "auto" (K2 pos_kt + K3 up to a bottleneck length of 8192, K12
    # past it), "fused_pv" (K2 + K3), "pallas" (K12), "single" (K13 on
    # the raw table up to 512, dense past it), "xla" (dense torch)
    attention_impl: str = "auto"
    # global attention in train: "auto" and "fused_pv" (K2 + K9/K10 up
    # to a padded length of 512, dense past it), "pallas" (K13/K14 up to
    # 512 without key lengths, dense past it), "xla" (dense torch)
    attention_train_impl: str = "auto"
    # every LocalBlock's CLA through the fused K15 kernel: "on" takes it
    # in eval without lengths where pick_block(T) > 0 (the JAX kernels'
    # time block, ops/kernels/gcfn.py); "auto" and "off" keep the
    # unfused chain
    fused_local: str = "auto"
    # every GlobalBlock's EGA tail and GCFN through the fused K16 kernel:
    # "on" takes it without lengths, in eval or at dropout 0, where
    # pick_block(T) > 0; "auto" and "off" keep EGA, then GCFN
    fused_pair: str = "auto"
    # Large_DM_WHAM: num_stages + 1 independent speaker-split blocks (one
    # per encoder stage and the bottleneck) instead of one shared block
    per_stage_spk_split: bool = False
    # activations: "float32" or "bfloat16", in serving and in training
    # on every route (engine/train.py::check_trainable names the one
    # train case it refuses: K16 at dropout 0).  Parameters stay float32
    # and each module casts its weights to the stream's dtype; norms and
    # softmaxes compute in float32 and cast back; the kernels K1, K3,
    # K7-K10 and K12-K16 take bf16 operands with float32 accumulation;
    # the model returns float32 audio
    compute_dtype: str = "float32"
    # storage dtype of the scores tensor K3 reads: "auto" resolves to
    # float32 (the JAX rule off a TPU; the card's own rule belongs to
    # ROADMAP.md queue A, "The card's own "auto" rules"), "bfloat16"
    # halves its bytes
    scores_dtype: str = "auto"

    def __post_init__(self):
        for name, allowed in (("attention_impl", ATTENTION_IMPLS),
                              ("attention_train_impl",
                               ATTENTION_TRAIN_IMPLS),
                              ("fused_local", FUSED_BLOCK_MODES),
                              ("fused_pair", FUSED_BLOCK_MODES),
                              ("compute_dtype", COMPUTE_DTYPES),
                              ("scores_dtype", SCORES_DTYPES)):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(f"model.{name} {value!r} is not one of "
                                 f"{allowed}")

    @property
    def head_dim(self) -> int:
        return self.feat_dim // self.num_heads

    def torch_dtype(self, which: str = "compute_dtype"):
        """``compute_dtype`` (or ``scores_dtype``, "auto" as float32) as
        a torch dtype."""
        import torch

        name = getattr(self, which)
        return torch.bfloat16 if name == "bfloat16" else torch.float32

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


def _large(name: str, model: Optional[ModelConfig] = None,
           optim: Optional[OptimConfig] = None, **data_kw) -> VariantConfig:
    """The Large-DM family as the JAX package's ``_large`` builds it:
    F=256 (8 heads of 32), dropout 0.1, lr 2e-4, dynamic mixing on
    (reference SepReformer_Large_DM_WSJ0/configs.yaml:37,54,109,10)."""
    return VariantConfig(
        name,
        model=model or ModelConfig(feat_dim=256, dropout=0.1),
        optim=optim or OptimConfig(lr=2.0e-4),
        dataset=DatasetConfig(dynamic_mixing=True, **data_kw))


_PRESETS: Dict[str, VariantConfig] = {
    "SepReformer_Base_WSJ0": VariantConfig("SepReformer_Base_WSJ0"),
    "SepReformer_Large_DM_WSJ0": _large("SepReformer_Large_DM_WSJ0",
                                        dm_flavor="wsj0"),
    # its reference checkpoint has one speaker-split block per stage
    "SepReformer_Large_DM_WHAM": _large(
        "SepReformer_Large_DM_WHAM",
        model=ModelConfig(feat_dim=256, dropout=0.1,
                          per_stage_spk_split=True),
        optim=OptimConfig(lr=2.0e-4, plateau_patience=3),
        dm_flavor="wham", train_noise="tr_n.scp",
        scp_dir="data/scp_ss_8k_wham"),
    "SepReformer_Large_DM_WHAMR": _large(
        "SepReformer_Large_DM_WHAMR", dm_flavor="whamr",
        train_noise="tr_n.scp",
        train_reverb_sources=("tr_s1_reverb.scp", "tr_s2_reverb.scp"),
        scp_dir="data/scp_ss_8k_whamr"),
    # the paper's L: the Large model (the JAX package's SepReformer_L)
    "SepReformer_L": _large("SepReformer_L"),
    # Base evaluated on Libri2Mix's manifests (the reference ships cv/tt
    # scps for it and no configs.yaml)
    "SepReformer_Base_Libri2Mix": VariantConfig(
        "SepReformer_Base_Libri2Mix",
        dataset=DatasetConfig(scp_dir="data/scp_ss_8k_libri")),
    # the paper's T, S and M sizes as the JAX package builds them: Base's
    # variant with a whole new ModelConfig, so every other model field
    # takes its default (the reference ships no configs for them)
    "SepReformer_T": VariantConfig("SepReformer_T", model=ModelConfig(
        feat_dim=64, enc_dim=256, num_stages=4)),
    "SepReformer_S": VariantConfig("SepReformer_S", model=ModelConfig(
        feat_dim=96, enc_dim=256, num_stages=4)),
    "SepReformer_M": VariantConfig("SepReformer_M", model=ModelConfig(
        feat_dim=160, enc_dim=256, num_stages=4)),
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
    model = ModelConfig(
        num_stages=m["num_stages"],
        num_spks=m["num_spks"],
        enc_dim=m["module_audio_enc"]["out_channels"],
        enc_kernel=m["module_audio_enc"]["kernel_size"],
        enc_stride=m["module_audio_enc"]["stride"],
        feat_dim=m["module_feature_projector"]["out_channels"],
        num_heads=rel["num_heads"],
        pos_maxlen=rel["maxlen"],
        embed_v=rel.get("embed_v", False),
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
