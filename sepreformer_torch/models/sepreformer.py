"""SepReformer in PyTorch: the eval forward, and the train forward when a
``TrainMode`` is given.

Pipeline (reference model.py:38-52, module.py:190-218), as in the JAX
package's ``models/sepreformer.py``:

  waveform [B, T]
    -> AudioEncoder      conv k16 s4 + GELU        -> [B, T', N]
    -> FeatureProjector  GroupNorm + 1x1            -> [B, T', F]
    -> Separator         U-Net of Global/Local blocks, early speaker split
    -> OutputLayer       MLP F->N
    -> AudioDecoder      transposed conv k16 s4 per speaker
  plus per-stage aux heads (masking OutputLayer + decoder).

``lengths`` (true samples per row) makes bucket and batch padding
invisible: ``audio[:, b, :lengths[b]]`` equals the row run alone at its
true length.  Module names follow the reference state_dict.

``ModelConfig.compute_dtype`` "bfloat16" casts the waveform to bfloat16
at the entry and runs the stream in it (parameters stay float32; the
encoder and decoder cast their weights to it), and the outputs come back
as float32 for the losses, as the JAX package's model does; a train
forward runs in it too, on every train route
(``engine/train.py::check_trainable`` names the one case it refuses).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from sepreformer_torch.config import ModelConfig
from sepreformer_torch.models import blocks
from sepreformer_torch.models.blocks import (
    BatchNorm,
    Conv1x1,
    DepthwiseConv1d,
    DownConvLayer,
    GlobalBlock,
    LayerNorm,
    LayerScale,
    Linear,
    LocalBlock,
    MaskedGroupNorm,
    RelPos,
    SpkAttention,
    SpkSplitStage,
    TrainMode,
    gelu_exact,
    glu_last,
    length_mask,
    pad_time,
    stream_param,
)
from sepreformer_torch.ops.framing import decoder_overlap_add, encoder_conv
from sepreformer_torch.ops.kernels import pos_kt
from sepreformer_torch.ops.resample import nearest_upsample_time

# float32 on the card means float32: cuDNN would otherwise run the k65
# depthwise conv in TF32, and the reference is held at float32.  bfloat16
# products sum in float32, as XLA's do: cuBLAS may otherwise reduce them
# in bfloat16 (this leaves float32 products as they are).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class AudioEncoder(nn.Module):
    """Conv1d(1 -> N, K, stride, no bias) + GELU (reference module.py:12-23)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.stride = cfg.enc_stride
        self.conv1d = nn.Module()
        self.conv1d.weight = nn.Parameter(
            torch.empty(cfg.enc_dim, 1, cfg.enc_kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = stream_param(self.conv1d.weight, x.dtype)[:, 0, :].t()  # [K, N]
        return gelu_exact(encoder_conv(x, w, self.stride))


class FeatureProjector(nn.Module):
    """GroupNorm(1, N, eps 1e-8) over the valid frames + 1x1 conv N->F
    without bias (reference module.py:25-35)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.norm = MaskedGroupNorm(cfg.enc_dim, cfg.group_norm_eps)
        self.conv1d = Conv1x1(cfg.enc_dim, cfg.feat_dim, bias=False)

    def forward(self, x, frame_lens=None):
        return self.conv1d(self.norm(x, frame_lens))


class RelativePositionalEncoding(nn.Module):
    """Rel-pos key table Embedding(2*maxlen, F/heads) (reference
    module.py:42-57).  ``forward(length, train, has_key_lens)`` takes the
    attention route of the forward (``blocks.attention_route``, from the
    config's ``attention_impl`` and ``attention_train_impl``) and
    materializes pos_kt once, at the 128-padded attention length, through
    the K2 kernel (with its gradient), only where that route reads it:
    the K12 and K13 routes read the raw table, and then the table's
    gradient comes from K14 alone.  With ``embed_v`` it also holds the
    value table ``pe_v`` (reference module.py:50), which nothing reads:
    the reference's attention takes pos_k alone, and so do both
    packages."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.maxlen = cfg.pos_maxlen
        self.dropout = cfg.dropout
        self.impl, self.train_impl = (cfg.attention_impl,
                                      cfg.attention_train_impl)
        self.scores_dtype = cfg.torch_dtype("scores_dtype")
        self.pe_k = nn.Embedding(2 * cfg.pos_maxlen, cfg.head_dim)
        if cfg.embed_v:
            self.pe_v = nn.Embedding(2 * cfg.pos_maxlen, cfg.head_dim)

    def forward(self, length: int, train=None,
                has_key_lens: bool = False) -> RelPos:
        """``train``: the forward's ``TrainMode``, None in eval (True: a
        train forward at the config's dropout); ``has_key_lens``: whether
        the attentions get key lengths."""
        table = self.pe_k.weight
        p = (None if not train
             else train.p if isinstance(train, TrainMode) else self.dropout)
        route = blocks.attention_route(self.impl, self.train_impl, length, p,
                                       has_key_lens)
        kt = None
        if route in blocks.POS_KT_ROUTES:
            kt = pos_kt(table, -(-length // 128) * 128, self.maxlen)
        return RelPos(length=length, pos_kt=kt, table=table,
                      maxlen=self.maxlen, impl=self.impl,
                      train_impl=self.train_impl,
                      scores_dtype=self.scores_dtype)


class SepEncStage(nn.Module):
    """Contracting stage: 2 x (GlobalBlock, LocalBlock), then an optional
    down-conv (reference module.py:59-108).  Returns (x, pre-down skip)."""

    def __init__(self, cfg: ModelConfig, down_conv: bool = True):
        super().__init__()
        f, eps = cfg.feat_dim, cfg.norm_eps
        for i in (1, 2):
            setattr(self, f"g_block_{i}", GlobalBlock(
                f, cfg.num_heads, eps, cfg.fused_pair))
            setattr(self, f"l_block_{i}", LocalBlock(
                f, cfg.local_kernel, eps, cfg.fused_local))
        self.downconv = (DownConvLayer(f, cfg.down_kernel, eps)
                         if down_conv else None)

    def forward(self, x, pos: RelPos, seq_lens=None, train=None):
        for i in (1, 2):
            x = getattr(self, f"g_block_{i}")(x, pos, seq_lens, train)
            x = getattr(self, f"l_block_{i}")(x, seq_lens, train)
        skip = x
        if self.downconv is not None:
            x = self.downconv(x, seq_lens, train)
        return x, skip


class SepDecStage(nn.Module):
    """Decoder stage: 3 x (GlobalBlock, LocalBlock, SpkAttention)
    (reference module.py:127-170)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        f, eps = cfg.feat_dim, cfg.norm_eps
        for i in (1, 2, 3):
            setattr(self, f"g_block_{i}", GlobalBlock(
                f, cfg.num_heads, eps, cfg.fused_pair))
            setattr(self, f"l_block_{i}", LocalBlock(
                f, cfg.local_kernel, eps, cfg.fused_local))
            setattr(self, f"spk_attn_{i}",
                    SpkAttention(f, cfg.num_heads, cfg.num_spks, eps))

    def forward(self, x, pos: RelPos, seq_lens=None, train=None):
        for i in (1, 2, 3):
            x = getattr(self, f"g_block_{i}")(x, pos, seq_lens, train)
            x = getattr(self, f"l_block_{i}")(x, seq_lens, train)
            x = getattr(self, f"spk_attn_{i}")(x, seq_lens, train)
        return x


class Separator(nn.Module):
    """U-Net separator with early speaker split (reference module.py:38-234)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        r = cfg.num_stages
        self.pos_emb = RelativePositionalEncoding(cfg)
        self.enc_stages = nn.ModuleList(
            [SepEncStage(cfg, down_conv=True) for _ in range(r)])
        self.bottleneck_G = SepEncStage(cfg, down_conv=False)

        def spk_split():
            return SpkSplitStage(cfg.feat_dim, cfg.num_spks,
                                 cfg.group_norm_eps)

        # one split block shared by every stage, or (Large_DM_WHAM's
        # reference, its module.py:181-184) one per encoder stage and one
        # for the bottleneck
        self.spk_split_block = (
            nn.ModuleList([spk_split() for _ in range(r + 1)])
            if cfg.per_stage_spk_split else spk_split())
        self.simple_fusion = nn.ModuleList(
            [Conv1x1(2 * cfg.feat_dim, cfg.feat_dim) for _ in range(r)])
        self.dec_stages = nn.ModuleList([SepDecStage(cfg) for _ in range(r)])

    def forward(self, x, frame_lens=None, train=None):
        cfg = self.cfg
        r = cfg.num_stages
        x = pad_time(x, cfg.padded_frames(x.shape[1]))
        pos = self.pos_emb(x.shape[1] // 2 ** r, train,
                           frame_lens is not None)

        # each row's in-separator valid length is its own pad_signal result
        # (frames rounded up to 2^R); frames past it are bucket padding
        mult = 2 ** r
        t1 = (None if frame_lens is None
              else (frame_lens + mult - 1) // mult * mult)

        def lens_at(scale: int, spk: bool = False):
            if t1 is None:
                return None
            lens = t1 // 2 ** scale
            return torch.repeat_interleave(lens, cfg.num_spks) if spk else lens

        def split(s: int):
            return (self.spk_split_block[s] if cfg.per_stage_spk_split
                    else self.spk_split_block)

        skips = []
        for s in range(r):
            x, skip = self.enc_stages[s](x, pos, lens_at(s), train)
            skips.append(split(s)(skip, lens_at(s)))
        x, _ = self.bottleneck_G(x, pos, lens_at(r), train)
        x = split(r)(x, lens_at(r))

        stage_outputs = []
        for s in range(r):
            stage_outputs.append(x)
            skip = skips[r - 1 - s]
            x = nearest_upsample_time(x, skip.shape[1])
            x = self.simple_fusion[s](torch.cat([x, skip], dim=-1))
            x = self.dec_stages[s](x, pos, lens_at(r - 1 - s, spk=True),
                                   train)
        return x, stage_outputs


class OutputLayer(nn.Module):
    """Back to encoder space (reference module.py:237-265): truncate to
    the encoder frames, Linear F->4F, GLU, Linear 2F->N; the aux heads
    (``masking``) gate the encoder output with a ReLU mask.  Returns
    [spks, B, T', N]."""

    def __init__(self, cfg: ModelConfig, masking: bool = False):
        super().__init__()
        self.cfg, self.masking = cfg, masking
        self.end_conv1x1 = nn.ModuleList([
            Linear(cfg.feat_dim, 4 * cfg.feat_dim), nn.Identity(),
            Linear(2 * cfg.feat_dim, cfg.enc_dim)])

    def forward(self, x, enc_out):
        cfg = self.cfg
        t_enc = enc_out.shape[1]
        y = self.end_conv1x1[0](x[:, :t_enc])
        y = self.end_conv1x1[2](glu_last(y))
        if self.masking:
            tiled = torch.repeat_interleave(enc_out, cfg.num_spks, dim=0)
            y = torch.relu(y) * tiled
        b = y.shape[0] // cfg.num_spks
        return y.reshape(b, cfg.num_spks, t_enc, cfg.enc_dim).transpose(0, 1)


class AudioDecoder(nn.Module):
    """ConvTranspose1d(N -> 1, K, stride, no bias) (reference
    module.py:268-283); weight [N, 1, K]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.stride = cfg.enc_stride
        self.weight = nn.Parameter(torch.empty(cfg.enc_dim, 1, cfg.enc_kernel))

    def forward(self, h):
        # the overlap-add sums in the stream's dtype, as JAX's does
        return decoder_overlap_add(
            h, stream_param(self.weight, h.dtype)[:, 0, :], self.stride)


class SepReformer(nn.Module):
    """Full model with per-stage aux heads (reference model.py:13-52).

    ``forward(x, lengths=None, train=None, aux=True)`` with x [B, T] (T %
    enc_stride == 0) returns (audio [spks, B, T], aux [num_stages, spks,
    B, T]), coarsest stage first.  The aux heads are not length-masked:
    they feed only the training losses.  With ``aux=False`` it returns
    ``audio`` alone and runs no aux head (the serving forward, as the JAX
    package's ``make_forward_fn`` lets XLA drop them); ``audio`` is the
    same bits either way.  ``train``, a ``TrainMode``, makes it the train
    forward (the JAX package's ``train=True``): dropout, and BatchNorm on
    batch statistics with a running update.  ``nn.Module.train()`` does
    not select it.  The stream runs in ``cfg.compute_dtype``; ``audio``
    and ``aux`` are float32 either way.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        r = cfg.num_stages
        self.audio_encoder = AudioEncoder(cfg)
        self.feature_projector = FeatureProjector(cfg)
        self.separator = Separator(cfg)
        self.out_layer = OutputLayer(cfg, masking=False)
        self.audio_decoder = AudioDecoder(cfg)
        self.out_layer_bn = nn.ModuleList(
            [OutputLayer(cfg, masking=True) for _ in range(r)])
        self.decoder_bn = nn.ModuleList([AudioDecoder(cfg) for _ in range(r)])

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None, aux: bool = True
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        t_samples = x.shape[-1]
        enc = self.audio_encoder(x.to(cfg.torch_dtype()))
        enc_mask = frame_lens = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=x.device)
            frame_lens = torch.clamp(
                (lengths.long() - cfg.enc_kernel) // cfg.enc_stride + 1, min=1)
            # frames past a row's length read padding through the conv tail
            enc_mask = length_mask(frame_lens, enc.shape[1], enc.dtype)
            enc = enc * enc_mask
        proj = self.feature_projector(enc, frame_lens)
        if enc_mask is not None:
            proj = proj * enc_mask
        last, stage_outs = self.separator(proj, frame_lens, train)

        out = self.out_layer(last, enc)
        if enc_mask is not None:
            out = out * enc_mask[None]
        audio = torch.stack([self.audio_decoder(out[i])[..., :t_samples]
                             for i in range(cfg.num_spks)]).float()
        if not aux:
            return audio
        t_enc = enc.shape[1]
        heads: List[torch.Tensor] = []
        for idx, so in enumerate(stage_outs):
            o = self.out_layer_bn[idx](nearest_upsample_time(so, t_enc), enc)
            heads.append(torch.stack(
                [self.decoder_bn[idx](o[j])[..., :t_samples]
                 for j in range(cfg.num_spks)]))
        return audio, torch.stack(heads).float()


def init_weights(model: SepReformer, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's distributions (torch defaults):
    U(+-1/sqrt(fan_in)) for linear and conv weights and biases, N(0, 1)
    for the rel-pos table, ones/zeros for norms, ``layer_scale_init`` for
    LayerScale; BatchNorm running statistics keep their 0/1 start.  Draws
    on the CPU, so that one seed gives the same weights on every device."""
    cfg = model.cfg

    def uniform(p: torch.Tensor, fan_in: int) -> None:
        bound = fan_in ** -0.5
        cpu = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
        p.copy_(cpu)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                uniform(mod.weight, mod.in_features)
                uniform(mod.bias, mod.in_features)
            elif isinstance(mod, (Conv1x1, DepthwiseConv1d)):
                fan_in = mod.weight.shape[1] * mod.weight.shape[2]
                uniform(mod.weight, fan_in)
                if mod.bias is not None:
                    uniform(mod.bias, fan_in)
            elif isinstance(mod, (LayerNorm, MaskedGroupNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
            elif isinstance(mod, LayerScale):
                mod.layer_scale.fill_(cfg.layer_scale_init)
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator))
            elif isinstance(mod, (AudioEncoder, AudioDecoder)):
                uniform(mod.conv1d.weight if isinstance(mod, AudioEncoder)
                        else mod.weight, cfg.enc_kernel)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sepreformer_torch runs on a CUDA device; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return device


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> SepReformer:
    """A SepReformer in eval mode on ``device`` with weights drawn from
    ``generator`` (a CPU generator; default seed 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SepReformer(cfg)
    init_weights(model, generator)
    return model.to(device).eval()
