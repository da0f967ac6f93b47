"""Separator building blocks, channels-last [B, T, F].

Each class mirrors the JAX package's ``models/blocks.py`` class of the
same name; its ``TorchLinear`` and ``TorchLayerNorm`` are ``nn.Linear``
and ``nn.LayerNorm`` here, and its ``FoldableBatchNorm`` is
``BatchNorm`` (nothing here folds it).  Submodules carry the reference
model's state_dict names (``linear_q``, ``net1.1``, ``Layer_scale`` ...),
so a reference checkpoint loads with ``load_state_dict(strict=True)`` and
``models/convert.py`` maps the flax trees onto them.

A forward is an eval forward unless it is given a ``TrainMode`` (the JAX
package's ``train=True`` and its dropout rng): then every dropout site of
the JAX blocks drops, and BatchNorm normalises with the batch statistics
and updates its running ones.

Where the JAX package reaches a Pallas kernel on the TPU, the port calls
its CUDA kernel wrapper (``ops/kernels``).  Eval: the GCFN (K1), the
rel-pos materializer (K2, in ``models/sepreformer.py``) and the masked
softmax·V (K3); past a bottleneck length of ``FUSED_PV_MAX_LENGTH`` the
flash rel-pos attention (K12) in place of K2 and K3, as the JAX
package's "auto" rule does.  Train: K2 with its gradient, the backward
of the CLA's k65 depthwise conv (K5), the GCFN with hash dropout (K7,
K8; with ``seq_lens`` the plain composition, as in JAX) and the
softmax·dropout·V pair (K9, K10; past a padded length of 512 the dense
attention that the JAX package's "xla" train path runs).  Everything
else is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sepreformer_torch.ops.kernels import (
    depthwise_large,
    flash_relpos_attention,
    fused_gcfn,
    fused_gcfn_train,
    softmax_pv,
    softmax_pv_dropout,
)
from sepreformer_torch.ops.kernels.softmax_pv import NEG_INF
from sepreformer_torch.ops.kernels.softmax_pv_train import (
    MAX_LENGTH as TRAIN_PV_MAX_LENGTH,
)
from sepreformer_torch.ops.resample import (
    adaptive_avg_pool_time,
    nearest_upsample_time,
)

# Eval attention at bottleneck lengths above this runs K12 on the raw
# rel-pos table; at or below it, scores through K2's pos_kt and K3.  The
# JAX package's "auto" switch (``blocks.resolve_attention_impl``): past
# it the [B*spks, H, L, L] scores and the [L, d, L] pos_kt (about 4.3 GB
# each at 8192) stop fitting.
FUSED_PV_MAX_LENGTH = 8192


def flash_route(length: int, train: bool) -> bool:
    """Whether the global attentions at bottleneck ``length`` take K12."""
    return not train and length > FUSED_PV_MAX_LENGTH


class TrainMode:
    """What a train-mode forward draws at random.  Dropout masks come from
    ``generator``, a generator on the model's device, through
    ``torch.rand`` (PyTorch's functional dropout takes no generator); the
    int32 hash seed of each kernel dropout site comes from ``seeds``, a
    CPU generator, as the JAX package draws one per site, so no seed waits
    on the device.  At ``p`` 0 nothing drops, and BatchNorm still uses
    the batch statistics."""

    def __init__(self, p: float, generator: torch.Generator,
                 seeds: torch.Generator):
        self.p, self.generator, self.seeds = float(p), generator, seeds

    def dropout(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype).mul_(1.0 / (1.0 - self.p))

    def kernel_seed(self) -> int:
        """A hash seed in [0, 2**31 - 1), or 0 when nothing drops."""
        if self.p == 0.0:
            return 0
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.seeds))


class RelPos(NamedTuple):
    """Relative-position context shared by every global block: the
    bottleneck length every EGA pools to, pos_kt [Lp, d, Lp] at the
    128-padded length Lp, made once per forward by the K2 kernel (None on
    the K12 route), and the raw [2*maxlen, d] table K12 reads."""

    length: int
    pos_kt: Optional[torch.Tensor]
    table: Optional[torch.Tensor] = None
    maxlen: int = 0


def length_mask(seq_lens: torch.Tensor, t: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B, t, 1] 0/1 mask: position p of row b is valid iff p < seq_lens[b]."""
    pos = torch.arange(t, device=seq_lens.device)
    return (pos[None, :] < seq_lens[:, None]).to(dtype)[..., None]


def glu_last(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def pad_time(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad axis 1 of x to ``length``."""
    if x.shape[1] == length:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, length - x.shape[1]]
    return F.pad(x, pad)


class Conv1x1(nn.Module):
    """Pointwise Conv1d as a linear map over the channel axis of
    channels-last input; weight [out, in, 1] as in the reference."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 1))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class DepthwiseConv1d(nn.Module):
    """Channels-last depthwise conv over time: [B, T, C] -> [B, T', C];
    weight [C, 1, k] as in the reference.  ``padding`` is an int or
    "SAME".  Every forward is ``F.conv1d`` (PyTorch's depthwise conv
    kernels on the card), as the JAX package leaves it to XLA (the eval
    GCFN's k3 runs inside K1).  A large odd
    "same" kernel (the CLA's k65) goes through ``depthwise_large``, whose
    backward is K5: where the JAX package takes its Pallas backward
    (``blocks.py:344-355``), less its TPU tiling rule C % 128 == 0."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 padding="SAME", bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (
            kernel_size, stride, padding)
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.empty(channels)) if bias else None
        self.large = (kernel_size > 8 and kernel_size % 2 == 1
                      and stride == 1 and padding == "SAME")

    def _pads(self):
        if self.padding == "SAME":
            lo = (self.kernel_size - 1) // 2
            return lo, self.kernel_size - 1 - lo
        return self.padding, self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.large:
            return depthwise_large(x, self.weight, self.bias)
        lo, hi = self._pads()
        xp = F.pad(x.transpose(1, 2), (lo, hi))
        y = F.conv1d(xp, self.weight, self.bias, stride=self.stride,
                     groups=x.shape[-1])
        return y.transpose(1, 2)


class LayerScale(nn.Module):
    """Residual-branch scale, parameter [1, 1, F] (reference dims=3)."""

    def __init__(self, dim: int):
        super().__init__()
        self.layer_scale = nn.Parameter(torch.empty(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.layer_scale.reshape(-1)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, under the reference's parameter and
    buffer names.  Eval normalises with the running statistics; train
    with the batch's, var = mean(x²) - mean² (biased, as flax), which
    also update the running ones: r = 0.9 r + 0.1 batch.  (PyTorch's
    ``BatchNorm1d`` would update ``running_var`` with the unbiased
    variance.)  A variance that roundoff takes below 0 counts as 0, as
    flax's ``nn.BatchNorm`` has it."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1.0e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        if train is None:
            mean, var = self.running_mean, self.running_var
        else:
            red = tuple(range(x.dim() - 1))
            mean = x.mean(dim=red)
            var = torch.clamp((x * x).mean(dim=red) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
                self.num_batches_tracked += 1
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
                + self.bias)


class MaskedGroupNorm(nn.Module):
    """GroupNorm(1, C) of channels-last [B, T, C] whose statistics span the
    first ``lens[b]`` frames of row b (all frames when ``lens`` is None);
    the affine map applies to every frame."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor,
                lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lens is None:
            mean = x.mean(dim=(1, 2), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        else:
            m = length_mask(lens, x.shape[1], x.dtype)
            count = torch.clamp(lens.to(x.dtype), min=1.0)[:, None, None]
            count = count * x.shape[2]
            mean = (x * m).sum(dim=(1, 2), keepdim=True) / count
            var = (((x - mean) * m) ** 2).sum(dim=(1, 2), keepdim=True)
            var = var / count
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
                + self.bias)


class GCFN(nn.Module):
    """Gated conv feed-forward (reference network.py:46-66):
    x + LayerScale(drop(Linear(drop(GLU(dw3(Linear(LN(x)))))))), in eval
    through the K1 kernel, in train through K7 and K8 with the hash
    dropout (sites 0 and 1 of one seed per GCFN), or, with ``seq_lens``,
    as that plain composition.
    Reference names: net1 = [LayerNorm, Linear F->6F], depthwise,
    net2 = [GLU, Dropout, Linear 3F->F, Dropout], Layer_scale."""

    def __init__(self, dim: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.norm_eps = norm_eps
        self.net1 = nn.ModuleList([nn.LayerNorm(dim, eps=norm_eps),
                                   nn.Linear(dim, 6 * dim)])
        self.depthwise = DepthwiseConv1d(6 * dim, 3, padding=1)
        self.net2 = nn.ModuleList([nn.Identity(), nn.Identity(),
                                   nn.Linear(3 * dim, dim), nn.Identity()])
        self.Layer_scale = LayerScale(dim)
        # K1 reads the products' weights [in, out]: store them so, as
        # transposed views with nn.Linear's [out, in] shape.  In-place
        # loads and inits, .to() and deepcopy keep the strides, so
        # weight.t() reaches the kernel without a copy.
        for lin in (self.net1[1], self.net2[2]):
            lin.weight = nn.Parameter(
                torch.empty(lin.in_features, lin.out_features).t())

    def forward(self, x: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        norm, proj_in = self.net1
        proj_out = self.net2[2]
        if train is not None and seq_lens is not None:
            y = proj_in(norm(x))
            # the k3 conv at the last valid frame reads a zero past it
            y = y * length_mask(seq_lens, y.shape[1], y.dtype)
            y = train.dropout(glu_last(self.depthwise(y)))
            return x + self.Layer_scale(train.dropout(proj_out(y)))
        params = (norm.weight, norm.bias, proj_in.weight.t(), proj_in.bias,
                  self.depthwise.weight.squeeze(1), self.depthwise.bias,
                  proj_out.weight.t(), proj_out.bias,
                  self.Layer_scale.layer_scale.reshape(-1))
        if train is not None:
            return fused_gcfn_train(x.contiguous(), params, self.norm_eps,
                                    train.kernel_seed(), train.p)
        return fused_gcfn(x.contiguous(), params, self.norm_eps, seq_lens)


def fused_pv_scores(q, k, pos_kt) -> torch.Tensor:
    """scores [B, H, lp, lp] = (QKᵀ + Q·pos_kt) / sqrt(d) at pos_kt's
    128-padded length lp (JAX ``blocks._fused_pv_scores``); q, k
    [B, t, H, d]."""
    b, _, h, d = q.shape
    lp = pos_kt.shape[0]
    qp = pad_time(q, lp).permute(0, 2, 1, 3)             # [B, H, lp, d]
    kp = pad_time(k, lp).permute(0, 2, 3, 1)             # [B, H, d, lp]
    scores = torch.matmul(qp, kp)
    # bias[b, h, i, j] = sum_d q[b, i, h, d] * pos_kt[i, d, j]
    qi = qp.permute(2, 0, 1, 3).reshape(lp, b * h, d)
    bias = torch.matmul(qi, pos_kt)                       # [lp, B*H, lp]
    scores += bias.reshape(lp, b, h, lp).permute(1, 2, 0, 3)
    return scores.div_(math.sqrt(d))


class MultiHeadAttention(nn.Module):
    """Pre-LN MHA with additive rel-pos bias (reference network.py:69-124);
    LayerScale on the output, no inner residual.  3D input attends over
    time on the fused_pv path: torch products for the scores at the
    128-padded length, then the K3 kernel for masked softmax·V in eval,
    K9 and K10 for masked softmax·dropout·V in train (padded lengths up
    to 512, as in the JAX package; past it the dense attention of JAX's
    "xla" train path).  In eval past ``FUSED_PV_MAX_LENGTH`` it runs K12
    on the unpadded q, k, v and the raw table instead, with no scores
    tensor.  4D input [B, S, T, F] attends over the speaker axis."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.layer_norm = nn.LayerNorm(dim, eps=norm_eps)
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.Layer_scale = LayerScale(dim)

    def _project_out(self, out: torch.Tensor,
                     train: Optional[TrainMode]) -> torch.Tensor:
        out = self.linear_out(out)
        if train is not None:
            out = train.dropout(out)
        return self.Layer_scale(out)

    def forward(self, x: torch.Tensor, pos: Optional[RelPos] = None,
                key_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        if x.dim() == 4:
            return self._speaker_axis_attention(x, train)
        b, t, _ = x.shape
        h = self.num_heads
        d = self.dim // h
        y = self.layer_norm(x)
        if flash_route(t, train is not None):
            out = flash_relpos_attention(
                self.linear_q(y), self.linear_k(y), self.linear_v(y),
                pos.table, pos.maxlen, key_lens)
            return self._project_out(out, None)
        q = self.linear_q(y).reshape(b, t, h, d)
        k = self.linear_k(y).reshape(b, t, h, d)
        v = self.linear_v(y)
        scores = fused_pv_scores(q, k, pos.pos_kt)
        lp = pos.pos_kt.shape[0]
        v = pad_time(v, lp).contiguous()
        if train is None:
            out = softmax_pv(scores, v, key_lens, t)
        elif lp <= TRAIN_PV_MAX_LENGTH:
            out = softmax_pv_dropout(scores, v, train.kernel_seed(),
                                     key_lens, t, train.p)
        else:
            out = self._dense_train_attention(scores, v, key_lens, t, train)
        return self._project_out(out[:, :t], train)

    def _dense_train_attention(self, scores, v, key_lens, t, train):
        """The JAX package's "xla" train attention (``blocks.py:755-792``),
        which it runs past the train kernel's padded length of 512: the
        unpadded scores, keys at or past ``key_lens`` masked, a float32
        softmax, ``TrainMode.dropout`` on the probabilities, then ·V.
        Returns [B, t, F]."""
        s = scores[:, :, :t, :t]
        if key_lens is not None:
            kmask = torch.arange(t, device=s.device)[None] < key_lens[:, None]
            s = torch.where(kmask[:, None, None, :], s,
                            torch.tensor(NEG_INF, device=s.device))
        attn = train.dropout(torch.softmax(s, dim=-1))
        b, h = s.shape[:2]
        vh = v[:, :t].reshape(b, t, h, -1).transpose(1, 2)
        return torch.matmul(attn, vh).transpose(1, 2).reshape(b, t, -1)

    def _speaker_axis_attention(self, x: torch.Tensor,
                                train: Optional[TrainMode]) -> torch.Tensor:
        """x [B, S, T, F]: attention over S at every (b, t).  For S == 2 the
        2-way softmax is a sigmoid of the score difference; in train each
        of the four probability maps drops on its own, unrenormalised."""
        b, s, t, f = x.shape
        h = self.num_heads
        d = self.dim // h
        y = self.layer_norm(x)
        q = self.linear_q(y).reshape(b, s, t, h, d)
        k = self.linear_k(y).reshape(b, s, t, h, d)
        v = self.linear_v(y).reshape(b, s, t, h, d)
        scale = 1.0 / math.sqrt(d)
        if s == 2:
            def head_scores(qq, kk):                      # [B, T, H]
                return (qq * kk).sum(dim=-1) * scale

            w00 = torch.sigmoid(head_scores(q[:, 0], k[:, 0])
                                - head_scores(q[:, 0], k[:, 1]))[..., None]
            w11 = torch.sigmoid(head_scores(q[:, 1], k[:, 1])
                                - head_scores(q[:, 1], k[:, 0]))[..., None]
            drop = train.dropout if train is not None else (lambda w: w)
            out0 = drop(w00) * v[:, 0] + drop(1.0 - w00) * v[:, 1]
            out1 = drop(w11) * v[:, 1] + drop(1.0 - w11) * v[:, 0]
            out = torch.stack([out0, out1], dim=1).reshape(b, s, t, f)
        else:
            scores = torch.einsum("bpthd,bqthd->bpqth", q, k) * scale
            attn = torch.softmax(scores.float(), dim=2).to(x.dtype)
            if train is not None:
                attn = train.dropout(attn)
            out = torch.einsum("bpqth,bqthd->bpthd", attn, v).reshape(
                b, s, t, f)
        return self._project_out(out, train)


class EGA(nn.Module):
    """Efficient Global Attention (reference network.py:126-155): pool to
    the bottleneck length, attend, nearest-upsample back, and gate into
    the residual: x + sigmoid(Linear(LN(x))) * up(attn(pool(x))).
    Reference names: block.self_attn, block.linear = [LayerNorm, Linear]."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.block = nn.ModuleDict({
            "self_attn": MultiHeadAttention(dim, num_heads, norm_eps),
            "linear": nn.ModuleList([nn.LayerNorm(dim, eps=norm_eps),
                                     nn.Linear(dim, dim)]),
        })

    def forward(self, x: torch.Tensor, pos: RelPos,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        t = x.shape[1]
        x_down = adaptive_avg_pool_time(x, pos.length)
        # the stage length is an exact multiple of the bottleneck length, so
        # a pool window is all valid or all padding
        pooled_lens = (seq_lens // (t // pos.length)
                       if seq_lens is not None else None)
        x_down = self.block["self_attn"](x_down, pos, key_lens=pooled_lens,
                                         train=train)
        norm, proj = self.block["linear"]
        gate = torch.sigmoid(proj(norm(x)))
        return x + gate * nearest_upsample_time(x_down, t)


class CLA(nn.Module):
    """Convolutional Local Attention (reference network.py:159-187):
    LN -> Linear F->2F -> GLU -> depthwise k65 SAME (backward K5) ->
    Linear F->2F -> BN -> GELU -> Linear 2F->F -> dropout, LayerScale
    residual."""

    def __init__(self, dim: int, kernel_size: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.layer_norm = nn.LayerNorm(dim, eps=norm_eps)
        self.linear1 = nn.Linear(dim, 2 * dim)
        self.dw_conv_1d = DepthwiseConv1d(dim, kernel_size, padding="SAME")
        self.linear2 = nn.Linear(dim, 2 * dim)
        self.BN = BatchNorm(2 * dim, eps=norm_eps)
        self.linear3 = nn.ModuleList([nn.Identity(),
                                      nn.Linear(2 * dim, dim)])
        self.Layer_scale = LayerScale(dim)

    def forward(self, x: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        y = glu_last(self.linear1(self.layer_norm(x)))
        if seq_lens is not None:
            # the k65 conv reads 32 frames past the valid length: zeros there
            y = y * length_mask(seq_lens, y.shape[1], y.dtype)
        y = self.dw_conv_1d(y)
        y = gelu_exact(self.BN(self.linear2(y), train))
        y = self.linear3[1](y)
        if train is not None:
            y = train.dropout(y)
        return x + self.Layer_scale(y)


class GlobalBlock(nn.Module):
    """EGA + GCFN (reference network.py:189-209)."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.block = nn.ModuleDict({"ega": EGA(dim, num_heads, norm_eps),
                                    "gcfn": GCFN(dim, norm_eps)})

    def forward(self, x, pos: RelPos, seq_lens=None, train=None):
        x = self.block["ega"](x, pos, seq_lens, train)
        return self.block["gcfn"](x, seq_lens, train)


class LocalBlock(nn.Module):
    """CLA + GCFN (reference network.py:212-224)."""

    def __init__(self, dim: int, kernel_size: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.block = nn.ModuleDict({"cla": CLA(dim, kernel_size, norm_eps),
                                    "gcfn": GCFN(dim, norm_eps)})

    def forward(self, x, seq_lens=None, train=None):
        x = self.block["cla"](x, seq_lens, train)
        return self.block["gcfn"](x, seq_lens, train)


class SpkAttention(nn.Module):
    """Cross-speaker transformer (reference network.py:227-252): residual
    MHA over the speaker axis of [B*S, T, F] rows, then a GCFN."""

    def __init__(self, dim: int, num_heads: int, num_spks: int,
                 norm_eps: float = 1.0e-5):
        super().__init__()
        self.num_spks = num_spks
        self.self_attn = MultiHeadAttention(dim, num_heads, norm_eps)
        self.feed_forward = GCFN(dim, norm_eps)

    def forward(self, x, seq_lens=None, train=None):
        bs, t, f = x.shape
        y = x.reshape(bs // self.num_spks, self.num_spks, t, f)
        y = (y + self.self_attn(y, train=train)).reshape(bs, t, f)
        return self.feed_forward(y, seq_lens, train)


class DownConvLayer(nn.Module):
    """Depthwise k5 stride-2 conv + BatchNorm + GELU (reference
    module.py:66-83); halves the time axis."""

    def __init__(self, dim: int, kernel_size: int = 5,
                 norm_eps: float = 1.0e-5):
        super().__init__()
        self.down_conv = DepthwiseConv1d(dim, kernel_size, stride=2,
                                         padding=(kernel_size - 1) // 2)
        self.BN = BatchNorm(dim, eps=norm_eps)

    def forward(self, x, seq_lens=None, train=None):
        if seq_lens is not None:
            # the last valid output reads one frame past the valid length
            x = x * length_mask(seq_lens, x.shape[1], x.dtype)
        return gelu_exact(self.BN(self.down_conv(x), train))


class SpkSplitStage(nn.Module):
    """Early speaker split (reference module.py:110-125): 1x1 conv
    F->4F*S, GLU, 1x1 conv -> F*S, [B, T, S*F] -> [B*S, T, F], then
    GroupNorm(1, F) over each row's valid frames."""

    def __init__(self, dim: int, num_spks: int, group_norm_eps: float = 1e-8):
        super().__init__()
        self.dim, self.num_spks = dim, num_spks
        self.linear = nn.ModuleList([
            Conv1x1(dim, 4 * dim * num_spks), nn.Identity(),
            Conv1x1(2 * dim * num_spks, dim * num_spks)])
        self.norm = MaskedGroupNorm(dim, group_norm_eps)

    def forward(self, x, seq_lens=None):
        b, t, _ = x.shape
        y = self.linear[2](glu_last(self.linear[0](x)))
        y = y.reshape(b, t, self.num_spks, self.dim).transpose(1, 2)
        y = y.reshape(b * self.num_spks, t, self.dim)
        lens = (None if seq_lens is None
                else torch.repeat_interleave(seq_lens, self.num_spks))
        return self.norm(y, lens)
