"""Separator building blocks, channels-last [B, T, F].

Each class mirrors the JAX package's ``models/blocks.py`` class of the
same name; its ``TorchLinear`` and ``TorchLayerNorm`` are ``nn.Linear``
and ``nn.LayerNorm`` here, and its ``FoldableBatchNorm`` is
``BatchNorm`` (``folded()`` gives the affine K15 takes).  Submodules
carry the reference model's state_dict names (``linear_q``, ``net1.1``,
``Layer_scale`` ...), so a reference checkpoint loads with
``load_state_dict(strict=True)`` and ``models/convert.py`` maps the flax
trees onto them.

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
of the CLA's k65 depthwise conv (K5, or K6 under the depthwise module's
``BWD_MODE = "conv"``), the GCFN with hash dropout (K7, K8; with
``seq_lens`` the plain composition, as in JAX) and the
softmax·dropout·V pair (K9, K10; past a padded length of 512 the dense
attention that the JAX package's "xla" train path runs).  The config's
``attention_impl`` and ``attention_train_impl`` pick other attention
routes, as in the JAX package (``attention_route``): among them K13/K14,
the single-block attention with the bias and the dropout in the kernel.
Its ``fused_local`` and ``fused_pair`` take the fused blocks where
``fused_route`` allows: the CLA through K15, and the EGA tail with the
GCFN after it through K16.  Everything else is plain PyTorch.

A bfloat16 stream (``ModelConfig.compute_dtype``) follows the JAX
package's policy module by module: parameters stay float32 and each
product, convolution and LayerScale casts its weights to the stream's
dtype through ``stream_param``, once per weight in a serving forward
(``Linear``, ``Conv1x1``, ``DepthwiseConv1d``, ``LayerScale``);
the norms compute in float32 and cast back (``LayerNorm``,
``BatchNorm``, ``MaskedGroupNorm``); the attention scores are float32
products of the upcast q and k (stored in ``RelPos.scores_dtype`` for
K3), and the softmaxes run in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sepreformer_torch.ops.kernels import (
    depthwise_large,
    flash_relpos_attention,
    flash_relpos_attention_train,
    fused_cla,
    fused_ega_tail_gcfn,
    fused_gcfn,
    fused_gcfn_train,
    softmax_pv,
    softmax_pv_dropout,
)
from sepreformer_torch.ops.kernels.attention_train import (
    MAX_LENGTH as SINGLE_MAX_LENGTH,
)
from sepreformer_torch.ops.kernels.gcfn import pick_block
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


# the routes of a global attention: "fused_pv" (scores through K2's
# pos_kt, then K3 in eval, K9/K10 in train), "dense" (the same scores,
# a torch softmax), "flash" (K12 on the raw table, eval) and "single"
# (K13/K14 on the raw table)
POS_KT_ROUTES = ("fused_pv", "dense")


def attention_route(impl: str, train_impl: str, length: int,
                    train_p: Optional[float], has_key_lens: bool) -> str:
    """The route of every global attention of a forward at bottleneck
    ``length``, from the config's ``attention_impl`` and
    ``attention_train_impl``, the train dropout ``train_p`` (None in
    eval) and whether key lengths are given; the JAX package's order
    (``models/blocks.py`` ``MultiHeadAttention``).  Routes in
    ``POS_KT_ROUTES`` read K2's pos_kt; the others read the raw table.

    Train: without key lengths the train route first ("auto" and
    "fused_pv": K9/K10 up to a padded length of 512; "pallas": K13/K14 up
    to 512); then "single" at dropout 0 up to 512; with key lengths
    K9/K10 take them as before; else dense.  Eval "single" and train
    "pallas" take the dense attention past 512, as JAX's do.  Eval: "auto"
    is K2/K3 up to ``FUSED_PV_MAX_LENGTH`` and K12 past it; "fused_pv" is
    K2/K3, "pallas" K12, "xla" dense.  In train only "single" of the eval
    routes is taken: where JAX trains through K3 or K12 at dropout 0 with
    their reference VJPs, the port takes the dense attention, as it did
    before K3 and K12 had gradients (their plain-recompute backward,
    ``ops/kernels/_autograd.py``)."""
    single_ok = length <= SINGLE_MAX_LENGTH
    if train_p is not None:
        pv_ok = (train_impl in ("auto", "fused_pv")
                 and -(-length // 128) * 128 <= TRAIN_PV_MAX_LENGTH)
        if not has_key_lens and pv_ok:
            return "fused_pv"
        if not has_key_lens and train_impl == "pallas" and single_ok:
            return "single"
        if impl == "single" and train_p == 0.0 and single_ok:
            return "single"
        return "fused_pv" if pv_ok else "dense"
    if impl == "auto":
        return "flash" if length > FUSED_PV_MAX_LENGTH else "fused_pv"
    if impl == "single":
        return "single" if single_ok else "dense"
    return {"fused_pv": "fused_pv", "pallas": "flash", "xla": "dense"}[impl]


def fused_route(mode: str, length: int, train_p: Optional[float],
                has_seq_lens: bool, train_ok: bool) -> bool:
    """Whether a fused block takes its kernel at stage length ``length``,
    train dropout ``train_p`` (None in eval) and with or without
    ``seq_lens``: the JAX package's rules (``models/blocks.py`` ``CLA``
    and ``GlobalBlock``).  It needs ``mode`` "on" ("auto" is off, as the
    JAX package resolves it), no ``seq_lens``, and ``pick_block(length)
    > 0``; in train only where ``train_ok`` and the dropout is 0.  A
    LocalBlock's CLA (K15, ``fused_local``) passes ``train_ok=False``: it
    runs in eval only (BatchNorm on the running statistics).  A
    GlobalBlock's EGA tail and GCFN (K16, ``fused_pair``) pass True."""
    mode_ok = train_p is None or (train_ok and train_p == 0.0)
    return (mode == "on" and mode_ok and not has_seq_lens
            and pick_block(length) > 0)


def store_in_out(*linears: nn.Linear) -> None:
    """Store each Linear's weight [in, out] in memory, as a transposed view
    with ``nn.Linear``'s [out, in] shape, so that ``weight.t()`` reaches a
    kernel that streams [in, out] rows without a copy.  In-place loads and
    inits, ``.to()`` and deepcopy keep the strides."""
    for lin in linears:
        lin.weight = nn.Parameter(
            torch.empty(lin.in_features, lin.out_features).t())


def stream_param(p: Optional[torch.Tensor],
                 dtype: torch.dtype) -> Optional[torch.Tensor]:
    """Parameter ``p`` (or None) in the stream's ``dtype``; ``p`` itself
    when the dtypes match.  Outside autograd (a forward under ``no_grad``
    or ``inference_mode``, as the serving entries run) the cast is made
    once and kept on ``p`` until ``p`` changes: a write in place
    (``load_state_dict``, an optimizer step, an init) moves its version
    counter, a move to another device its storage.  (A write through
    ``p.data`` moves neither.)  With grad enabled it casts on every call,
    so that the gradient reaches ``p``."""
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled() or p.is_inference():
        return p.to(dtype)
    key = (dtype, p.data_ptr(), p._version)
    held = getattr(p, "_stream_cast", None)
    if held is None or held[0] != key:
        held = p._stream_cast = (key, p.to(dtype))
    return held[1]


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 weight and bias are cast to the input's
    dtype (the JAX package's ``TorchLinear``): parameters stay float32
    under a bfloat16 stream."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, stream_param(self.weight, x.dtype),
                        stream_param(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with float32 statistics and a result in the
    input's dtype (the JAX package's ``TorchLayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


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
    the routes that read the raw table), the raw [2*maxlen, d] table K12
    and K13 read, and the config's two attention routes, from which
    every attention and the encoding that built this context take the
    same ``attention_route``; ``scores_dtype`` stores the scores that K3
    reads."""

    length: int
    pos_kt: Optional[torch.Tensor]
    table: Optional[torch.Tensor] = None
    maxlen: int = 0
    impl: str = "auto"
    train_impl: str = "auto"
    scores_dtype: torch.dtype = torch.float32


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
        return F.linear(x, stream_param(self.weight, x.dtype)[:, :, 0],
                        stream_param(self.bias, x.dtype))


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
        w = stream_param(self.weight, x.dtype)
        b = stream_param(self.bias, x.dtype)
        if self.large:
            return depthwise_large(x, w, b)
        lo, hi = self._pads()
        xp = F.pad(x.transpose(1, 2), (lo, hi))
        y = F.conv1d(xp, w, b, stride=self.stride, groups=x.shape[-1])
        return y.transpose(1, 2)


class LayerScale(nn.Module):
    """Residual-branch scale, parameter [1, 1, F] (reference dims=3)."""

    def __init__(self, dim: int):
        super().__init__()
        self.layer_scale = nn.Parameter(torch.empty(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * stream_param(self.layer_scale, x.dtype).reshape(-1)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, under the reference's parameter and
    buffer names.  Eval normalises with the running statistics; train
    with the batch's, var = mean(x²) - mean² (biased, as flax), which
    also update the running ones: r = 0.9 r + 0.1 batch.  (PyTorch's
    ``BatchNorm1d`` would update ``running_var`` with the unbiased
    variance.)  A variance that roundoff takes below 0 counts as 0, as
    flax's ``nn.BatchNorm`` has it.  It computes in float32 and returns
    the input's dtype."""

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
        dtype, x = x.dtype, x.float()
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
                + self.bias).to(dtype)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval normalisation as an affine x·s + t: s = γ·rsqrt(running
        var + eps), t = β − running mean·s (the JAX package's
        ``FoldableBatchNorm(return_folded=True)``), in torch, so that γ
        and β get gradients through the fold."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s


class MaskedGroupNorm(nn.Module):
    """GroupNorm(1, C) of channels-last [B, T, C] whose statistics span the
    first ``lens[b]`` frames of row b (all frames when ``lens`` is None);
    the affine map applies to every frame.  It computes in float32 and
    returns the input's dtype."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor,
                lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype, x = x.dtype, x.float()
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
                + self.bias).to(dtype)


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
        self.net1 = nn.ModuleList([LayerNorm(dim, eps=norm_eps),
                                   Linear(dim, 6 * dim)])
        self.depthwise = DepthwiseConv1d(6 * dim, 3, padding=1)
        self.net2 = nn.ModuleList([nn.Identity(), nn.Identity(),
                                   Linear(3 * dim, dim), nn.Identity()])
        self.Layer_scale = LayerScale(dim)
        # K1, K7/K8 and K16 read the products' weights [in, out]
        store_in_out(self.net1[1], self.net2[2])

    def params(self) -> tuple:
        """The kernels' parameter tuple (``gcfn_plain``'s order)."""
        norm, proj_in = self.net1
        proj_out = self.net2[2]
        return (norm.weight, norm.bias, proj_in.weight.t(), proj_in.bias,
                self.depthwise.weight.squeeze(1), self.depthwise.bias,
                proj_out.weight.t(), proj_out.bias,
                self.Layer_scale.layer_scale.reshape(-1))

    def forward(self, x: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        if train is not None and seq_lens is not None:
            norm, proj_in = self.net1
            y = proj_in(norm(x))
            # the k3 conv at the last valid frame reads a zero past it
            y = y * length_mask(seq_lens, y.shape[1], y.dtype)
            y = train.dropout(glu_last(self.depthwise(y)))
            return x + self.Layer_scale(train.dropout(self.net2[2](y)))
        params = self.params()
        if train is not None:
            return fused_gcfn_train(x.contiguous(), params, self.norm_eps,
                                    train.kernel_seed(), train.p)
        return fused_gcfn(x.contiguous(), params, self.norm_eps, seq_lens)


def fused_pv_scores(q, k, pos_kt,
                    scores_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """scores [B, H, lp, lp] = (QKᵀ + Q·pos_kt) / sqrt(d) at pos_kt's
    128-padded length lp (JAX ``blocks._fused_pv_scores``), stored in
    ``scores_dtype``; q, k [B, t, H, d].  The products take q and k
    upcast to float32 (exact), as JAX's take their bfloat16 operands
    with float32 results (``preferred_element_type``)."""
    b, _, h, d = q.shape
    q, k = q.float(), k.float()
    lp = pos_kt.shape[0]
    qp = pad_time(q, lp).permute(0, 2, 1, 3)             # [B, H, lp, d]
    kp = pad_time(k, lp).permute(0, 2, 3, 1)             # [B, H, d, lp]
    scores = torch.matmul(qp, kp)
    # bias[b, h, i, j] = sum_d q[b, i, h, d] * pos_kt[i, d, j]
    qi = qp.permute(2, 0, 1, 3).reshape(lp, b * h, d)
    bias = torch.matmul(qi, pos_kt)                       # [lp, B*H, lp]
    scores += bias.reshape(lp, b, h, lp).permute(1, 2, 0, 3)
    return scores.div_(math.sqrt(d)).to(scores_dtype)


class MultiHeadAttention(nn.Module):
    """Pre-LN MHA with additive rel-pos bias (reference network.py:69-124);
    LayerScale on the output, no inner residual.  3D input attends over
    time on the route ``attention_route`` picks: "fused_pv", torch
    products for the scores at the 128-padded length, then the K3 kernel
    for masked softmax·V in eval, K9 and K10 for masked softmax·dropout·V
    in train; "dense", the same scores and a torch softmax (JAX's "xla"
    path); "flash", K12 on the unpadded q, k, v and the raw table, with
    no scores tensor (eval); "single", K13 (K14 in the backward) on
    [B, H, L, d] and the raw table, with the dropout in the kernel.  4D
    input [B, S, T, F] attends over the speaker axis."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.layer_norm = LayerNorm(dim, eps=norm_eps)
        self.linear_q = Linear(dim, dim)
        self.linear_k = Linear(dim, dim)
        self.linear_v = Linear(dim, dim)
        self.linear_out = Linear(dim, dim)
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
        route = attention_route(pos.impl, pos.train_impl, t,
                                None if train is None else train.p,
                                key_lens is not None)
        if route == "flash":
            # the table in the stream's dtype (JAX blocks.py:729)
            out = flash_relpos_attention(
                self.linear_q(y), self.linear_k(y), self.linear_v(y),
                stream_param(pos.table, y.dtype), pos.maxlen, key_lens)
            return self._project_out(out, None)
        q = self.linear_q(y).reshape(b, t, h, d)
        k = self.linear_k(y).reshape(b, t, h, d)
        v = self.linear_v(y)
        if route == "single":
            seed, p = (0, 0.0) if train is None else (train.kernel_seed(),
                                                      train.p)
            out = flash_relpos_attention_train(
                q.transpose(1, 2), k.transpose(1, 2),
                v.reshape(b, t, h, d).transpose(1, 2), pos.table, seed,
                pos.maxlen, p, key_lens)
            return self._project_out(out.transpose(1, 2).reshape(b, t, -1),
                                     train)
        scores = fused_pv_scores(q, k, pos.pos_kt, pos.scores_dtype)
        v = pad_time(v, pos.pos_kt.shape[0]).contiguous()
        if route == "dense":
            out = self._dense_attention(scores, v, key_lens, t, train)
        elif train is None:
            out = softmax_pv(scores, v, key_lens, t)
        else:
            out = softmax_pv_dropout(scores, v, train.kernel_seed(),
                                     key_lens, t, train.p)
        return self._project_out(out[:, :t], train)

    def _dense_attention(self, scores, v, key_lens, t, train):
        """The JAX package's "xla" attention (``blocks.py:755-795``), which
        its train path runs past the kernels' padded length of 512: the
        unpadded scores, keys at or past ``key_lens`` masked, a float32
        softmax cast to V's dtype, in train ``TrainMode.dropout`` on the
        probabilities, then ·V in V's dtype.  Returns [B, t, F]."""
        s = scores[:, :, :t, :t]
        if key_lens is not None:
            kmask = torch.arange(t, device=s.device)[None] < key_lens[:, None]
            s = torch.where(kmask[:, None, None, :], s,
                            torch.tensor(NEG_INF, device=s.device))
        attn = torch.softmax(s.float(), dim=-1).to(v.dtype)
        if train is not None:
            attn = train.dropout(attn)
        b, h = s.shape[:2]
        vh = v[:, :t].reshape(b, t, h, -1).transpose(1, 2)
        return torch.matmul(attn, vh).transpose(1, 2).reshape(b, t, -1)

    def _speaker_axis_attention(self, x: torch.Tensor,
                                train: Optional[TrainMode]) -> torch.Tensor:
        """x [B, S, T, F]: attention over S at every (b, t).  For S == 2 the
        2-way softmax is a sigmoid of the score difference; in train each
        of the four probability maps drops on its own, unrenormalised.
        Scores and probabilities are float32, the probabilities cast to
        the stream's dtype before ·V (JAX ``blocks.py:830-865``)."""
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
                return (qq * kk).float().sum(dim=-1) * scale

            w00 = torch.sigmoid(head_scores(q[:, 0], k[:, 0])
                                - head_scores(q[:, 0], k[:, 1]))[..., None]
            w11 = torch.sigmoid(head_scores(q[:, 1], k[:, 1])
                                - head_scores(q[:, 1], k[:, 0]))[..., None]

            def drop(w):
                w = train.dropout(w) if train is not None else w
                return w.to(x.dtype)

            out0 = drop(w00) * v[:, 0] + drop(1.0 - w00) * v[:, 1]
            out1 = drop(w11) * v[:, 1] + drop(1.0 - w11) * v[:, 0]
            out = torch.stack([out0, out1], dim=1).reshape(b, s, t, f)
        else:
            scores = torch.einsum("bpthd,bqthd->bpqth", q.float(),
                                  k.float()) * scale
            attn = torch.softmax(scores.float(), dim=2).to(x.dtype)
            if train is not None:
                attn = train.dropout(attn)
            out = torch.einsum("bpqth,bqthd->bpthd", attn, v).reshape(
                b, s, t, f)
        return self._project_out(out, train)


class EGA(nn.Module):
    """Efficient Global Attention (reference network.py:126-155): pool to
    the bottleneck length, attend, nearest-upsample back, and gate into
    the residual: x + sigmoid(Linear(LN(x))) * up(attn(pool(x))).  With
    ``fused_tail`` it stops after the attention and returns (its output
    at the bottleneck length, the gate's (LN scale, LN bias, weight
    [in, out], bias)) for K16.
    Reference names: block.self_attn, block.linear = [LayerNorm, Linear]."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5):
        super().__init__()
        self.block = nn.ModuleDict({
            "self_attn": MultiHeadAttention(dim, num_heads, norm_eps),
            "linear": nn.ModuleList([LayerNorm(dim, eps=norm_eps),
                                     Linear(dim, dim)]),
        })
        store_in_out(self.block["linear"][1])  # K16 reads the gate [in, out]

    def forward(self, x: torch.Tensor, pos: RelPos,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None,
                fused_tail: bool = False):
        t = x.shape[1]
        x_down = adaptive_avg_pool_time(x, pos.length)
        # the stage length is an exact multiple of the bottleneck length, so
        # a pool window is all valid or all padding
        pooled_lens = (seq_lens // (t // pos.length)
                       if seq_lens is not None else None)
        x_down = self.block["self_attn"](x_down, pos, key_lens=pooled_lens,
                                         train=train)
        norm, proj = self.block["linear"]
        if fused_tail:
            return x_down, (norm.weight, norm.bias, proj.weight.t(),
                            proj.bias)
        gate = torch.sigmoid(proj(norm(x)))
        return x + gate * nearest_upsample_time(x_down, t)


class CLA(nn.Module):
    """Convolutional Local Attention (reference network.py:159-187):
    LN -> Linear F->2F -> GLU -> depthwise k65 SAME (backward K5) ->
    Linear F->2F -> BN -> GELU -> Linear 2F->F -> dropout, LayerScale
    residual.  Where ``fused_route`` allows (``fused`` "on", eval, no
    ``seq_lens``), the whole block is one K15 call with the BatchNorm
    folded."""

    def __init__(self, dim: int, kernel_size: int, norm_eps: float = 1.0e-5,
                 fused: str = "auto"):
        super().__init__()
        self.fused = fused
        self.layer_norm = LayerNorm(dim, eps=norm_eps)
        self.linear1 = Linear(dim, 2 * dim)
        self.dw_conv_1d = DepthwiseConv1d(dim, kernel_size, padding="SAME")
        self.linear2 = Linear(dim, 2 * dim)
        self.BN = BatchNorm(2 * dim, eps=norm_eps)
        self.linear3 = nn.ModuleList([nn.Identity(),
                                      Linear(2 * dim, dim)])
        self.Layer_scale = LayerScale(dim)
        # K15 reads the three products' weights [in, out]
        store_in_out(self.linear1, self.linear2, self.linear3[1])

    def forward(self, x: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        if fused_route(self.fused, x.shape[1],
                       None if train is None else train.p,
                       seq_lens is not None, train_ok=False):
            bn_s, bn_t = self.BN.folded()
            dw = self.dw_conv_1d
            params = (self.layer_norm.weight, self.layer_norm.bias,
                      self.linear1.weight.t(), self.linear1.bias,
                      dw.weight[:, 0, :].t(), dw.bias,
                      self.linear2.weight.t(), self.linear2.bias, bn_s, bn_t,
                      self.linear3[1].weight.t(), self.linear3[1].bias,
                      self.Layer_scale.layer_scale.reshape(-1))
            return fused_cla(x.contiguous(), params, self.layer_norm.eps)
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
    """EGA + GCFN (reference network.py:189-209).  Where ``fused_route``
    allows (``fused_pair`` "on", no ``seq_lens``, eval or dropout 0), the
    EGA's tail and the GCFN are one K16 call on the attention's output."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1.0e-5,
                 fused_pair: str = "auto"):
        super().__init__()
        self.fused_pair = fused_pair
        self.block = nn.ModuleDict({"ega": EGA(dim, num_heads, norm_eps),
                                    "gcfn": GCFN(dim, norm_eps)})

    def forward(self, x, pos: RelPos, seq_lens=None, train=None):
        ega, gcfn = self.block["ega"], self.block["gcfn"]
        if fused_route(self.fused_pair, x.shape[1],
                       None if train is None else train.p,
                       seq_lens is not None, train_ok=True):
            if ega.block["linear"][0].eps != gcfn.norm_eps:
                # K16 normalises the gate's LN and the GCFN's with one eps
                raise ValueError(
                    f"fused_pair: the EGA gate's LayerNorm eps "
                    f"{ega.block['linear'][0].eps} differs from the GCFN's "
                    f"{gcfn.norm_eps}")
            x_down, gate_params = ega(x, pos, train=train, fused_tail=True)
            return fused_ega_tail_gcfn(x.contiguous(), x_down.contiguous(),
                                       gate_params, gcfn.params(),
                                       gcfn.norm_eps)
        x = ega(x, pos, seq_lens, train)
        return gcfn(x, seq_lens, train)


class LocalBlock(nn.Module):
    """CLA + GCFN (reference network.py:212-224)."""

    def __init__(self, dim: int, kernel_size: int, norm_eps: float = 1.0e-5,
                 fused_local: str = "auto"):
        super().__init__()
        self.block = nn.ModuleDict({"cla": CLA(dim, kernel_size, norm_eps,
                                               fused_local),
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
