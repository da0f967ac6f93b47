"""K9 and K10: masked softmax · hash dropout · V for training, forward
and backward; K9b and K10b, the same on the sum of two scores tensors.

Replace ``sepreformer_tpu/ops/pallas/softmax_pv_train.py::
softmax_pv_dropout`` (forward ``_fwd_impl``, backward ``_bwd_impl``, each
with ``has_bias`` False and True).
The CUDA kernels are ``sepreformer_torch/csrc/softmax_pv_train.cu``;
``softmax_pv_dropout_plain`` and ``softmax_pv_dropout_bwd_plain`` are the
same math in PyTorch (the JAX package's ``softmax_pv_dropout_reference``
and the formulas of its ``_bwd_kernel``).  The dropout mask is the JAX
package's hash mask (``hash_dropout.keep_mask``), so both packages drop
the same probabilities for the same seed.

K9 and K10 also take bfloat16 streams, through instances for each
pairing the routes reach: float32 scores with a bfloat16 V (a bfloat16
``compute_dtype``), bfloat16 scores with a bfloat16 V, and bfloat16
scores with a float32 V (``scores_dtype="bfloat16"`` in a float32 step).
They take the JAX kernels' rounding steps (``softmax_pv_train.py:96-112``
and ``:160-186``): the softmax and its statistics stay float32; with a
bfloat16 V, e * keep / (1 - p) is rounded to bfloat16 before ·V and the
float32 sum is divided by l after, and in the backward Pd is rounded
before dV and dP sums the exact products of the bfloat16 dOut and V;
dS comes in the scores' dtype and dV in V's.  K9's bfloat16-V instances
also write the float32 output of the unrounded weights (``out32``),
whose dot with dOut is rowsum(dP * P) as the JAX kernel sums it; K10
reads it in place of the rounded output.  The bias forms stay float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.hash_dropout import (
    keep_mask,
    seed_word,
    threshold,
)
from sepreformer_torch.ops.kernels.softmax_pv import (
    NEG_INF,
    _key_lens,
    dtype_instance,
    tile_occupancy,
)

MAX_LENGTH = 512   # the JAX package's train kernel's padded-length limit
# K9/K10's (and K9b/K10b's) instances: Base's head width 16 and Large's 32
TRAIN_HEAD_DIMS = (16, 32)
# the dtypes of K9's and K10's scores and V (the bias forms: float32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _drop_scale(seed: int, b: int, h: int, lp: int, p: float,
                device) -> torch.Tensor:
    """[B, H, Lp, Lp] keep / (1 - p) at site 0, row (b*H + h)*Lp + i,
    column j."""
    rows = (torch.arange(b * h, device=device).reshape(b, h, 1, 1) * lp
            + torch.arange(lp, device=device).reshape(1, 1, lp, 1))
    cols = torch.arange(lp, device=device).reshape(1, 1, 1, lp)
    return keep_mask(seed, 0, rows, cols, p) / (1.0 - p)


def _probs(scores, lens, length, bias=None):
    """Masked f32 softmax of scores (+ bias, summed in f32) over the
    keys."""
    b, _, lp, _ = scores.shape
    key_len = _key_lens(b, length, lens, scores.device)
    kmask = torch.arange(lp, device=scores.device)[None] < key_len[:, None]
    s = scores.float() if bias is None else scores.float() + bias.float()
    s = torch.where(kmask[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=scores.device))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _heads(v, h):
    b, lp, f = v.shape
    return v.reshape(b, lp, h, f // h).permute(0, 2, 1, 3)   # [B, H, Lp, d]


def _channels_last(x):
    b, h, lp, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, lp, h * d)


def softmax_pv_dropout_plain(scores: torch.Tensor, v: torch.Tensor,
                             seed: int, lens: Optional[torch.Tensor] = None,
                             length: Optional[int] = None, p: float = 0.0,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """scores [B, H, Lp, Lp] (already scaled), v [B, Lp, H*d] -> [B, Lp,
    H*d] in V's dtype: ``bias`` (a second scores tensor, optional) added
    in f32, keys j >= min(length, lens[b]) masked, f32 softmax, hash
    dropout with ``seed`` at rate ``p`` (no renormalisation), then ·V.
    A bfloat16 V takes the JAX kernel's order: e = exp(s - max) and its
    sum l in float32, e * keep / (1 - p) rounded to bfloat16, ·V with
    float32 sums, then / l."""
    b, h, lp, _ = scores.shape
    length = lp if length is None else length
    if v.dtype != torch.float32:
        return _out32(scores, v, seed, lens, length, p, rounded=True
                      ).to(v.dtype)
    probs = _probs(scores, lens, length, bias)
    if p > 0.0:
        probs = probs * _drop_scale(seed, b, h, lp, p, scores.device)
    return _channels_last(torch.matmul(probs, _heads(v, h)))


def _out32(scores, v, seed, lens, length, p, rounded):
    """The float32 output of the JAX kernel's order (the docstring above)
    for a bfloat16 V: with ``rounded`` the weights rounded to V's dtype
    (K9's output before its cast), else not (K9's out32)."""
    b, h, lp, _ = scores.shape
    key_len = _key_lens(b, length, lens, scores.device)
    kmask = torch.arange(lp, device=scores.device)[None] < key_len[:, None]
    s = torch.where(kmask[:, None, None, :], scores.float(),
                    torch.tensor(NEG_INF, device=scores.device))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    if p > 0.0:
        e = e * _drop_scale(seed, b, h, lp, p, scores.device)
    if rounded:
        e = e.to(v.dtype).float()
    return _channels_last(torch.matmul(e, _heads(v, h).float()) / l)


def softmax_pv_dropout_bwd_plain(scores, v, seed, lens, length, p, dout,
                                 bias=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dScores, dV) of ``softmax_pv_dropout_plain`` for the output
    cotangent ``dout`` [B, Lp, H*d]: dV = Pdᵀ·dOut, dP = (dOut·Vᵀ) ∘
    keep/(1-p), dS = P ∘ (dP - rowsum(dP ∘ P)), dS in the scores' dtype
    and dV in V's.  With ``bias``, dS is also its cotangent.  A bfloat16
    V takes the JAX kernel's steps: dOut in V's dtype, Pd rounded to it
    before dV, dP from the exact products of dOut and V, float32 sums."""
    b, h, lp, _ = scores.shape
    probs = _probs(scores, lens, lp if length is None else length, bias)
    scale = (_drop_scale(seed, b, h, lp, p, scores.device) if p > 0.0
             else torch.ones((), device=scores.device))
    g = _heads(dout.to(v.dtype), h).float()
    pd = (probs * scale).to(v.dtype).float()
    dv = torch.matmul(pd.transpose(-1, -2), g)
    dp = torch.matmul(g, _heads(v, h).float().transpose(-1, -2)) * scale
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    return ds.to(scores.dtype), _channels_last(dv).to(v.dtype)


def _check(scores, v, length, bias=None):
    b, h, lp, _ = scores.shape
    f = v.shape[-1]
    if f % h:
        raise ValueError(f"softmax_pv_dropout: width {f} is not a multiple "
                         f"of the {h} heads")
    _build.check_width("softmax_pv_dropout", "head dim", f // h,
                       TRAIN_HEAD_DIMS, _build.OTHER_PRESETS)
    if not 1 <= length <= lp:
        raise ValueError(f"softmax_pv_dropout: length {length} outside "
                         f"[1, {lp}]")
    _build.check_tensor(scores, "softmax_pv_dropout scores", (b, h, lp, lp),
                        scores.device, scores.dtype)
    if bias is not None:
        _build.check_tensor(bias, "softmax_pv_dropout bias", (b, h, lp, lp),
                            scores.device)
    _build.check_tensor(v, "softmax_pv_dropout v", (b, lp, f), scores.device,
                        v.dtype)
    return b, h, lp, f


def _hash_args(seed, p):
    return (seed_word(seed, 0), threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p))


def _train_fwd(entry, scores, bias, v, seed, key_len, length, p):
    b, h, lp, f = _check(scores, v, length, bias)
    out = torch.empty_like(v)
    row_max = torch.empty((b, h, lp), dtype=torch.float32,
                          device=scores.device)
    row_sum = torch.empty_like(row_max)
    inputs = (scores,) if bias is None else (scores, bias)
    err = getattr(_build.library(), entry)(
        *(a.data_ptr() for a in inputs), v.data_ptr(), key_len.data_ptr(),
        out.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(), b, h, lp, f,
        length, *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch(entry, err)
    return out, row_max, row_sum


def _train_bwd(entry, scores, bias, v, out, dout, row_max, row_sum, seed,
               key_len, length, p):
    b, h, lp, f = _check(scores, v, length, bias)
    for name, a in (("out", out), ("dout", dout)):
        _build.check_tensor(a, f"softmax_pv_dropout {name}", (b, lp, f),
                            scores.device)
    for name, a in (("row_max", row_max), ("row_sum", row_sum)):
        _build.check_tensor(a, f"softmax_pv_dropout {name}", (b, h, lp),
                            scores.device)
    ds = torch.empty_like(scores)
    dv = torch.empty_like(v)
    inputs = (scores,) if bias is None else (scores, bias)
    err = getattr(_build.library(), entry)(
        *(a.data_ptr() for a in inputs), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
        key_len.data_ptr(), ds.data_ptr(), dv.data_ptr(), b, h, lp, f, length,
        *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch(entry, err)
    return ds, dv


def softmax_pv_train_fwd_bf16(scores, v, seed, key_len, length, p):
    """K9's bfloat16 instances on CUDA tensors (scores and V each float32
    or bfloat16, one at least bfloat16): (out [B, Lp, F] in V's dtype,
    out32, the float32 output K10 reads (out itself for a float32 V),
    row max and row sum [B, H, Lp]); counted as K9's instance
    ``softmax_pv.dtype_instance``."""
    b, h, lp, f = _check(scores, v, length)
    out = torch.empty_like(v)
    v_bf16 = v.dtype == torch.bfloat16
    out32 = (torch.empty(v.shape, dtype=torch.float32, device=v.device)
             if v_bf16 else out)
    row_max = torch.empty((b, h, lp), dtype=torch.float32,
                          device=scores.device)
    row_sum = torch.empty_like(row_max)
    err = _build.library().sep_softmax_pv_train_fwd_bf16(
        scores.data_ptr(), v.data_ptr(), key_len.data_ptr(), out.data_ptr(),
        out32.data_ptr() if v_bf16 else None, row_max.data_ptr(),
        row_sum.data_ptr(), b, h, lp, f, length,
        int(scores.dtype == torch.bfloat16), int(v_bf16),
        *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_train_fwd_bf16", err)
    _build.count_launch(softmax_pv_train_fwd,
                        dtype_instance(scores.dtype, v.dtype))
    return out, out32, row_max, row_sum


def softmax_pv_train_bwd_bf16(scores, v, out32, dout, row_max, row_sum,
                              seed, key_len, length, p):
    """K10's bfloat16 instances on CUDA tensors: (dScores in the scores'
    dtype, dV in V's) from K9's inputs, its ``out32`` and the output
    cotangent ``dout`` (in V's dtype); counted as K10's instance."""
    b, h, lp, f = _check(scores, v, length)
    _build.check_tensor(out32, "softmax_pv_dropout out32", (b, lp, f),
                        scores.device)
    _build.check_tensor(dout, "softmax_pv_dropout dout", (b, lp, f),
                        scores.device, v.dtype)
    for name, a in (("row_max", row_max), ("row_sum", row_sum)):
        _build.check_tensor(a, f"softmax_pv_dropout {name}", (b, h, lp),
                            scores.device)
    ds = torch.empty_like(scores)
    dv = torch.empty_like(v)
    err = _build.library().sep_softmax_pv_train_bwd_bf16(
        scores.data_ptr(), v.data_ptr(), out32.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), key_len.data_ptr(),
        ds.data_ptr(), dv.data_ptr(), b, h, lp, f, length,
        int(scores.dtype == torch.bfloat16), int(v.dtype == torch.bfloat16),
        *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_train_bwd_bf16", err)
    _build.count_launch(softmax_pv_train_bwd,
                        dtype_instance(scores.dtype, v.dtype))
    return ds, dv


def softmax_pv_train_fwd(scores, v, seed, key_len, length, p):
    """K9 on CUDA tensors: (out [B, Lp, F], row max and row sum [B, H,
    Lp]); ``key_len`` int32 [B], each >= 1."""
    res = _train_fwd("sep_softmax_pv_train_fwd_f32", scores, None, v, seed,
                     key_len, length, p)
    softmax_pv_train_fwd.launches += 1
    return res


def softmax_pv_train_fwd_bias(scores, bias, v, seed, key_len, length, p):
    """K9b: K9 on scores + bias, ``bias`` [B, H, Lp, Lp]."""
    res = _train_fwd("sep_softmax_pv_train_fwd_bias_f32", scores, bias, v,
                     seed, key_len, length, p)
    softmax_pv_train_fwd_bias.launches += 1
    return res


def softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum, seed,
                         key_len, length, p):
    """K10 on CUDA tensors: (dScores [B, H, Lp, Lp], dV [B, Lp, F]) from
    K9's inputs and outputs and the output cotangent ``dout``."""
    res = _train_bwd("sep_softmax_pv_train_bwd_f32", scores, None, v, out,
                     dout, row_max, row_sum, seed, key_len, length, p)
    softmax_pv_train_bwd.launches += 1
    return res


def softmax_pv_train_bwd_bias(scores, bias, v, out, dout, row_max, row_sum,
                              seed, key_len, length, p):
    """K10b: K10 from K9b's inputs and outputs; dScores is also the
    bias's cotangent."""
    res = _train_bwd("sep_softmax_pv_train_bwd_bias_f32", scores, bias, v,
                     out, dout, row_max, row_sum, seed, key_len, length, p)
    softmax_pv_train_bwd_bias.launches += 1
    return res


def bwd_blocks_per_sm() -> Dict[str, int]:
    """How many blocks of K10 and of K10b, at head widths 16 and 32, one
    SM of the current card holds at once, with the launches' shared-memory
    attributes set."""
    blocks = (ctypes.c_int * 4)()
    _build.check_launch("sep_softmax_pv_train_bwd_blocks_per_sm",
                        _build.library().sep_softmax_pv_train_bwd_blocks_per_sm(
                            ctypes.addressof(blocks)))
    return dict(zip(("K10", "K10b", "K10 d=32", "K10b d=32"), blocks))


def fwd_occupancy():
    """K9's and K9b's launches on the current card, at head widths 16 and
    32 (``tile_occupancy``)."""
    return tile_occupancy("sep_softmax_pv_train_fwd_occupancy", "K9",
                          wide=("", "b"))


softmax_pv_train_fwd.launches = 0
softmax_pv_train_bwd.launches = 0
softmax_pv_train_fwd.instance_launches = {}
softmax_pv_train_bwd.instance_launches = {}
softmax_pv_train_fwd_bias.launches = 0
softmax_pv_train_bwd_bias.launches = 0


class _SoftmaxPvDropout(torch.autograd.Function):
    """K9 (K9b) and K10 (K10b) in the instance the dtypes pick; on CPU
    tensors the plain versions, with ``softmax_pv_dropout_bwd_plain`` as
    the backward (an autograd through the rounding would round the
    gradients too)."""

    @staticmethod
    def forward(ctx, scores, v, seed, key_len, length, p, bias):
        ctx.args = (seed, length, p)
        if scores.device.type == "cpu":
            ctx.save_for_backward(scores, v, key_len, bias)
            return softmax_pv_dropout_plain(scores, v, seed, key_len, length,
                                            p, bias)
        if scores.dtype != torch.float32 or v.dtype != torch.float32:
            # K10 reads out32, the unrounded weights' float32 output
            out, dot_out, row_max, row_sum = softmax_pv_train_fwd_bf16(
                scores, v, seed, key_len, length, p)
        elif bias is None:
            out, row_max, row_sum = softmax_pv_train_fwd(
                scores, v, seed, key_len, length, p)
            dot_out = out
        else:
            out, row_max, row_sum = softmax_pv_train_fwd_bias(
                scores, bias, v, seed, key_len, length, p)
            dot_out = out
        ctx.save_for_backward(scores, v, key_len, bias, dot_out, row_max,
                              row_sum)
        return out

    @staticmethod
    def backward(ctx, dout):
        seed, length, p = ctx.args
        scores, v, key_len, bias, *stats = ctx.saved_tensors
        dout = dout.contiguous()
        if scores.device.type == "cpu":
            ds, dv = softmax_pv_dropout_bwd_plain(scores, v, seed, key_len,
                                                  length, p, dout, bias)
        elif scores.dtype != torch.float32 or v.dtype != torch.float32:
            ds, dv = softmax_pv_train_bwd_bf16(scores, v, stats[0], dout,
                                               *stats[1:], seed, key_len,
                                               length, p)
        elif bias is None:
            ds, dv = softmax_pv_train_bwd(scores, v, stats[0], dout,
                                          *stats[1:], seed, key_len, length,
                                          p)
        else:
            ds, dv = softmax_pv_train_bwd_bias(scores, bias, v, stats[0],
                                               dout, *stats[1:], seed,
                                               key_len, length, p)
        if bias is None:
            return ds, dv, None, None, None, None, None
        # the add distributes dS to both; each gets a tensor of its own, so
        # that autograd accumulating into one in place cannot touch the other
        need_s, need_b = ctx.needs_input_grad[0], ctx.needs_input_grad[6]
        dbias = (ds.clone() if need_s else ds) if need_b else None
        return ds if need_s else None, dv, None, None, None, None, dbias


def softmax_pv_dropout(scores: torch.Tensor, v: torch.Tensor, seed: int,
                       lens: Optional[torch.Tensor] = None,
                       length: Optional[int] = None, p: float = 0.0,
                       bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Masked softmax(scores [+ bias]) with attention-prob hash dropout,
    times V, with a gradient: scores [B, H, Lp, Lp] (1/sqrt(d) applied)
    and v [B, Lp, H*d] channels-last, each float32 or bfloat16 (the
    output in V's dtype), ``seed`` the int hash seed, ``lens`` [B] key
    lengths or None, ``length`` the true length (rows past it are padding
    the caller drops), ``p`` the drop rate, ``bias`` an optional second
    scores tensor summed in f32 (float32 alone, with float32 scores and
    V).  CPU tensors take the plain versions, forward and backward; CUDA
    tensors launch K9 (K9b with ``bias``), and K10 (K10b) in the
    backward.  Lp is at most 512, as in the JAX package."""
    lp = scores.shape[2]
    length = lp if length is None else int(length)
    if bias is None:
        for a in (scores, v):
            _build.check_dtype("softmax_pv_dropout", a, SUPPORTED_DTYPES)
    else:
        for a in (scores, bias, v):  # float32 alone, on either device
            _build.check_dtype("softmax_pv_dropout (bias=)", a)
    if lp > MAX_LENGTH:
        raise NotImplementedError(
            f"softmax_pv_dropout: padded length {lp} > {MAX_LENGTH}; the "
            f"caller takes the dense train attention there "
            f"(MultiHeadAttention._dense_attention)")
    key_len = _key_lens(scores.shape[0], length, lens,
                        scores.device).contiguous()
    if lens is not None and scores.device.type != "cpu":
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _SoftmaxPvDropout.apply(scores, v, int(seed), key_len, length,
                                   float(p), bias)
