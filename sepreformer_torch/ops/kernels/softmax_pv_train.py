"""K9 and K10: masked softmax · hash dropout · V for training, forward
and backward.

Replace ``sepreformer_tpu/ops/pallas/softmax_pv_train.py::
softmax_pv_dropout`` (forward ``_fwd_impl``, backward ``_bwd_impl``).
The CUDA kernels are ``sepreformer_torch/csrc/softmax_pv_train.cu``;
``softmax_pv_dropout_plain`` and ``softmax_pv_dropout_bwd_plain`` are the
same math in PyTorch (the JAX package's ``softmax_pv_dropout_reference``
and the formulas of its ``_bwd_kernel``).  The dropout mask is the JAX
package's hash mask (``hash_dropout.keep_mask``), so both packages drop
the same probabilities for the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.hash_dropout import (
    keep_mask,
    seed_word,
    threshold,
)
from sepreformer_torch.ops.kernels.softmax_pv import (
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    _key_lens,
)

MAX_LENGTH = 512   # the JAX package's train kernel's padded-length limit


def _drop_scale(seed: int, b: int, h: int, lp: int, p: float,
                device) -> torch.Tensor:
    """[B, H, Lp, Lp] keep / (1 - p) at site 0, row (b*H + h)*Lp + i,
    column j."""
    rows = (torch.arange(b * h, device=device).reshape(b, h, 1, 1) * lp
            + torch.arange(lp, device=device).reshape(1, 1, lp, 1))
    cols = torch.arange(lp, device=device).reshape(1, 1, 1, lp)
    return keep_mask(seed, 0, rows, cols, p) / (1.0 - p)


def _probs(scores, lens, length):
    """Masked f32 softmax of scores over the keys."""
    b, _, lp, _ = scores.shape
    key_len = _key_lens(b, length, lens, scores.device)
    kmask = torch.arange(lp, device=scores.device)[None] < key_len[:, None]
    s = torch.where(kmask[:, None, None, :], scores.float(),
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
                             length: Optional[int] = None, p: float = 0.0
                             ) -> torch.Tensor:
    """scores [B, H, Lp, Lp] (already scaled), v [B, Lp, H*d] -> [B, Lp,
    H*d]: keys j >= min(length, lens[b]) masked, f32 softmax, hash dropout
    with ``seed`` at rate ``p`` (no renormalisation), then ·V."""
    b, h, lp, _ = scores.shape
    length = lp if length is None else length
    probs = _probs(scores, lens, length)
    if p > 0.0:
        probs = probs * _drop_scale(seed, b, h, lp, p, scores.device)
    return _channels_last(torch.matmul(probs, _heads(v, h)))


def softmax_pv_dropout_bwd_plain(scores, v, seed, lens, length, p, dout
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dScores, dV) of ``softmax_pv_dropout_plain`` for the output
    cotangent ``dout`` [B, Lp, H*d]: dV = Pdᵀ·dOut, dP = (dOut·Vᵀ) ∘
    keep/(1-p), dS = P ∘ (dP - rowsum(dP ∘ P))."""
    b, h, lp, _ = scores.shape
    probs = _probs(scores, lens, lp if length is None else length)
    scale = (_drop_scale(seed, b, h, lp, p, scores.device) if p > 0.0
             else torch.ones((), device=scores.device))
    g = _heads(dout, h)
    dv = torch.matmul((probs * scale).transpose(-1, -2), g)
    dp = torch.matmul(g, _heads(v, h).transpose(-1, -2)) * scale
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    return ds, _channels_last(dv)


def _check(scores, v, length):
    b, h, lp, _ = scores.shape
    f = v.shape[-1]
    if f % h or f // h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"softmax_pv_dropout: head dim {f}/{h} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not 1 <= length <= lp:
        raise ValueError(f"softmax_pv_dropout: length {length} outside "
                         f"[1, {lp}]")
    _build.check_tensor(scores, "softmax_pv_dropout scores", (b, h, lp, lp),
                        scores.device)
    _build.check_tensor(v, "softmax_pv_dropout v", (b, lp, f), scores.device)
    return b, h, lp, f


def _hash_args(seed, p):
    return (seed_word(seed, 0), threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p))


def softmax_pv_train_fwd(scores, v, seed, key_len, length, p):
    """K9 on CUDA tensors: (out [B, Lp, F], row max and row sum [B, H,
    Lp]); ``key_len`` int32 [B], each >= 1."""
    b, h, lp, f = _check(scores, v, length)
    out = torch.empty_like(v)
    row_max = torch.empty((b, h, lp), dtype=torch.float32,
                          device=scores.device)
    row_sum = torch.empty_like(row_max)
    err = _build.library().sep_softmax_pv_train_fwd_f32(
        scores.data_ptr(), v.data_ptr(), key_len.data_ptr(), out.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), b, h, lp, f, length,
        *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_train_fwd_f32", err)
    softmax_pv_train_fwd.launches += 1
    return out, row_max, row_sum


def softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum, seed,
                         key_len, length, p):
    """K10 on CUDA tensors: (dScores [B, H, Lp, Lp], dV [B, Lp, F]) from
    K9's inputs and outputs and the output cotangent ``dout``."""
    b, h, lp, f = _check(scores, v, length)
    for name, a in (("out", out), ("dout", dout)):
        _build.check_tensor(a, f"softmax_pv_dropout {name}", (b, lp, f),
                            scores.device)
    for name, a in (("row_max", row_max), ("row_sum", row_sum)):
        _build.check_tensor(a, f"softmax_pv_dropout {name}", (b, h, lp),
                            scores.device)
    ds = torch.empty_like(scores)
    dv = torch.empty_like(v)
    err = _build.library().sep_softmax_pv_train_bwd_f32(
        scores.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), key_len.data_ptr(),
        ds.data_ptr(), dv.data_ptr(), b, h, lp, f, length,
        *_hash_args(seed, p), _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_train_bwd_f32", err)
    softmax_pv_train_bwd.launches += 1
    return ds, dv


softmax_pv_train_fwd.launches = 0
softmax_pv_train_bwd.launches = 0


class _SoftmaxPvDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, v, seed, key_len, length, p):
        out, row_max, row_sum = softmax_pv_train_fwd(scores, v, seed,
                                                     key_len, length, p)
        ctx.save_for_backward(scores, v, out, row_max, row_sum, key_len)
        ctx.args = (seed, length, p)
        return out

    @staticmethod
    def backward(ctx, dout):
        scores, v, out, row_max, row_sum, key_len = ctx.saved_tensors
        seed, length, p = ctx.args
        ds, dv = softmax_pv_train_bwd(scores, v, out, dout.contiguous(),
                                      row_max, row_sum, seed, key_len,
                                      length, p)
        return ds, dv, None, None, None, None


def softmax_pv_dropout(scores: torch.Tensor, v: torch.Tensor, seed: int,
                       lens: Optional[torch.Tensor] = None,
                       length: Optional[int] = None, p: float = 0.0
                       ) -> torch.Tensor:
    """Masked softmax(scores) with attention-prob hash dropout, times V,
    with a gradient: scores [B, H, Lp, Lp] float32 (1/sqrt(d) applied),
    v [B, Lp, H*d] channels-last, ``seed`` the int hash seed, ``lens`` [B]
    key lengths or None, ``length`` the true length (rows past it are
    padding the caller drops), ``p`` the drop rate.  CPU tensors take the
    plain version and its autograd; CUDA tensors launch K9, and K10 in
    the backward.  Lp is at most 512, as in the JAX package."""
    lp = scores.shape[2]
    length = lp if length is None else int(length)
    if lp > MAX_LENGTH:
        raise NotImplementedError(
            f"softmax_pv_dropout: padded length {lp} > {MAX_LENGTH}; the "
            f"caller takes the dense train attention there "
            f"(MultiHeadAttention._dense_train_attention)")
    if scores.device.type == "cpu":
        return softmax_pv_dropout_plain(scores, v, seed, lens, length, p)
    key_len = _key_lens(scores.shape[0], length, lens,
                        scores.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _SoftmaxPvDropout.apply(scores, v, int(seed), key_len, length,
                                   float(p))
