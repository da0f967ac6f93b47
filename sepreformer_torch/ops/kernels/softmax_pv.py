"""K3: masked softmax·V (eval), and K3b, its two-tensor form.

Replaces ``sepreformer_tpu/ops/pallas/softmax_pv.py::softmax_pv``, with
``bias=`` its ``_softmax_pv2_impl``.  The CUDA kernels are
``sepreformer_torch/csrc/softmax_pv.cu``; ``softmax_pv_plain`` is the
same math in PyTorch, in the order the JAX kernel takes it
(``softmax_pv.py:94-103``).  On CUDA tensors the gradient recomputes
``softmax_pv_plain``, as the JAX package's ``custom_vjp`` recomputes its
reference.  K3 takes scores and V each in float32 or bfloat16 (the
output in V's dtype), through an instance per pairing, at Base's and
Large's head widths; at the T, S and M presets' head widths (8, 12, 20)
float32 alone.  K3b takes float32 alone, at 16 and 32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad

NEG_INF = -1.0e30
# K3's instances: the T, S and M presets' head widths 8, 12 and 20
# (float32), Base's 16 and Large's 32 (float32 and bfloat16); K3b's: 16
# and 32 (float32)
SUPPORTED_HEAD_DIMS = (8, 12, 16, 20, 32)
BIAS_HEAD_DIMS = (16, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
BF16_HEAD_DIMS = (16, 32)


def _key_lens(b: int, length: int, lens: Optional[torch.Tensor],
              device) -> torch.Tensor:
    if lens is None:
        return torch.full((b,), length, dtype=torch.int32, device=device)
    return torch.clamp(lens.to(device=device, dtype=torch.int32), max=length)


def softmax_pv_plain(scores: torch.Tensor, v: torch.Tensor,
                     lens: Optional[torch.Tensor] = None,
                     length: Optional[int] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores [B, H, Lp, Lp] (already scaled), v [B, Lp, H*d] -> [B, Lp,
    H*d] in V's dtype: the scores (and ``bias``, a second scores tensor,
    optional, added to them) in float32, keys j >= min(length, lens[b])
    at -1e30, a float32 softmax over the keys, then ·V.  A bfloat16 V
    takes the JAX kernel's order instead: p = exp(s - max) and its sum l
    in float32, p rounded to bfloat16, ·V with float32 sums, then / l
    (normalizing before the rounding would differ by a bfloat16 ulp).
    Rows past ``length`` are padding the caller drops."""
    scores = scores.float()
    if bias is not None:
        scores = scores + bias.float()
    b, h, lp, _ = scores.shape
    d = v.shape[-1] // h
    length = lp if length is None else length
    key_len = _key_lens(b, length, lens, scores.device)
    kmask = torch.arange(lp, device=scores.device)[None] < key_len[:, None]
    masked = torch.where(kmask[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    vh = v.reshape(b, lp, h, d).permute(0, 2, 1, 3)       # [B, H, Lp, d]
    if v.dtype == torch.float32:
        out = torch.matmul(torch.softmax(masked, dim=-1), vh)
    else:
        p = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
        out = (torch.matmul(p.to(v.dtype).float(), vh.float())
               / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, lp, h * d)


def _launch(scores: torch.Tensor, v: torch.Tensor, key_len: torch.Tensor,
            length: int, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K3, or K3b with ``bias``, on checked CUDA tensors (no autograd):
    K3's float32 instance, or the one for its bfloat16 pairing."""
    if bias is not None:
        return softmax_pv_bias(scores, bias, v, key_len, length)
    b, h, lp, _ = scores.shape
    out = torch.empty_like(v)
    args = (scores.data_ptr(), v.data_ptr(), key_len.data_ptr(),
            out.data_ptr(), b, h, lp, v.shape[-1], length)
    instance = dtype_instance(scores.dtype, v.dtype)
    if instance:
        entry = "sep_softmax_pv_bf16"
        args += (int(scores.dtype == torch.bfloat16),
                 int(v.dtype == torch.bfloat16))
    else:
        entry = "sep_softmax_pv_f32"
    err = getattr(_build.library(), entry)(
        *args, _build.stream_handle(scores.device))
    _build.check_launch(entry, err)
    _build.count_launch(softmax_pv, instance)
    return out


def dtype_instance(scores_dtype: torch.dtype, v_dtype: torch.dtype) -> str:
    """The name of K3's instance for this pairing: "" (float32), "bf16"
    (V bfloat16), "bf16 scores" (both), "bf16 scores f32 v"."""
    if scores_dtype == torch.float32:
        return "" if v_dtype == torch.float32 else "bf16"
    return "bf16 scores" if v_dtype == torch.bfloat16 else "bf16 scores f32 v"


def softmax_pv_bias(scores: torch.Tensor, bias: torch.Tensor,
                    v: torch.Tensor, key_len: torch.Tensor,
                    length: int) -> torch.Tensor:
    """K3b's launch on checked CUDA tensors (no autograd): the kernel of
    ``softmax_pv(..., bias=bias)``, with ``key_len`` int32 [B]."""
    b, h, lp, _ = scores.shape
    out = torch.empty_like(v)
    err = _build.library().sep_softmax_pv_bias_f32(
        scores.data_ptr(), bias.data_ptr(), v.data_ptr(), key_len.data_ptr(),
        out.data_ptr(), b, h, lp, v.shape[-1], length,
        _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_bias_f32", err)
    softmax_pv_bias.launches += 1
    return out


def _with_grad(kernel, scores, v, key_len, length, bias):
    """``kernel(scores, v, key_len, length, bias)`` with the gradient of
    ``softmax_pv_plain`` with respect to scores, v and bias, as the JAX
    package's ``_bwd`` returns (dscores, dv, dbias)."""
    return with_plain_grad(
        lambda s, vv, kl, bb: kernel(s, vv, kl, length, bb),
        lambda s, vv, kl, bb: softmax_pv_plain(s, vv, kl, length, bb),
        scores, v, key_len, bias)


def softmax_pv(scores: torch.Tensor, v: torch.Tensor,
               lens: Optional[torch.Tensor] = None,
               length: Optional[int] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked softmax(scores [+ bias])·V with channels-last V and output
    (in V's dtype; scores and V float32 or bfloat16, float32 alone with
    ``bias``).  CPU tensors take the plain version; CUDA tensors launch K3
    (K3b with ``bias``, a second [B, H, Lp, Lp] float32 tensor), which
    needs every
    ``lens[b] >= 1`` (a row with no valid key cannot occur on the model's
    path); their gradient recomputes the plain version."""
    if bias is not None:  # K3b: float32 alone, on either device
        for a in (scores, bias, v):
            _build.check_dtype("softmax_pv (bias=)", a)
    if scores.device.type == "cpu":
        return softmax_pv_plain(scores, v, lens, length, bias)
    b, h, lp, _ = scores.shape
    f = v.shape[-1]
    length = lp if length is None else int(length)
    if f % h:
        raise ValueError(f"softmax_pv: width {f} is not a multiple of the "
                         f"{h} heads")
    if bias is None:
        _build.check_width("softmax_pv", "head dim", f // h,
                           SUPPORTED_HEAD_DIMS, _build.OTHER_PRESETS)
        for a in (scores, v):
            _build.check_dtype("softmax_pv", a,
                               _build.dtypes_at(f // h, BF16_HEAD_DIMS))
    else:
        _build.check_width("softmax_pv (bias=)", "head dim", f // h,
                           BIAS_HEAD_DIMS, _build.OTHER_PRESETS)
    if not 1 <= length <= lp:
        raise ValueError(f"softmax_pv: length {length} outside [1, {lp}]")
    _build.check_tensor(scores, "softmax_pv scores", (b, h, lp, lp),
                        scores.device, scores.dtype)
    if bias is not None:
        _build.check_tensor(bias, "softmax_pv bias", (b, h, lp, lp),
                            scores.device)
    _build.check_tensor(v, "softmax_pv v", (b, lp, f), scores.device,
                        v.dtype)
    key_len = _key_lens(b, length, lens, scores.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _with_grad(_launch, scores, v, key_len, length, bias)


def tile_occupancy(entry: str, form: str, wide: Tuple[str, ...] = ()
                   ) -> Dict[str, Dict[str, int]]:
    """Blocks per SM, registers, local (spill) bytes and warps per block of
    the kernels that ``entry`` reports (csrc/softmax_pv_tile.cuh's
    ``occupancy``: ``form`` at SPLIT 1 and 2, then its bias form, then
    each form of ``wide`` ("" the one-tensor form, "b" the bias form) at
    head width 32), on the current card."""
    names = [f"{form}{b} split {s}" for b in ("", "b") for s in (1, 2)]
    names += [f"{form}{b} d=32 split {s}" for b in wide for s in (1, 2)]
    out = (ctypes.c_int * (4 * len(names)))()
    _build.check_launch(entry, getattr(_build.library(), entry)(
        ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(names)}


def occupancy() -> Dict[str, Dict[str, int]]:
    """K3's and K3b's launches, at head widths 16 and 32, on the current
    card."""
    return tile_occupancy("sep_softmax_pv_occupancy", "K3", wide=("", "b"))


def width_occupancy(d: int) -> Dict[str, Dict[str, int]]:
    """K3's float32 instance at a T, S or M preset's head width ``d`` at
    SPLIT 1 and 2 on the current card: blocks per SM, registers, local
    (spill) bytes, warps."""
    out = (ctypes.c_int * 8)()
    _build.check_launch("sep_softmax_pv_width_occupancy", _build.library()
                        .sep_softmax_pv_width_occupancy(
                            d, ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    return {f"K3 d={d} split {s}": dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, s in enumerate((1, 2))}


softmax_pv.launches = 0
softmax_pv.instance_launches = {}
softmax_pv_bias.launches = 0
