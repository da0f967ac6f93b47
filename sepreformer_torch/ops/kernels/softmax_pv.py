"""K3: masked softmax·V (eval).

Replaces ``sepreformer_tpu/ops/pallas/softmax_pv.py::softmax_pv``.  The
CUDA kernel is ``sepreformer_torch/csrc/softmax_pv.cu``;
``softmax_pv_plain`` is the same math in PyTorch (the JAX package's
``softmax_pv_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch

from sepreformer_torch.ops.kernels import _build

NEG_INF = -1.0e30
SUPPORTED_HEAD_DIMS = (16,)


def _key_lens(b: int, length: int, lens: Optional[torch.Tensor],
              device) -> torch.Tensor:
    if lens is None:
        return torch.full((b,), length, dtype=torch.int32, device=device)
    return torch.clamp(lens.to(device=device, dtype=torch.int32), max=length)


def softmax_pv_plain(scores: torch.Tensor, v: torch.Tensor,
                     lens: Optional[torch.Tensor] = None,
                     length: Optional[int] = None) -> torch.Tensor:
    """scores [B, H, Lp, Lp] (already scaled), v [B, Lp, H*d] -> [B, Lp,
    H*d]: keys j >= min(length, lens[b]) get -1e30, f32 softmax over the
    keys, then ·V.  Rows past ``length`` are padding the caller drops."""
    b, h, lp, _ = scores.shape
    d = v.shape[-1] // h
    length = lp if length is None else length
    key_len = _key_lens(b, length, lens, scores.device)
    kmask = torch.arange(lp, device=scores.device)[None] < key_len[:, None]
    masked = torch.where(kmask[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    attn = torch.softmax(masked.float(), dim=-1).to(v.dtype)
    vh = v.reshape(b, lp, h, d).permute(0, 2, 1, 3)       # [B, H, Lp, d]
    out = torch.matmul(attn, vh)                          # [B, H, Lp, d]
    return out.permute(0, 2, 1, 3).reshape(b, lp, h * d)


def softmax_pv(scores: torch.Tensor, v: torch.Tensor,
               lens: Optional[torch.Tensor] = None,
               length: Optional[int] = None) -> torch.Tensor:
    """Masked softmax(scores)·V with channels-last V and output.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    needs every ``lens[b] >= 1`` (a row with no valid key cannot occur on
    the model's path) and has no backward: it raises where autograd would
    record the call."""
    if scores.device.type == "cpu":
        return softmax_pv_plain(scores, v, lens, length)
    _build.check_no_grad("softmax_pv", scores, v)
    b, h, lp, _ = scores.shape
    f = v.shape[-1]
    length = lp if length is None else int(length)
    if f % h or f // h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"softmax_pv: head dim {f}/{h} not in {SUPPORTED_HEAD_DIMS}")
    if not 1 <= length <= lp:
        raise ValueError(f"softmax_pv: length {length} outside [1, {lp}]")
    _build.check_tensor(scores, "softmax_pv scores", (b, h, lp, lp),
                        scores.device)
    _build.check_tensor(v, "softmax_pv v", (b, lp, f), scores.device)
    key_len = _key_lens(b, length, lens, scores.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    out = torch.empty_like(v)
    err = _build.library().sep_softmax_pv_f32(
        scores.data_ptr(), v.data_ptr(), key_len.data_ptr(), out.data_ptr(),
        b, h, lp, f, length, _build.stream_handle(scores.device))
    _build.check_launch("sep_softmax_pv_f32", err)
    softmax_pv.launches += 1
    return out


softmax_pv.launches = 0
