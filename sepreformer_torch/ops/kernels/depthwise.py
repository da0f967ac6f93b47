"""K5: the backward of the CLA's large-kernel "same" depthwise conv.

Replaces the backward of ``sepreformer_tpu/ops/pallas/depthwise.py::
depthwise_large`` (``_impl_bwd``).  ``depthwise_large`` is an autograd
function: its forward is the library convolution (``F.conv1d``, cuDNN on
the card), as the JAX package's forward is XLA's; its backward launches
the CUDA kernel ``sepreformer_torch/csrc/depthwise.cu`` for CUDA tensors
and runs ``depthwise_bwd_plain``, the same tap loop in PyTorch, for CPU
tensors.  Tensors are channels-last [B, T, C]; the weight is the Conv1d
weight [C, 1, K] (odd K), read and written in that layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sepreformer_torch.ops.kernels import _build

MAX_KERNEL = 81   # the kernel's shared-memory tiles hold K - 1 halo rows
CHUNK_ROWS = 256  # time steps per block of the kernel (kTT * kTiles)


def depthwise_forward(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The "same" depthwise conv: [B, T, C] -> [B, T, C]."""
    half = (weight.shape[-1] - 1) // 2
    xp = F.pad(x.transpose(1, 2), (half, half))
    return F.conv1d(xp, weight, bias, groups=x.shape[-1]).transpose(1, 2)


def depthwise_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                        dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [B, T, C], dw [C, 1, K], db [C]) of ``depthwise_forward``, as
    the tap loop of the JAX package's ``_bwd_kernel``."""
    k = weight.shape[-1]
    half = (k - 1) // 2
    t = x.shape[1]
    w = weight[:, 0, :]                                   # [C, K]
    xp = F.pad(x, (0, 0, half, half))
    dyp = F.pad(dy, (0, 0, half, half))
    dx = torch.zeros_like(dy)
    dw = torch.empty_like(weight)
    for tap in range(k):
        dx += dyp[:, k - 1 - tap:k - 1 - tap + t] * w[:, tap]
        dw[:, 0, tap] = (xp[:, tap:tap + t] * dy).sum(dim=(0, 1))
    return dx, dw, dy.sum(dim=(0, 1))


def depthwise_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``depthwise_bwd_plain`` for CPU tensors; the kernel for CUDA
    tensors."""
    if x.device.type == "cpu":
        return depthwise_bwd_plain(x, weight, dy)
    b, t, c = x.shape
    k = weight.shape[-1]
    if k % 2 == 0 or k > MAX_KERNEL:
        raise ValueError(f"depthwise_bwd: kernel {k} is not odd <= "
                         f"{MAX_KERNEL}")
    _build.check_tensor(x, "depthwise x", (b, t, c), x.device, align=4)
    _build.check_tensor(dy, "depthwise dy", (b, t, c), x.device, align=4)
    _build.check_tensor(weight, "depthwise weight", (c, 1, k), x.device,
                        align=4)
    # per-block partial sums of dw and db, added up by the kernel's
    # second pass
    scratch = torch.empty(b * -(-t // CHUNK_ROWS) * (k + 1) * c,
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    err = _build.library().sep_depthwise_bwd_f32(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), scratch.data_ptr(), scratch.numel(),
        b, t, c, k,
        _build.stream_handle(x.device))
    _build.check_launch("sep_depthwise_bwd_f32", err)
    depthwise_bwd.launches += 1
    return dx, dw, db


depthwise_bwd.launches = 0


class _DepthwiseLarge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return depthwise_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = depthwise_bwd(x.contiguous(), weight, dy.contiguous())
        return dx, dw, db if ctx.has_bias else None


def depthwise_large(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"Same" depthwise conv of x [B, T, C] with weight [C, 1, K] (odd K)
    and bias [C]; its backward is K5."""
    return _DepthwiseLarge.apply(x, weight, bias)
