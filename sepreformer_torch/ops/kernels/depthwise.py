"""K4, K5 and K6: the CLA's large-kernel "same" depthwise conv: K4 its
forward, K5 and K6 its backward.

Replaces the backward of ``sepreformer_tpu/ops/pallas/depthwise.py::
depthwise_large``.  ``depthwise_large`` is an autograd function: its
forward is the library convolution (``F.conv1d``, cuDNN on the card), as
the JAX package's forward is XLA's.  Its backward follows ``BWD_MODE``,
as the JAX module's does: "fused" (the default) launches K5
(``_impl_bwd``: dx, dw and db in one tap loop); "conv" takes dx as the
library convolution of dy with the time-flipped kernel, as the JAX
package takes it from XLA, and dw and db from K6 (``_impl_bwd_w``).  K4
(``depthwise_fwd``) is the JAX package's Pallas forward (``_impl_fwd``),
which no route of either package takes.  The CUDA kernels are
``sepreformer_torch/csrc/depthwise.cu``: all three walk tiles of rows
staged by cp.async through register windows; K4 launches once, K5 and
K6 twice each (the tiles, with one partial sum of dw and db per block,
and then the partials' sum in a fixed order); ``occupancy`` reports
their launch on the card.  ``depthwise_fwd_plain``,
``depthwise_bwd_plain`` and ``depthwise_bwd_w_plain`` are the same
functions in PyTorch, which CPU tensors run.  Tensors are channels-last
[B, T, C]; the weight is the Conv1d weight [C, 1, K] (odd K), read and
written in that layout.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sepreformer_torch.ops.kernels import _build

MAX_KERNEL = 81   # the kernels' shared-memory tiles hold K - 1 halo rows
# the backward's route, a module constant as in the JAX module: "fused"
# (K5) or "conv" (dx by the library convolution, dw and db by K6)
BWD_MODE = "fused"


def depthwise_forward(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The "same" depthwise conv: [B, T, C] -> [B, T, C]."""
    half = (weight.shape[-1] - 1) // 2
    xp = F.pad(x.transpose(1, 2), (half, half))
    return F.conv1d(xp, weight, bias, groups=x.shape[-1]).transpose(1, 2)


def depthwise_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """K4's function, the "same" depthwise conv with zero padding: the JAX
    package's ``depthwise_reference``."""
    return depthwise_forward(x, weight, bias)


def depthwise_fwd(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """K4: ``depthwise_fwd_plain`` for CPU tensors; the kernel for CUDA
    tensors (no backward: it raises where autograd would record it).
    float32 alone, on either device."""
    _build.check_dtype("depthwise_fwd", x)
    if x.device.type == "cpu":
        return depthwise_fwd_plain(x, weight, bias)
    _build.check_no_grad("depthwise_fwd", x, weight, bias)
    b, t, c = x.shape
    k = weight.shape[-1]
    if k % 2 == 0 or k > MAX_KERNEL:
        raise ValueError(f"depthwise_fwd: kernel {k} is not odd <= "
                         f"{MAX_KERNEL}")
    _build.check_tensor(x, "depthwise_fwd x", (b, t, c), x.device, align=4)
    _build.check_tensor(weight, "depthwise_fwd weight", (c, 1, k), x.device,
                        align=4)
    _build.check_tensor(bias, "depthwise_fwd bias", (c,), x.device, align=4)
    out = torch.empty_like(x)
    err = _build.library().sep_depthwise_fwd_f32(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, c, k, _build.stream_handle(x.device))
    _build.check_launch("sep_depthwise_fwd_f32", err)
    depthwise_fwd.launches += 1
    return out


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


def depthwise_bwd_w_plain(x: torch.Tensor, dy: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw [C, 1, K], db [C]) of ``depthwise_forward`` with a kernel of
    ``k`` taps, as the tap loop of the JAX package's ``_bwd_w_kernel``."""
    half = (k - 1) // 2
    t = x.shape[1]
    xp = F.pad(x, (0, 0, half, half))
    dw = torch.stack([(xp[:, tap:tap + t] * dy).sum(dim=(0, 1))
                      for tap in range(k)], dim=-1)
    return dw[:, None, :], dy.sum(dim=(0, 1))


def _check_and_scratch(name, x, dy, k, with_dx):
    """Check the kernel's operands; the scratch of per-block partial sums
    of dw and db that the kernel's second launch adds up.  Its size
    follows the launch's chunks of tiles, which the library sizes to the
    card's SMs (``sep_depthwise_bwd_partial_floats``)."""
    b, t, c = x.shape
    if k % 2 == 0 or k > MAX_KERNEL:
        raise ValueError(f"{name}: kernel {k} is not odd <= {MAX_KERNEL}")
    _build.check_tensor(x, f"{name} x", (b, t, c), x.device, align=4)
    _build.check_tensor(dy, f"{name} dy", (b, t, c), x.device, align=4)
    floats = _build.library().sep_depthwise_bwd_partial_floats(
        b, t, c, k, int(with_dx))
    if floats < 0:
        raise RuntimeError(f"{name}: no launch plan for kernel {k}")
    return torch.empty(floats, dtype=torch.float32, device=x.device)


def depthwise_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: ``depthwise_bwd_plain`` for CPU tensors; the kernel for CUDA
    tensors.  float32 alone, on either device."""
    for a in (x, dy):
        _build.check_dtype("depthwise_bwd", a)
    if x.device.type == "cpu":
        return depthwise_bwd_plain(x, weight, dy)
    b, t, c = x.shape
    k = weight.shape[-1]
    scratch = _check_and_scratch("depthwise_bwd", x, dy, k, True)
    _build.check_tensor(weight, "depthwise_bwd weight", (c, 1, k), x.device,
                        align=4)
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


def depthwise_bwd_w(x: torch.Tensor, dy: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, (dw [C, 1, K], db [C]): ``depthwise_bwd_w_plain`` for CPU
    tensors; the kernel for CUDA tensors.  float32 alone, on either
    device."""
    for a in (x, dy):
        _build.check_dtype("depthwise_bwd_w", a)
    if x.device.type == "cpu":
        return depthwise_bwd_w_plain(x, dy, k)
    b, t, c = x.shape
    scratch = _check_and_scratch("depthwise_bwd_w", x, dy, k, False)
    dw = torch.empty((c, 1, k), dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    err = _build.library().sep_depthwise_bwd_w_f32(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), db.data_ptr(),
        scratch.data_ptr(), scratch.numel(), b, t, c, k,
        _build.stream_handle(x.device))
    _build.check_launch("sep_depthwise_bwd_w_f32", err)
    depthwise_bwd_w.launches += 1
    return dw, db


def occupancy(k: int) -> Dict[str, Dict[str, int]]:
    """K4's, K5's and K6's launch at ``k`` taps on the current card:
    blocks per SM, registers, local (spill) bytes and warps per block."""
    out = (ctypes.c_int * 12)()
    _build.check_launch("sep_depthwise_occupancy",
                        _build.library().sep_depthwise_occupancy(
                            k, ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(("K4", "K5", "K6"))}


depthwise_fwd.launches = 0
depthwise_bwd.launches = 0
depthwise_bwd_w.launches = 0


class _DepthwiseLarge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return depthwise_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        # The JAX package's _vjp_bwd (depthwise.py:262-282): a bfloat16
        # stream's x, weight and dy are upcast to float32 for K5 (K6), and
        # dx, dw and db come back rounded to the stream's dtype.  These
        # casts are the reference's semantics at this boundary, not a
        # fallback: the JAX kernels take float32 there too.
        x, weight = ctx.saved_tensors
        dtype = x.dtype
        x, dy = x.float().contiguous(), dy.float().contiguous()
        if BWD_MODE == "conv":
            # dx[t] = sum_tap w[tap] dy[t + h - tap]: the "same" conv of dy
            # with the kernel reversed along its taps (on the stream's
            # values, summed in float32, as JAX's preferred_element_type)
            dx = depthwise_forward(dy, weight.flip(-1).float(), None)
            dw, db = depthwise_bwd_w(x, dy, weight.shape[-1])
        elif BWD_MODE == "fused":
            dx, dw, db = depthwise_bwd(x, weight.float(), dy)
        else:
            raise ValueError(f"depthwise.BWD_MODE {BWD_MODE!r} is not "
                             f"'fused' or 'conv'")
        return (dx.to(dtype), dw.to(weight.dtype),
                db.to(weight.dtype) if ctx.has_bias else None)


def depthwise_large(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"Same" depthwise conv of x [B, T, C] with weight [C, 1, K] (odd K)
    and bias [C], all float32 or all bfloat16; its backward is K5, or
    under ``BWD_MODE = "conv"`` a library conv for dx and K6 for dw and
    db, in float32 on upcast operands for a bfloat16 stream, the
    gradients rounded back to its dtype (as the JAX package's
    ``_vjp_bwd``)."""
    return _DepthwiseLarge.apply(x, weight, bias)
