"""K16: the EGA tail fused with the GCFN that follows it (a GlobalBlock's
second half).

Replaces ``sepreformer_tpu/ops/pallas/ega_gcfn.py::fused_ega_tail_gcfn``:
y = x + sigmoid(LN_g(x)·Wg + bg) ⊙ nearest_up(x_down), then the GCFN on
y with its residual on y.  The CUDA kernel is
``sepreformer_torch/csrc/ega_gcfn.cu`` (K1's tensor-core tile with the
tail as its prologue); ``ega_tail_gcfn_plain`` is the same math in
PyTorch (the JAX package's ``ega_tail_gcfn_reference``).  The gradient of
``fused_ega_tail_gcfn`` recomputes the plain version, as the JAX
package's ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad
from sepreformer_torch.ops.kernels.gcfn import check_params, gcfn_plain
from sepreformer_torch.ops.resample import nearest_upsample_time

# K16's instances: Base's F = 128 and Large's F = 256
PAIR_WIDTHS = (128, 256)


def ega_tail_gcfn_plain(x: torch.Tensor, x_down: torch.Tensor,
                        gate_params: Sequence[torch.Tensor],
                        gcfn_params: Sequence[torch.Tensor],
                        eps: float) -> torch.Tensor:
    """x [B, T, F], x_down [B, L, F] (the attention's output at the
    bottleneck length); ``gate_params`` = (gns, gnb, wg [F, F] as [in,
    out], bg), ``gcfn_params`` as ``gcfn_plain``'s."""
    gns, gnb, wg, bg = gate_params
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    gn = c * torch.rsqrt(var + eps) * gns + gnb
    gate = torch.sigmoid(torch.matmul(gn, wg) + bg)
    y = x + gate * nearest_upsample_time(x_down, x.shape[1])
    return gcfn_plain(y, gcfn_params, eps)


def pair_kernel(x: torch.Tensor, x_down: torch.Tensor,
                gate_params: Sequence[torch.Tensor],
                gcfn_params: Sequence[torch.Tensor],
                eps: float) -> torch.Tensor:
    """The K16 launch on CUDA tensors (no autograd)."""
    name = "fused_ega_tail_gcfn"
    b, t, f = x.shape
    length = x_down.shape[1]
    if t % length:
        raise ValueError(f"{name}: T {t} is not a multiple of the "
                         f"bottleneck length {length}")
    check_params(name, x, gcfn_params, PAIR_WIDTHS)
    _build.check_tensor(x_down, f"{name} x_down", (b, length, f), x.device)
    for pname, a, shape in zip(("gns", "gnb", "wg", "bg"), gate_params,
                               ((f,), (f,), (f, f), (f,))):
        _build.check_tensor(a, f"{name} {pname}", shape, x.device)
    out = torch.empty_like(x)
    err = _build.library().sep_ega_gcfn_f32(
        x.data_ptr(), x_down.data_ptr(),
        *(p.data_ptr() for p in gate_params),
        *(p.data_ptr() for p in gcfn_params), out.data_ptr(), b, t, length,
        f, float(eps), _build.stream_handle(x.device))
    _build.check_launch("sep_ega_gcfn_f32", err)
    fused_ega_tail_gcfn.launches += 1
    return out


def blocks_per_sm(f: int) -> int:
    """How many K16 blocks at width ``f`` one SM of the current card holds
    at once, with the launch's shared-memory attributes set."""
    _build.check_width("fused_ega_tail_gcfn", "width", f, PAIR_WIDTHS,
                       _build.OTHER_PRESETS)
    blocks = ctypes.c_int(0)
    _build.check_launch("sep_ega_gcfn_blocks_per_sm",
                        _build.library().sep_ega_gcfn_blocks_per_sm(
                            f, ctypes.addressof(blocks)))
    return blocks.value


def fused_ega_tail_gcfn(x: torch.Tensor, x_down: torch.Tensor,
                        gate_params: Sequence[torch.Tensor],
                        gcfn_params: Sequence[torch.Tensor],
                        eps: float) -> torch.Tensor:
    """K16: ``ega_tail_gcfn_plain`` for CPU tensors; the kernel for CUDA
    tensors.  Gradients recompute the plain version.  float32 alone, on
    either device (bfloat16 raises, naming its ROADMAP item)."""
    for a in (x, x_down):
        _build.check_dtype("fused_ega_tail_gcfn", a)
    kernel = ega_tail_gcfn_plain if x.device.type == "cpu" else pair_kernel
    return with_plain_grad(
        lambda xx, xd, *pp: kernel(xx, xd, pp[:4], pp[4:], eps),
        lambda xx, xd, *pp: ega_tail_gcfn_plain(xx, xd, pp[:4], pp[4:], eps),
        x, x_down, *gate_params, *gcfn_params)


fused_ega_tail_gcfn.launches = 0
