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

x and x_down may be float32 or bfloat16 (the parameters are float32
either way).  A bfloat16 stream takes the JAX kernel's rounding steps
(``ega_gcfn.py:57-90``): the gate's LayerNorm output is rounded before
Wg (rounded too), the gate stays float32, x_down's values are the
stream's, y = x + gate·up stays float32 (the JAX reference rounds y,
its kernel does not, and the port follows the kernel), then the GCFN's
steps on y as K1 takes them (xn and g rounded before their products),
and out = y + ls·o is stored as bfloat16.  A bfloat16 call has no
gradient: the JAX package's VJP (``ega_gcfn.py::_bwd``) hands the
bfloat16 cotangent to ``jax.vjp`` of a reference whose output is
float32, which raises, so neither package trains through K16 in
bfloat16.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad
from sepreformer_torch.ops.kernels.gcfn import check_params, gcfn_plain
from sepreformer_torch.ops.resample import nearest_upsample_time

# K16's instances: Base's F = 128 and Large's F = 256, each for float32
# and bfloat16 streams
PAIR_WIDTHS = (128, 256)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
# Why a bfloat16 K16 has no gradient (the module docstring).
NO_BF16_GRAD = ("the JAX package's fused_ega_tail_gcfn VJP "
                "(sepreformer_tpu/ops/pallas/ega_gcfn.py::_bwd) raises on a "
                "bfloat16 stream (a bfloat16 cotangent for its float32 "
                "reference), so K16 has no bfloat16 gradient to port")


def ega_tail_gcfn_plain(x: torch.Tensor, x_down: torch.Tensor,
                        gate_params: Sequence[torch.Tensor],
                        gcfn_params: Sequence[torch.Tensor],
                        eps: float) -> torch.Tensor:
    """x [B, T, F], x_down [B, L, F] (the attention's output at the
    bottleneck length); ``gate_params`` = (gns, gnb, wg [F, F] as [in,
    out], bg), ``gcfn_params`` as ``gcfn_plain``'s.  A bfloat16 x and
    x_down give a bfloat16 result, with the kernel's rounding steps (the
    module docstring)."""
    gns, gnb, wg, bg = gate_params
    dtype = x.dtype
    low = dtype != torch.float32
    if low:
        x, x_down, wg = x.float(), x_down.float(), wg.to(dtype).float()
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    gn = c * torch.rsqrt(var + eps) * gns + gnb
    if low:
        gn = gn.to(dtype).float()
    gate = torch.sigmoid(torch.matmul(gn, wg) + bg)
    y = x + gate * nearest_upsample_time(x_down, x.shape[1])
    return gcfn_plain(y, gcfn_params, eps, dtype=dtype)


def pair_kernel(x: torch.Tensor, x_down: torch.Tensor,
                gate_params: Sequence[torch.Tensor],
                gcfn_params: Sequence[torch.Tensor],
                eps: float) -> torch.Tensor:
    """The K16 launch on CUDA tensors (no autograd): the float32 instance
    or the bfloat16 one, by x's dtype.  The bfloat16 instance keeps y in
    a float32 scratch [B, T, F] for its residual (out cannot hold it)."""
    name = "fused_ega_tail_gcfn"
    b, t, f = x.shape
    length = x_down.shape[1]
    if t % length:
        raise ValueError(f"{name}: T {t} is not a multiple of the "
                         f"bottleneck length {length}")
    check_params(name, x, gcfn_params, PAIR_WIDTHS, dtypes=SUPPORTED_DTYPES)
    _build.check_tensor(x_down, f"{name} x_down", (b, length, f), x.device,
                        x.dtype)
    for pname, a, shape in zip(("gns", "gnb", "wg", "bg"), gate_params,
                               ((f,), (f,), (f, f), (f,))):
        _build.check_tensor(a, f"{name} {pname}", shape, x.device)
    out = torch.empty_like(x)
    lib = _build.library()
    args = (x.data_ptr(), x_down.data_ptr(),
            *(p.data_ptr() for p in gate_params),
            *(p.data_ptr() for p in gcfn_params), out.data_ptr())
    if x.dtype == torch.float32:
        entry = "sep_ega_gcfn_f32"
        err = lib.sep_ega_gcfn_f32(*args, b, t, length, f, float(eps),
                                   _build.stream_handle(x.device))
    else:
        entry = "sep_ega_gcfn_bf16"
        y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        err = lib.sep_ega_gcfn_bf16(*args, y.data_ptr(), b, t, length, f,
                                    float(eps),
                                    _build.stream_handle(x.device))
    _build.check_launch(entry, err)
    _build.count_launch(fused_ega_tail_gcfn,
                        "" if x.dtype == torch.float32 else "bf16")
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
    tensors.  x and x_down float32 or bfloat16 (the result in x's dtype).
    float32 gradients recompute the plain version; a bfloat16 call that
    autograd would record raises (``NO_BF16_GRAD``)."""
    for a in (x, x_down):
        _build.check_dtype("fused_ega_tail_gcfn", a, SUPPORTED_DTYPES)
    if x.dtype != x_down.dtype:
        raise ValueError("fused_ega_tail_gcfn: x and x_down must share one "
                         "dtype")
    tensors = (x, x_down, *gate_params, *gcfn_params)
    if (x.dtype != torch.float32 and torch.is_grad_enabled()
            and any(a.requires_grad for a in tensors)):
        raise NotImplementedError(f"fused_ega_tail_gcfn: {NO_BF16_GRAD}")
    kernel = ega_tail_gcfn_plain if x.device.type == "cpu" else pair_kernel
    return with_plain_grad(
        lambda xx, xd, *pp: kernel(xx, xd, pp[:4], pp[4:], eps),
        lambda xx, xd, *pp: ega_tail_gcfn_plain(xx, xd, pp[:4], pp[4:], eps),
        x, x_down, *gate_params, *gcfn_params)


fused_ega_tail_gcfn.launches = 0
fused_ega_tail_gcfn.instance_launches = {}
