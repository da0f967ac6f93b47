"""K15: the fused CLA local block (eval).

Replaces ``sepreformer_tpu/ops/pallas/cla.py::fused_cla``.  The CUDA
kernel is ``sepreformer_torch/csrc/cla.cu``; ``cla_plain`` is the same
math in PyTorch (the JAX package's ``cla_reference``).  BatchNorm enters
folded to an affine (s, t) from its running statistics, computed by the
caller outside the kernel (``blocks.BatchNorm.folded``), so that its
parameters get gradients through the fold.  The gradient of
``fused_cla`` recomputes ``cla_plain`` and returns its VJP, as the JAX
package's ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad

# K15's instances: Base's F = 128 and Large's F = 256
SUPPORTED_WIDTHS = (128, 256)
KERNEL_SIZE = 65
PARAM_NAMES = ("lns", "lnb", "w_in", "b_in", "wdw", "bdw", "w_mid", "b_mid",
               "bn_s", "bn_t", "w_out", "b_out", "ls")


def cla_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
              eps: float) -> torch.Tensor:
    """LN -> Linear F->2F -> GLU -> depthwise k "same" (zero padding of the
    GLU output) -> Linear F->2F -> x·s + t (the folded BatchNorm) -> exact
    GELU -> Linear 2F->F -> x + ls·out.  ``params`` = (lns, lnb, w_in
    [F, 2F], b_in, wdw [k, F], bdw, w_mid [F, 2F], b_mid, bn_s, bn_t,
    w_out [2F, F], b_out, ls): the products' weights [in, out]."""
    (lns, lnb, w_in, b_in, wdw, bdw, w_mid, b_mid, bn_s, bn_t,
     w_out, b_out, ls) = params
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    xn = c * torch.rsqrt(var + eps) * lns + lnb
    u = torch.matmul(xn, w_in) + b_in
    f = x.shape[-1]
    v = u[..., :f] * torch.sigmoid(u[..., f:])
    k = wdw.shape[0]
    vp = F.pad(v.transpose(1, 2), ((k - 1) // 2, (k - 1) // 2))
    y = F.conv1d(vp, wdw.t()[:, None, :], bdw, groups=f).transpose(1, 2)
    y = (torch.matmul(y, w_mid) + b_mid) * bn_s + bn_t
    y = F.gelu(y, approximate="none")
    return x + ls * (torch.matmul(y, w_out) + b_out)


def check_params(name: str, x: torch.Tensor,
                 params: Sequence[torch.Tensor]) -> None:
    """Raise unless x [B, T, F] and ``params`` (``cla_plain``'s) are float32
    CUDA tensors the kernel takes: F in ``SUPPORTED_WIDTHS``, k 65, every
    tensor contiguous except wdw, which the kernel reads in the Conv1d
    weight's [F, k] layout (``wdw.t()`` contiguous, as the CLA module's
    ``weight[:, 0, :].t()`` is); the three products' weights 16-byte
    aligned, since the kernel stages them in 16-byte copies."""
    b, t, f = x.shape
    _build.check_width(name, "width", f, SUPPORTED_WIDTHS,
                       _build.OTHER_PRESETS)
    k = params[4].shape[0]
    if k != KERNEL_SIZE:
        raise ValueError(f"{name}: depthwise kernel {k}, the kernel is "
                         f"built for {KERNEL_SIZE}")
    h = 2 * f
    shapes = [(f,), (f,), (f, h), (h,), (f, k), (f,), (f, h), (h,), (h,),
              (h,), (h, f), (f,), (f,)]
    _build.check_tensor(x, f"{name} x", (b, t, f), x.device)
    for pname, a, shape in zip(PARAM_NAMES, params, shapes):
        if pname == "wdw":
            a = a.t()
        align = 16 if pname in ("w_in", "w_mid", "w_out") else 4
        _build.check_tensor(a, f"{name} {pname}", shape, x.device,
                            align=align)


def cla_kernel(x: torch.Tensor, params: Sequence[torch.Tensor],
               eps: float) -> torch.Tensor:
    """The K15 launch on CUDA tensors (no autograd)."""
    check_params("fused_cla", x, params)
    b, t, f = x.shape
    out = torch.empty_like(x)
    # GLU(LN(x) W_in + b_in), the first launch's output and the second's
    # input (csrc/cla.cu)
    v = torch.empty_like(x)
    err = _build.library().sep_cla_f32(
        x.data_ptr(), *(p.data_ptr() for p in params), v.data_ptr(),
        out.data_ptr(), b, t, f, float(eps), _build.stream_handle(x.device))
    _build.check_launch("sep_cla_f32", err)
    fused_cla.launches += 1
    return out


def blocks_per_sm(f: int) -> Tuple[int, int]:
    """How many blocks of K15's two launches (the GLU launch, the tail)
    at width ``f`` one SM of the current card holds at once, with the
    launches' shared-memory attributes set."""
    _build.check_width("fused_cla", "width", f, SUPPORTED_WIDTHS,
                       _build.OTHER_PRESETS)
    blocks = (ctypes.c_int * 2)()
    _build.check_launch("sep_cla_blocks_per_sm",
                        _build.library().sep_cla_blocks_per_sm(
                            f, ctypes.addressof(blocks)))
    return blocks[0], blocks[1]


def fused_cla(x: torch.Tensor, params: Sequence[torch.Tensor],
              eps: float) -> torch.Tensor:
    """K15: ``cla_plain`` for CPU tensors; the kernel for CUDA tensors.
    Gradients recompute ``cla_plain``.  float32 alone, on either device
    (a bfloat16 x raises, naming its ROADMAP item)."""
    _build.check_dtype("fused_cla", x)
    kernel = cla_plain if x.device.type == "cpu" else cla_kernel
    return with_plain_grad(lambda xx, *pp: kernel(xx, pp, eps),
                           lambda xx, *pp: cla_plain(xx, pp, eps),
                           x, *params)


fused_cla.launches = 0
