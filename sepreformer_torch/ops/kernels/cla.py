"""K15: the fused CLA local block (eval).

Replaces ``sepreformer_tpu/ops/pallas/cla.py::fused_cla``.  The CUDA
kernel is ``sepreformer_torch/csrc/cla.cu``; ``cla_plain`` is the same
math in PyTorch (the JAX package's ``cla_reference``).  BatchNorm enters
folded to an affine (s, t) from its running statistics, computed by the
caller outside the kernel (``blocks.BatchNorm.folded``), so that its
parameters get gradients through the fold.  The gradient of
``fused_cla`` recomputes ``cla_reference`` and returns its VJP, as the
JAX package's ``custom_vjp`` does.

x may be float32 or bfloat16 (the parameters are float32 either way).
A bfloat16 x takes the JAX kernel's rounding steps (``cla.py:89-122``):
x is upcast and the LayerNorm runs in float32; its output, the conv's
output y and the GELU's output are rounded to bfloat16 before the three
products, whose weights are rounded too and whose sums are float32; the
GLU output v stays float32 (the JAX kernel's ``v_scratch`` is float32,
and so is the kernel's v between its two launches), the k65 conv runs in
float32 on the float32 weight, and x + ls·out is stored as bfloat16.
The gradient takes the reference's math (``cla_reference``: float32
throughout, the result cast to x's dtype), as the JAX package's VJP of
``cla_reference`` does, not the kernel's rounding.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad

# K15's instances: Base's F = 128 and Large's F = 256, each for float32
# and bfloat16 streams
SUPPORTED_WIDTHS = (128, 256)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_SIZE = 65
PARAM_NAMES = ("lns", "lnb", "w_in", "b_in", "wdw", "bdw", "w_mid", "b_mid",
               "bn_s", "bn_t", "w_out", "b_out", "ls")


def cla_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
              eps: float) -> torch.Tensor:
    """LN -> Linear F->2F -> GLU -> depthwise k "same" (zero padding of the
    GLU output) -> Linear F->2F -> x·s + t (the folded BatchNorm) -> exact
    GELU -> Linear 2F->F -> x + ls·out.  ``params`` = (lns, lnb, w_in
    [F, 2F], b_in, wdw [k, F], bdw, w_mid [F, 2F], b_mid, bn_s, bn_t,
    w_out [2F, F], b_out, ls): the products' weights [in, out].  A
    bfloat16 x gives a bfloat16 result, with the kernel's rounding steps
    (the module docstring)."""
    (lns, lnb, w_in, b_in, wdw, bdw, w_mid, b_mid, bn_s, bn_t,
     w_out, b_out, ls) = params
    dtype = x.dtype
    low = dtype != torch.float32

    def rounded(a):  # a float32 tensor rounded to the stream's dtype
        return a.to(dtype).float() if low else a

    if low:
        x = x.float()
        w_in, w_mid, w_out = rounded(w_in), rounded(w_mid), rounded(w_out)
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    xn = rounded(c * torch.rsqrt(var + eps) * lns + lnb)
    u = torch.matmul(xn, w_in) + b_in
    f = x.shape[-1]
    v = u[..., :f] * torch.sigmoid(u[..., f:])
    k = wdw.shape[0]
    vp = F.pad(v.transpose(1, 2), ((k - 1) // 2, (k - 1) // 2))
    y = F.conv1d(vp, wdw.t()[:, None, :], bdw, groups=f).transpose(1, 2)
    y = (torch.matmul(rounded(y), w_mid) + b_mid) * bn_s + bn_t
    y = rounded(F.gelu(y, approximate="none"))
    return (x + ls * (torch.matmul(y, w_out) + b_out)).to(dtype)


def cla_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                  eps: float) -> torch.Tensor:
    """The JAX package's ``cla_reference``: ``cla_plain`` in float32
    throughout, the result cast to x's dtype.  ``fused_cla``'s gradient
    recomputes it; for a float32 x it is ``cla_plain``."""
    return cla_plain(x.float(), params, eps).to(x.dtype)


def check_params(name: str, x: torch.Tensor,
                 params: Sequence[torch.Tensor]) -> None:
    """Raise unless x [B, T, F] (float32 or bfloat16) and ``params``
    (``cla_plain``'s, float32) are CUDA tensors the kernel takes: F in
    ``SUPPORTED_WIDTHS``, k 65, every
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
    _build.check_dtype(name, x, SUPPORTED_DTYPES)
    _build.check_tensor(x, f"{name} x", (b, t, f), x.device, x.dtype)
    for pname, a, shape in zip(PARAM_NAMES, params, shapes):
        if pname == "wdw":
            a = a.t()
        align = 16 if pname in ("w_in", "w_mid", "w_out") else 4
        _build.check_tensor(a, f"{name} {pname}", shape, x.device,
                            align=align)


def cla_kernel(x: torch.Tensor, params: Sequence[torch.Tensor],
               eps: float) -> torch.Tensor:
    """The K15 launch on CUDA tensors (no autograd): the float32 instance
    or the bfloat16 one, by x's dtype."""
    check_params("fused_cla", x, params)
    b, t, f = x.shape
    out = torch.empty_like(x)
    # GLU(LN(x) W_in + b_in) in float32, the first launch's output and the
    # second's input (csrc/cla.cu)
    v = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    low = x.dtype != torch.float32
    entry = "sep_cla_bf16" if low else "sep_cla_f32"
    err = getattr(_build.library(), entry)(
        x.data_ptr(), *(p.data_ptr() for p in params), v.data_ptr(),
        out.data_ptr(), b, t, f, float(eps), _build.stream_handle(x.device))
    _build.check_launch(entry, err)
    _build.count_launch(fused_cla, "bf16" if low else "")
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
    x float32 or bfloat16 (the result in x's dtype).  Gradients
    recompute ``cla_reference``."""
    _build.check_dtype("fused_cla", x, SUPPORTED_DTYPES)
    kernel = cla_plain if x.device.type == "cpu" else cla_kernel
    return with_plain_grad(lambda xx, *pp: kernel(xx, pp, eps),
                           lambda xx, *pp: cla_reference(xx, pp, eps),
                           x, *params)


fused_cla.launches = 0
fused_cla.instance_launches = {}
