"""K1: the fused GCFN forward (eval).

Replaces ``sepreformer_tpu/ops/pallas/gcfn.py::fused_gcfn``.  The CUDA
kernel is ``sepreformer_torch/csrc/gcfn.cu``; ``gcfn_plain`` is the same
math in PyTorch (the JAX package's ``gcfn_reference``).  On CUDA tensors
the gradient recomputes ``gcfn_plain``, as the JAX package's
``custom_vjp`` recomputes its reference.  x may be float32 or bfloat16
(the parameters are float32 either way); a bfloat16 stream takes the
JAX kernel's rounding steps (``gcfn.py:162-211``): the LayerNorm's
output and the GLU's are rounded to bfloat16 before the products,
whose weights are rounded too and whose sums are float32, and the
residual is formed in float32 and stored as bfloat16.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad

# K1's instances: Base's F = 128 and Large's F = 256, each for float32
# and bfloat16 streams
SUPPORTED_WIDTHS = (128, 256)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCK = 512
MIN_BLOCK = 64


def pick_block(t: int) -> int:
    """The JAX GCFN and CLA kernels' time block (``gcfn.py::pick_block``,
    ``cla.py::pick_block``, one rule): t itself up to ``MAX_BLOCK``, else
    the largest multiple-of-8 divisor of t in [``MIN_BLOCK``,
    ``MAX_BLOCK``], 0 if none.  The port reads it only as the route
    condition of the fused CLA (K15) and the EGA-tail+GCFN pair (K16);
    its kernels tile any T their own way."""
    if t <= MAX_BLOCK:
        return t
    for bt in range(MAX_BLOCK, MIN_BLOCK - 1, -8):
        if t % bt == 0:
            return bt
    return 0


def _length_mask(lens: torch.Tensor, t: int) -> torch.Tensor:
    pos = torch.arange(t, device=lens.device)
    return (pos[None, :] < lens[:, None]).to(torch.float32)[..., None]


def gcfn_plain(x: torch.Tensor, params: Sequence[torch.Tensor], eps: float,
               lens: Optional[torch.Tensor] = None,
               drop: Optional[Callable] = None) -> torch.Tensor:
    """LN -> Linear F->6F -> u-row mask (rows t >= lens[b]) -> depthwise
    k3 with zero padding in u-space -> GLU -> Linear 3F->F -> LayerScale
    residual.  ``params`` = (lns, lnb, win [F, 6F], bin, wdw [6F, 3], bdw,
    wout [3F, F], bout, ls): the products' weights [in, out], the k3
    weight as the Conv1d weight [6F, 1, 3] without its middle axis.
    ``drop(site, v)``, when given, drops the GLU output (site 0) and the
    down-projection (site 1).  A bfloat16 x gives a bfloat16 result, with
    the kernel's rounding steps (the module docstring)."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    dtype = x.dtype
    low = dtype != torch.float32

    def rounded(a):  # a float32 tensor rounded to the stream's dtype
        return a.to(dtype).float() if low else a

    if low:
        x = x.float()
        win, wout = rounded(win), rounded(wout)
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    xn = rounded(c * torch.rsqrt(var + eps) * lns + lnb)
    u = torch.matmul(xn, win) + bin_
    t = x.shape[1]
    if lens is not None:
        u = u * _length_mask(lens, t)
    up = torch.nn.functional.pad(u, (0, 0, 1, 1))
    y = (up[:, :t] * wdw[:, 0] + up[:, 1:t + 1] * wdw[:, 1]
         + up[:, 2:t + 2] * wdw[:, 2] + bdw)
    half = y.shape[-1] // 2
    g = rounded(y[..., :half] * torch.sigmoid(y[..., half:]))
    if drop is not None:
        g = drop(0, g)
    o = torch.matmul(g, wout) + bout
    if drop is not None:
        o = drop(1, o)
    return (x + ls * o).to(dtype)


def check_params(name: str, x: torch.Tensor,
                 params: Sequence[torch.Tensor],
                 widths: Sequence[int] = SUPPORTED_WIDTHS,
                 todo: str = _build.OTHER_PRESETS,
                 dtypes: Sequence[torch.dtype] = (torch.float32,)) -> None:
    """Raise unless x [B, T, F] and ``params`` (``gcfn_plain``'s) are
    contiguous CUDA tensors at a width in ``widths``, the widths the
    calling kernel is built for (K1's by default), x in one of
    ``dtypes`` and the parameters float32; the width error names the
    ROADMAP item ``todo``, the dtype error queue B's bfloat16 streams."""
    b, t, f = x.shape
    hidden = 6 * f
    _build.check_width(name, "width", f, widths, todo)
    _build.check_dtype(name, x, dtypes)
    shapes = [(f,), (f,), (f, hidden), (hidden,), (hidden, 3), (hidden,),
              (hidden // 2, f), (f,), (f,)]
    _build.check_tensor(x, f"{name} x", (b, t, f), x.device, x.dtype)
    for pname, a, shape in zip("lns lnb win bin wdw bdw wout bout ls".split(),
                               params, shapes):
        _build.check_tensor(a, f"{name} {pname}", shape, x.device)


def _launch(x: torch.Tensor, params: Sequence[torch.Tensor], eps: float,
            lens: Optional[torch.Tensor]) -> torch.Tensor:
    """The K1 launch on checked CUDA tensors (no autograd): the float32
    instance or the bfloat16 one, by x's dtype."""
    b, t, f = x.shape
    out = torch.empty_like(x)
    entry = "sep_gcfn_f32" if x.dtype == torch.float32 else "sep_gcfn_bf16"
    err = getattr(_build.library(), entry)(
        x.data_ptr(), None if lens is None else lens.data_ptr(),
        *(p.data_ptr() for p in params), out.data_ptr(), b, t, f, float(eps),
        _build.stream_handle(x.device))
    _build.check_launch(entry, err)
    _build.count_launch(fused_gcfn,
                        "" if x.dtype == torch.float32 else "bf16")
    return out


def _with_grad(kernel, x, params, eps, lens):
    """``kernel(x, params, eps, lens)`` with the gradient of ``gcfn_plain``
    with respect to x and the nine parameters (none for ``lens``), as the
    JAX package's ``_bwd`` returns."""
    return with_plain_grad(
        lambda xx, ll, *pp: kernel(xx, pp, eps, ll),
        lambda xx, ll, *pp: gcfn_plain(xx, pp, eps, ll),
        x, lens, *params)


def fused_gcfn(x: torch.Tensor, params: Sequence[torch.Tensor], eps: float,
               lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, F] float32 or bfloat16 (the result in x's dtype);
    ``lens`` [B] int (optional) masks u-rows at t >= lens[b].  CPU tensors
    take ``gcfn_plain``; CUDA tensors launch the kernel, and their
    gradient recomputes ``gcfn_plain``."""
    if x.device.type == "cpu":
        return gcfn_plain(x, params, eps, lens)
    check_params("fused_gcfn", x, params, dtypes=SUPPORTED_DTYPES)
    if lens is not None:
        lens = lens.to(dtype=torch.int32).contiguous()
        _build.check_tensor(lens, "fused_gcfn lens", (x.shape[0],), x.device,
                            torch.int32, align=4)
    return _with_grad(_launch, x, params, eps, lens)


fused_gcfn.launches = 0
fused_gcfn.instance_launches = {}
