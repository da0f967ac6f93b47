"""K1: the fused GCFN forward (eval).

Replaces ``sepreformer_tpu/ops/pallas/gcfn.py::fused_gcfn``.  The CUDA
kernel is ``sepreformer_torch/csrc/gcfn.cu``; ``gcfn_plain`` is the same
math in PyTorch (the JAX package's ``gcfn_reference``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from sepreformer_torch.ops.kernels import _build

SUPPORTED_WIDTHS = (128,)


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
    down-projection (site 1)."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    xn = c * torch.rsqrt(var + eps) * lns + lnb
    u = torch.matmul(xn, win) + bin_
    t = x.shape[1]
    if lens is not None:
        u = u * _length_mask(lens, t)
    up = torch.nn.functional.pad(u, (0, 0, 1, 1))
    y = (up[:, :t] * wdw[:, 0] + up[:, 1:t + 1] * wdw[:, 1]
         + up[:, 2:t + 2] * wdw[:, 2] + bdw)
    half = y.shape[-1] // 2
    g = y[..., :half] * torch.sigmoid(y[..., half:])
    if drop is not None:
        g = drop(0, g)
    o = torch.matmul(g, wout) + bout
    if drop is not None:
        o = drop(1, o)
    return x + ls * o


def check_params(name: str, x: torch.Tensor,
                 params: Sequence[torch.Tensor]) -> None:
    """Raise unless x [B, T, F] and ``params`` (``gcfn_plain``'s) are
    contiguous float32 CUDA tensors at a width the kernels are built for."""
    b, t, f = x.shape
    hidden = 6 * f
    if f not in SUPPORTED_WIDTHS:
        raise ValueError(f"{name}: width {f} not in {SUPPORTED_WIDTHS}")
    shapes = [(f,), (f,), (f, hidden), (hidden,), (hidden, 3), (hidden,),
              (hidden // 2, f), (f,), (f,)]
    _build.check_tensor(x, f"{name} x", (b, t, f), x.device)
    for pname, a, shape in zip("lns lnb win bin wdw bdw wout bout ls".split(),
                               params, shapes):
        _build.check_tensor(a, f"{name} {pname}", shape, x.device)


def fused_gcfn(x: torch.Tensor, params: Sequence[torch.Tensor], eps: float,
               lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, F] float32; ``lens`` [B] int (optional) masks u-rows at
    t >= lens[b].  CPU tensors take ``gcfn_plain``; CUDA tensors launch
    the kernel, which has no backward: it raises where autograd would
    record the call."""
    if x.device.type == "cpu":
        return gcfn_plain(x, params, eps, lens)
    _build.check_no_grad("fused_gcfn", x, *params)
    check_params("fused_gcfn", x, params)
    b, t, f = x.shape
    lens_ptr = None
    if lens is not None:
        lens = lens.to(dtype=torch.int32).contiguous()
        _build.check_tensor(lens, "fused_gcfn lens", (b,), x.device,
                            torch.int32, align=4)
        lens_ptr = lens.data_ptr()
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.sep_gcfn_f32(
        x.data_ptr(), lens_ptr, *(p.data_ptr() for p in params),
        out.data_ptr(), b, t, f, float(eps), _build.stream_handle(x.device))
    _build.check_launch("sep_gcfn_f32", err)
    fused_gcfn.launches += 1
    return out


fused_gcfn.launches = 0

