"""K7 and K8: the GCFN with hash dropout for training, forward and
backward.

Replace ``sepreformer_tpu/ops/pallas/gcfn_train.py::fused_gcfn_train``
(forward ``_fwd_train_impl``, backward ``_bwd_train_impl``).  The CUDA
kernels are ``sepreformer_torch/csrc/gcfn_train.cu``; ``gcfn_train_plain``
is the JAX package's ``gcfn_train_reference`` in PyTorch.  The two dropout
sites (0 on the GLU output, 1 on the down-projection) use the hash mask of
``hash_dropout.keep_mask`` at the global row b*T + t, so both packages
drop the same elements for the same seed.

Like JAX's ``_vjp_fwd``, the autograd function keeps only x, the
parameters and the seed; K8 recomputes the rest.  At p 0 nothing drops
and K7/K8 compute the eval GCFN and its gradient (the JAX package takes
K1 with a backward through its reference there): the train step runs
them at every dropout rate.

x may be float32 or bfloat16 (the parameters are float32 either way).
A bfloat16 x takes the JAX kernels' rounding steps (``matmul_dtype``,
``gcfn_train.py:557-559`` and ``:606-608``): every product operand is
rounded to bfloat16 where the Pallas kernel casts it (the weights, the
LayerNorm's output, g after its drop in the forward; g, do0, du and xn
in the backward) and every sum is float32; out and dx are bfloat16 and
the nine parameter gradients float32 sums, as JAX's ``_vjp_bwd`` casts
them to the float32 parameters.  The plain backward,
``gcfn_train_bwd_plain``, is ``_bwd_train_kernel`` written out.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.gcfn import (
    SUPPORTED_DTYPES,
    check_params,
    gcfn_plain,
)
from sepreformer_torch.ops.kernels.hash_dropout import (
    keep_mask,
    seed_word,
    threshold,
)


def gcfn_train_plain(x: torch.Tensor, params: Sequence[torch.Tensor],
                     eps: float, seed: int, p: float) -> torch.Tensor:
    """x + ls * drop1(Linear 3F->F(drop0(GLU(dw3(Linear F->6F(LN(x))))))):
    ``gcfn_plain``'s parameters, hash dropout at rate ``p`` with ``seed``,
    kept values divided by (1 - p)."""
    if p == 0.0:
        return gcfn_plain(x, params, eps)
    b, t, _ = x.shape
    rows = (torch.arange(b, device=x.device)[:, None, None] * t
            + torch.arange(t, device=x.device)[None, :, None])

    def drop(site, v):
        cols = torch.arange(v.shape[-1], device=x.device)
        return v * keep_mask(seed, site, rows, cols, p) / (1.0 - p)

    return gcfn_plain(x, params, eps, drop=drop)


def gcfn_train_bwd_plain(x, params, eps, seed, p, dout
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(dx in x's dtype, the nine float32 parameter gradients) of
    ``gcfn_train_plain`` for the output cotangent ``dout``: the JAX
    kernel's formulas (``_bwd_train_kernel``), the forward recomputed as
    K7 takes it, then the backward, each product on operands rounded to
    x's dtype (no rounding for float32) with float32 sums."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    dtype = x.dtype

    def rnd(a):
        return a.to(dtype).float()

    x, dout = x.float(), dout.float()
    win_r, wout_r = rnd(win), rnd(wout)
    b, t, f = x.shape
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    inv = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    xh = c * inv
    xn = rnd(xh * lns + lnb)
    u = torch.matmul(xn, win_r) + bin_
    up = torch.nn.functional.pad(u, (0, 0, 1, 1))
    y = (up[:, :t] * wdw[:, 0] + up[:, 1:t + 1] * wdw[:, 1]
         + up[:, 2:t + 2] * wdw[:, 2] + bdw)
    half = y.shape[-1] // 2
    a, sg = y[..., :half], torch.sigmoid(y[..., half:])
    if p > 0.0:
        rows = (torch.arange(b, device=x.device)[:, None, None] * t
                + torch.arange(t, device=x.device)[None, :, None])
        scale = 1.0 / (1.0 - p)
        m0 = keep_mask(seed, 0, rows, torch.arange(half, device=x.device),
                       p) * scale
        m1 = keep_mask(seed, 1, rows, torch.arange(f, device=x.device),
                       p) * scale
    else:
        m0 = m1 = torch.ones((), device=x.device)
    g = rnd(a * sg * m0)
    o = (torch.matmul(g, wout_r) + bout) * m1
    dls = (dout * o).sum(dim=(0, 1))
    do0 = dout * ls * m1
    dbout = do0.sum(dim=(0, 1))
    do0_r = rnd(do0)
    dwout = torch.einsum("bth,btf->hf", g, do0_r)
    dg0 = torch.matmul(do0_r, wout_r.t()) * m0
    dy = torch.cat([dg0 * sg, dg0 * a * sg * (1.0 - sg)], dim=-1)
    dyp = torch.nn.functional.pad(dy, (0, 0, 1, 1))    # dy[-1], dy[T] = 0
    du = (dyp[:, 2:] * wdw[:, 0] + dy * wdw[:, 1]
          + dyp[:, :t] * wdw[:, 2])
    dwdw = torch.stack([(dy * up[:, k:k + t]).sum(dim=(0, 1))
                        for k in range(3)], dim=-1)
    du_r = rnd(du)
    dwin = torch.einsum("btf,bth->fh", xn, du_r)
    dxn = torch.matmul(du_r, win_r.t())
    dxh = dxn * lns
    dx = (dout + (dxh - dxh.mean(dim=-1, keepdim=True)
                  - xh * (dxh * xh).mean(dim=-1, keepdim=True)) * inv)
    return dx.to(dtype), ((dxn * xh).sum(dim=(0, 1)), dxn.sum(dim=(0, 1)),
                          dwin, du.sum(dim=(0, 1)), dwdw, dy.sum(dim=(0, 1)),
                          dwout, dbout, dls)


# K7's and K8's instances: Base's F = 128 and Large's 256
TRAIN_WIDTHS = (128, 256)


def _hash_args(seed, p):
    return (seed_word(seed, 0), seed_word(seed, 1),
            threshold(p) if p > 0.0 else 0, 1.0 / (1.0 - p))


def _instance(x) -> str:
    """The launch's instance: "" for float32 streams, "bf16"."""
    return "" if x.dtype == torch.float32 else "bf16"


def gcfn_train_fwd(x, params, eps, seed, p) -> torch.Tensor:
    """K7: ``gcfn_train_plain``'s output; the plain version for CPU
    tensors, the kernel's float32 or bfloat16 instance for CUDA ones."""
    if x.device.type == "cpu":
        return gcfn_train_plain(x, params, eps, seed, p)
    check_params("gcfn_train_fwd", x, params, TRAIN_WIDTHS,
                 _build.OTHER_PRESETS, SUPPORTED_DTYPES)
    b, t, f = x.shape
    out = torch.empty_like(x)
    instance = _instance(x)
    entry = "sep_gcfn_train_fwd_" + (instance or "f32")
    err = getattr(_build.library(), entry)(
        x.data_ptr(), *(a.data_ptr() for a in params), out.data_ptr(), b, t,
        f, float(eps), *_hash_args(seed, p), _build.stream_handle(x.device))
    _build.check_launch(entry, err)
    _build.count_launch(gcfn_train_fwd, instance)
    return out


def gcfn_train_bwd(x, params, eps, seed, p, dout
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """K8: (dx in x's dtype, the nine float32 parameter gradients in the
    shapes of ``params``); ``gcfn_train_bwd_plain`` for CPU tensors, the
    kernel's float32 or bfloat16 instance for CUDA ones, deterministic:
    the row pass, the weight products and the ordered reductions of
    their partials, with no atomics."""
    if x.device.type == "cpu":
        return gcfn_train_bwd_plain(x, params, eps, seed, p, dout)
    check_params("gcfn_train_bwd", x, params, TRAIN_WIDTHS,
                 _build.OTHER_PRESETS, SUPPORTED_DTYPES)
    b, t, f = x.shape
    _build.check_tensor(dout, "gcfn_train_bwd dout", (b, t, f), x.device,
                        x.dtype)
    h6, h3 = 6 * f, 3 * f
    lib = _build.library()
    new = lambda n: torch.empty(n, dtype=torch.float32,  # noqa: E731
                                device=x.device)
    dx = torch.empty_like(x)
    small, big = new(34 * f), new(9 * f * f)
    # the launcher partitions the rows and carves this buffer itself
    scratch = new(lib.sep_gcfn_train_bwd_scratch_floats(b, t, f))
    instance = _instance(x)
    entry = "sep_gcfn_train_bwd_" + (instance or "f32")
    err = getattr(lib, entry)(
        x.data_ptr(), dout.data_ptr(), *(a.data_ptr() for a in params),
        dx.data_ptr(), small.data_ptr(), big.data_ptr(), scratch.data_ptr(),
        scratch.numel(), b, t, f, float(eps), *_hash_args(seed, p),
        _build.stream_handle(x.device))
    _build.check_launch(entry, err)
    _build.count_launch(gcfn_train_bwd, instance)
    dlns, dlnb, dbin, dwdw, dbdw, dbout, dls = torch.split(
        small, [f, f, h6, 3 * h6, h6, f, f])
    dwin, dwout = torch.split(big, [f * h6, h3 * f])
    return dx, (dlns, dlnb, dwin.view(f, h6), dbin, dwdw.view(h6, 3), dbdw,
                dwout.view(h3, f), dbout, dls)


def occupancy(f: int, bf16: bool = False) -> Dict[str, Dict[str, int]]:
    """K7's and K8's row pass's blocks per SM, registers, local (spill)
    bytes and warps per block at width ``f`` on the current card (their
    bfloat16 instances with ``bf16``)."""
    out = (ctypes.c_int * 8)()
    entry = ("sep_gcfn_train_bf16_occupancy" if bf16
             else "sep_gcfn_train_occupancy")
    _build.check_launch(entry, getattr(_build.library(), entry)(
        f, ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    tag = " bf16" if bf16 else ""
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate((f"K7 F={f}{tag}",
                                      f"K8 rows F={f}{tag}"))}


gcfn_train_fwd.launches = 0
gcfn_train_bwd.launches = 0
gcfn_train_fwd.instance_launches = {}
gcfn_train_bwd.instance_launches = {}


class _GcfnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, seed, p, *params):
        ctx.save_for_backward(x, *params)
        ctx.args = (eps, seed, p)
        return gcfn_train_fwd(x, params, eps, seed, p)

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        dx, dparams = gcfn_train_bwd(x, params, *ctx.args, dout.contiguous())
        return (dx, None, None, None, *dparams)


def fused_gcfn_train(x: torch.Tensor, params: Sequence[torch.Tensor],
                     eps: float, seed: int, p: float) -> torch.Tensor:
    """The train GCFN with a gradient: x [B, T, F] float32 or bfloat16
    (the result in x's dtype), ``params`` as ``gcfn_plain``'s (float32),
    the int hash ``seed``, the drop rate ``p``.  CUDA tensors launch K7,
    and K8 in the backward (F 128 and 256; other widths raise, naming the
    ROADMAP item that builds them); CPU tensors take their plain
    versions, ``gcfn_train_plain`` and ``gcfn_train_bwd_plain`` (an
    autograd through the rounding would round the gradients too)."""
    _build.check_dtype("fused_gcfn_train", x, SUPPORTED_DTYPES)
    return _GcfnTrain.apply(x, float(eps), int(seed), float(p), *params)
