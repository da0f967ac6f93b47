"""K7 and K8: the GCFN with hash dropout for training, forward and
backward.

Replace ``sepreformer_tpu/ops/pallas/gcfn_train.py::fused_gcfn_train``
(forward ``_fwd_train_impl``, backward ``_bwd_train_impl``).  The CUDA
kernels are ``sepreformer_torch/csrc/gcfn_train.cu``; ``gcfn_train_plain``
is the JAX package's ``gcfn_train_reference`` in PyTorch, and its autograd
gives the plain backward (``gcfn_train_bwd_plain``).  The two dropout
sites (0 on the GLU output, 1 on the down-projection) use the hash mask of
``hash_dropout.keep_mask`` at the global row b*T + t, so both packages
drop the same elements for the same seed.

Like JAX's ``_vjp_fwd``, the autograd function keeps only x, the
parameters and the seed; K8 recomputes the rest.  At p 0 nothing drops
and K7/K8 compute the eval GCFN and its gradient (the JAX package takes
K1 with a backward through its reference there): the train step runs
them at every dropout rate.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.gcfn import check_params, gcfn_plain
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
    """(dx, the nine parameter gradients) of ``gcfn_train_plain`` for the
    output cotangent ``dout``, by autograd."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (x, *params)]
        out = gcfn_train_plain(leaves[0], leaves[1:], eps, seed, p)
        grads = torch.autograd.grad(out, leaves, dout)
    return grads[0], tuple(grads[1:])


# K7's and K8's instances: Base's F = 128 and Large's 256
TRAIN_WIDTHS = (128, 256)


def _hash_args(seed, p):
    return (seed_word(seed, 0), seed_word(seed, 1),
            threshold(p) if p > 0.0 else 0, 1.0 / (1.0 - p))


def gcfn_train_fwd(x, params, eps, seed, p) -> torch.Tensor:
    """K7 on CUDA tensors: ``gcfn_train_plain``'s output."""
    check_params("gcfn_train_fwd", x, params, TRAIN_WIDTHS,
                 _build.OTHER_PRESETS)
    b, t, f = x.shape
    out = torch.empty_like(x)
    err = _build.library().sep_gcfn_train_fwd_f32(
        x.data_ptr(), *(a.data_ptr() for a in params), out.data_ptr(), b, t,
        f, float(eps), *_hash_args(seed, p), _build.stream_handle(x.device))
    _build.check_launch("sep_gcfn_train_fwd_f32", err)
    gcfn_train_fwd.launches += 1
    return out


def gcfn_train_bwd(x, params, eps, seed, p, dout
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """K8 on CUDA tensors: (dx, the nine parameter gradients in the shapes
    of ``params``), deterministic: the row pass, the weight products and
    the ordered reductions of their partials, with no atomics."""
    check_params("gcfn_train_bwd", x, params, TRAIN_WIDTHS,
                 _build.OTHER_PRESETS)
    b, t, f = x.shape
    _build.check_tensor(dout, "gcfn_train_bwd dout", (b, t, f), x.device)
    h6, h3 = 6 * f, 3 * f
    lib = _build.library()
    new = lambda n: torch.empty(n, dtype=torch.float32,  # noqa: E731
                                device=x.device)
    dx = torch.empty_like(x)
    small, big = new(34 * f), new(9 * f * f)
    # the launcher partitions the rows and carves this buffer itself
    scratch = new(lib.sep_gcfn_train_bwd_scratch_floats(b, t, f))
    err = lib.sep_gcfn_train_bwd_f32(
        x.data_ptr(), dout.data_ptr(), *(a.data_ptr() for a in params),
        dx.data_ptr(), small.data_ptr(), big.data_ptr(), scratch.data_ptr(),
        scratch.numel(), b, t, f, float(eps), *_hash_args(seed, p),
        _build.stream_handle(x.device))
    _build.check_launch("sep_gcfn_train_bwd_f32", err)
    gcfn_train_bwd.launches += 1
    dlns, dlnb, dbin, dwdw, dbdw, dbout, dls = torch.split(
        small, [f, f, h6, 3 * h6, h6, f, f])
    dwin, dwout = torch.split(big, [f * h6, h3 * f])
    return dx, (dlns, dlnb, dwin.view(f, h6), dbin, dwdw.view(h6, 3), dbdw,
                dwout.view(h3, f), dbout, dls)


def occupancy(f: int) -> Dict[str, Dict[str, int]]:
    """K7's and K8's row pass's blocks per SM, registers, local (spill)
    bytes and warps per block at width ``f`` on the current card."""
    out = (ctypes.c_int * 8)()
    _build.check_launch("sep_gcfn_train_occupancy",
                        _build.library().sep_gcfn_train_occupancy(
                            f, ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate((f"K7 F={f}", f"K8 rows F={f}"))}


gcfn_train_fwd.launches = 0
gcfn_train_bwd.launches = 0


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
    """The train GCFN with a gradient: x [B, T, F] float32, ``params`` as
    ``gcfn_plain``'s, the int hash ``seed``, the drop rate ``p``.  CPU
    tensors take ``gcfn_train_plain`` and its autograd; CUDA tensors
    launch K7, and K8 in the backward (F 128 and 256; other widths
    raise, naming the ROADMAP item that builds them; so does a bfloat16
    x, on either device)."""
    _build.check_dtype("fused_gcfn_train", x)
    if x.device.type == "cpu":
        return gcfn_train_plain(x, params, eps, seed, p)
    return _GcfnTrain.apply(x, float(eps), int(seed), float(p), *params)
