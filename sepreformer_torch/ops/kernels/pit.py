"""K11: the uPIT negative SI-SNR table.

Replaces ``sepreformer_tpu/ops/pallas/pit.py::sisnr_pairwise_neg_fused``.
The CUDA kernel is ``sepreformer_torch/csrc/pit.cu`` (a thread-block
cluster per batch entry, which reads its rows once);
``sisnr_pairwise_neg`` is the same math in PyTorch (the JAX package's
``losses.sisnr_pairwise_neg``).  The kernel's gradient is that plain
version's autograd, recomputed in the backward, as the JAX package's
custom_vjp does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from sepreformer_torch.ops.kernels import _build


def _zero_mean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=-1, keepdim=True)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1))


def sisnr_pairwise_neg(est: torch.Tensor, src: torch.Tensor,
                       scale_inv: bool = True, eps: float = 1.0e-8,
                       clamp_db: Optional[float] = -30.0) -> torch.Tensor:
    """Negative SI-SNR of every (estimate, source) pair: est, src
    [S, B, T] -> [B, S_est, S_src]."""
    e = _zero_mean(est)[:, None]       # [S_e, 1, B, T]
    s = _zero_mean(src)[None, :]       # [1, S_s, B, T]
    if scale_inv:
        scale = (e * s).sum(dim=-1, keepdim=True) / (
            (s * s).sum(dim=-1, keepdim=True) + eps)
        s = scale * s
    loss = -20.0 * torch.log10(eps + _l2(s) / (_l2(e - s) + eps))
    if clamp_db is not None:
        loss = torch.clamp(loss, min=clamp_db)
    return loss.permute(2, 0, 1)


def _launch(est, src, scale_inv, eps, clamp_db) -> torch.Tensor:
    """The kernel on CUDA tensors; it takes up to 16 speakers (its
    partials hold 16 x 16 pairs) and fails the launch past that."""
    s, b, t = est.shape
    _build.check_tensor(est, "pit est", (s, b, t), est.device)
    _build.check_tensor(src, "pit src", (s, b, t), est.device)
    out = torch.empty((b, s, s), dtype=torch.float32, device=est.device)
    err = _build.library().sep_pit_sisnr_f32(
        est.data_ptr(), src.data_ptr(), out.data_ptr(), s, b, t,
        int(scale_inv), float(eps),
        0.0 if clamp_db is None else float(clamp_db),
        int(clamp_db is not None),
        _build.stream_handle(est.device))
    _build.check_launch("sep_pit_sisnr_f32", err)
    sisnr_pairwise_neg_fused.launches += 1
    return out


class _PitTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, est, src, scale_inv, eps, clamp_db):
        ctx.save_for_backward(est, src)
        ctx.args = (scale_inv, eps, clamp_db)
        return _launch(est.contiguous(), src.contiguous(), scale_inv, eps,
                       clamp_db)

    @staticmethod
    def backward(ctx, grad):
        est, src = ctx.saved_tensors
        with torch.enable_grad():
            e = est.detach().requires_grad_(ctx.needs_input_grad[0])
            s = src.detach().requires_grad_(ctx.needs_input_grad[1])
            table = sisnr_pairwise_neg(e, s, *ctx.args)
            inputs = [a for a in (e, s) if a.requires_grad]
            grads = iter(torch.autograd.grad(table, inputs, grad))
        return (next(grads) if e.requires_grad else None,
                next(grads) if s.requires_grad else None, None, None, None)


def sisnr_pairwise_neg_fused(est: torch.Tensor, src: torch.Tensor,
                             scale_inv: bool = True, eps: float = 1.0e-8,
                             clamp_db: Optional[float] = -30.0
                             ) -> torch.Tensor:
    """[B, S, S] negative SI-SNR table of est, src [S, B, T] float32, with
    a gradient.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if est.device.type == "cpu":
        return sisnr_pairwise_neg(est, src, scale_inv, eps, clamp_db)
    return _PitTable.apply(est, src, scale_inv, eps, clamp_db)


def empty_launch(est: torch.Tensor) -> None:
    """An empty kernel launched as K11 would be on ``est`` [S, B, T] (the
    same grid, cluster and shared memory): K11's floor on the card."""
    s, b, t = est.shape
    _build.check_launch("sep_pit_empty", _build.library().sep_pit_empty(
        s, b, t, _build.stream_handle(est.device)))


def occupancy(speakers: int, samples: int) -> Dict[str, int]:
    """K11's launch at ``speakers`` rows of ``samples`` on the current
    card."""
    out = (ctypes.c_int * 6)()
    _build.check_launch("sep_pit_occupancy",
                        _build.library().sep_pit_occupancy(
                            speakers, samples, ctypes.addressof(out)))
    keys = ("cluster_blocks", "held_samples", "smem_bytes", "registers",
            "local_bytes", "clusters_at_once")
    return dict(zip(keys, out))


sisnr_pairwise_neg_fused.launches = 0
