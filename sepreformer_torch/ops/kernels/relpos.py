"""K2: the rel-pos table materializer.

Replaces ``sepreformer_tpu/ops/pallas/relpos.py::materialize_pos_kt``.
The CUDA kernel is ``sepreformer_torch/csrc/relpos.cu``;
``materialize_pos_kt_plain`` is the gather it computes (the JAX
package's ``blocks.gather_pos_kt``).  ``pos_kt`` adds the gradient: the
adjoint of the gather, a sum of each diagonal into its table row, in
plain PyTorch as the JAX package's custom_vjp leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from sepreformer_torch.ops.kernels import _build


def relpos_index(t: int, maxlen: int) -> np.ndarray:
    """[t, t] table row of pos_kt[i, :, j]: clip(i - j) + maxlen."""
    pos = np.arange(t)
    return np.clip(pos[:, None] - pos[None, :], -maxlen, maxlen - 1) + maxlen


def materialize_pos_kt_plain(table: torch.Tensor, t: int,
                             maxlen: int) -> torch.Tensor:
    """[t, d, t] with out[i, :, j] = table[clip(i - j, -maxlen, maxlen-1)
    + maxlen]."""
    idx = torch.from_numpy(relpos_index(t, maxlen)).to(table.device)
    return table[idx].permute(0, 2, 1).contiguous()


def materialize_pos_kt(table: torch.Tensor, t: int,
                       maxlen: int) -> torch.Tensor:
    """table [2*maxlen, d] float32 -> pos_kt [t, d, t].  CPU tensors take
    the plain version; CUDA tensors launch the kernel, which raises where
    autograd would record the call (``pos_kt`` has the gradient)."""
    if table.device.type == "cpu":
        return materialize_pos_kt_plain(table, t, maxlen)
    _build.check_no_grad("materialize_pos_kt", table)
    n, d = table.shape
    if n != 2 * maxlen:
        raise ValueError(f"materialize_pos_kt: table rows {n} != 2*{maxlen}")
    _build.check_tensor(table, "materialize_pos_kt table", (n, d),
                        table.device)
    out = torch.empty((t, d, t), dtype=torch.float32, device=table.device)
    err = _build.library().sep_relpos_f32(
        table.data_ptr(), out.data_ptr(), t, d, maxlen,
        _build.stream_handle(table.device))
    _build.check_launch("sep_relpos_f32", err)
    materialize_pos_kt.launches += 1
    return out


materialize_pos_kt.launches = 0


def occupancy(t: int, d: int) -> Dict[str, int]:
    """K2's launch at ``pos_kt [t, d, t]`` on the current card: blocks,
    tiles, blocks per SM, registers and local (spill) bytes."""
    out = (ctypes.c_int * 5)()
    _build.check_launch("sep_relpos_occupancy",
                        _build.library().sep_relpos_occupancy(
                            t, d, ctypes.addressof(out)))
    keys = ("blocks", "tiles", "blocks_per_sm", "registers", "local_bytes")
    return dict(zip(keys, out))


class _PosKt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, t, maxlen):
        ctx.table_shape = table.shape
        ctx.args = (t, maxlen)
        return materialize_pos_kt(table, t, maxlen)

    @staticmethod
    def backward(ctx, grad):
        return pos_kt_grad(grad, *ctx.args), None, None


def pos_kt_grad(grad: torch.Tensor, t: int, maxlen: int) -> torch.Tensor:
    """The adjoint of the gather: grad [t, d, t] -> dtable [2*maxlen, d].
    Row idx[i, j] depends only on i - j, so each row is the sum of one
    diagonal (or, where the index clips, of the diagonals beyond it).
    The diagonals are summed by a plain reduction over a skewed view, with
    no atomics, so the gradient repeats bit for bit."""
    d = grad.shape[1]
    # g[:, i, j + t - 1] = grad[i, :, j]; zeros outside
    g = torch.nn.functional.pad(grad.permute(1, 0, 2),
                                (t - 1, t - 1)).contiguous()
    width = 3 * t - 2
    # skew[:, i, m] = g[:, i, i + m]: diagonal i - j = t - 1 - m
    skew = g.as_strided((d, t, 2 * t - 1), (t * width, width + 1, 1),
                        g.storage_offset())
    diag = skew.sum(dim=1).flip(1).t()     # [2t - 1, d], row o + t - 1
    lo, hi = max(1 - t, -maxlen), min(t - 1, maxlen - 1)
    dtable = grad.new_zeros((2 * maxlen, d))
    dtable[lo + maxlen:hi + maxlen + 1] = diag[lo + t - 1:hi + t]
    if lo > 1 - t:                         # offsets below -maxlen clip to 0
        dtable[0] += diag[:lo + t - 1].sum(dim=0)
    if hi < t - 1:                         # offsets above maxlen - 1 clip
        dtable[-1] += diag[hi + t:].sum(dim=0)
    return dtable


def pos_kt(table: torch.Tensor, t: int, maxlen: int) -> torch.Tensor:
    """``materialize_pos_kt`` with a gradient with respect to ``table``."""
    return _PosKt.apply(table, t, maxlen)
