"""K12: flash attention with the relative-position bias in the kernel
(eval).

Replaces ``sepreformer_tpu/ops/pallas/attention.py::
flash_relpos_attention``, which the JAX package's "auto" rule runs for
eval at bottleneck lengths past 8192 (``blocks.FUSED_PV_MAX_LENGTH`` in
the port).  The CUDA kernel is ``sepreformer_torch/csrc/flash_relpos.cu``;
``flash_relpos_attention_plain`` is the same math in PyTorch (the JAX
package's ``relpos_attention_reference``), one block of query rows at a
time so that no [L, L] tensor is ever whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.softmax_pv import NEG_INF, _key_lens

SUPPORTED_HEAD_DIMS = (16,)
PLAIN_QUERY_BLOCK = 1024


def flash_relpos_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, table: torch.Tensor,
                                 maxlen: int,
                                 lens: Optional[torch.Tensor] = None,
                                 block: int = PLAIN_QUERY_BLOCK
                                 ) -> torch.Tensor:
    """q, k, v [B, L, H*d] channels-last, ``table`` [2*maxlen, d] ->
    [B, L, H*d]: per head, softmax((q_i·k_j + q_i·table[clip(i - j,
    -maxlen, maxlen - 1) + maxlen]) / sqrt(d)) over the keys
    j < min(L, lens[b]), times V.  Query rows go ``block`` at a time."""
    b, length, f = q.shape
    d = table.shape[1]
    h = f // d

    def heads(a):                                        # [B, H, L, d]
        return a.reshape(b, length, h, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    kmask = (torch.arange(length, device=q.device)[None]
             < _key_lens(b, length, lens, q.device)[:, None])
    pos = torch.arange(length, device=q.device)
    out = torch.empty_like(qh)
    for i0 in range(0, length, block):
        qb = qh[:, :, i0:i0 + block]
        scores = torch.matmul(qb, kh.transpose(-1, -2))  # [B, H, nq, L]
        by_row = torch.matmul(qb, table.t())             # [B, H, nq, 2m]
        idx = torch.clamp(pos[i0:i0 + block, None] - pos[None],
                          -maxlen, maxlen - 1) + maxlen
        scores += torch.gather(by_row, 3, idx.expand(*scores.shape))
        scores /= math.sqrt(d)
        scores = torch.where(kmask[:, None, None, :], scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
        out[:, :, i0:i0 + block] = torch.matmul(
            torch.softmax(scores, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, length, f)


def flash_relpos_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, table: torch.Tensor, maxlen: int,
                           lens: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Rel-pos attention without an [L, L] tensor: q, k, v [B, L, H*d]
    float32, ``table`` the raw [2*maxlen, d] embedding, ``lens`` [B] the
    valid keys per row (optional).  CPU tensors take the plain version;
    CUDA tensors launch the kernel, which needs every ``lens[b] >= 1``
    and has no backward: it raises where autograd would record the
    call."""
    if q.device.type == "cpu":
        return flash_relpos_attention_plain(q, k, v, table, maxlen, lens)
    _build.check_no_grad("flash_relpos_attention", q, k, v, table)
    b, length, f = q.shape
    n, d = table.shape
    if d not in SUPPORTED_HEAD_DIMS or f % d:
        raise ValueError(f"flash_relpos_attention: head dim {d} of width "
                         f"{f} not in {SUPPORTED_HEAD_DIMS}")
    if n != 2 * maxlen:
        raise ValueError(
            f"flash_relpos_attention: table rows {n} != 2*{maxlen}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(a, f"flash_relpos_attention {name}",
                            (b, length, f), q.device)
    _build.check_tensor(table, "flash_relpos_attention table", (n, d),
                        q.device)
    key_len = _key_lens(b, length, lens, q.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    out = torch.empty_like(q)
    err = _build.library().sep_flash_relpos_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), b, length, f // d, maxlen,
        _build.stream_handle(q.device))
    _build.check_launch("sep_flash_relpos_f32", err)
    flash_relpos_attention.launches += 1
    return out


flash_relpos_attention.launches = 0
