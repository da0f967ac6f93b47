"""K12: flash attention with the relative-position bias in the kernel
(eval).

Replaces ``sepreformer_tpu/ops/pallas/attention.py::
flash_relpos_attention``, which the JAX package's "auto" rule runs for
eval at bottleneck lengths past 8192 (``blocks.FUSED_PV_MAX_LENGTH`` in
the port).  The CUDA kernel is ``sepreformer_torch/csrc/flash_relpos.cu``;
``flash_relpos_attention_plain`` is the same math in PyTorch (the JAX
package's ``relpos_attention_reference``), one block of query rows at a
time so that no [L, L] tensor is ever whole.  On CUDA tensors the
gradient recomputes the plain version, as the JAX package's
``custom_vjp`` recomputes its reference.  q, k, v and the table are all
float32 or all bfloat16; in bfloat16 both take the JAX kernel's rounding
steps (``attention.py:90-137``): float32 sums of the bfloat16 products,
the scale, mask and softmax in float32, the probabilities rounded to
bfloat16 before ·V, the output stored as bfloat16.  The T, S and M
presets' head widths (8, 12, 20) have float32 instances alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels._autograd import with_plain_grad
from sepreformer_torch.ops.kernels.softmax_pv import NEG_INF, _key_lens

# K12's instances: the T, S and M presets' head widths 8, 12 and 20
# (float32), Base's 16 and Large's 32 (float32 and bfloat16)
SUPPORTED_HEAD_DIMS = (8, 12, 16, 20, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
BF16_HEAD_DIMS = (16, 32)
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
    j < min(L, lens[b]), times V.  Query rows go ``block`` at a time.  In
    bfloat16 the scores are float32 sums of the bfloat16 products, and
    the softmax·V takes the JAX kernel's order: exp(s - max) rounded to
    bfloat16, ·V with float32 sums, over the float32 sum of the unrounded
    exponentials; the result is bfloat16."""
    b, length, f = q.shape
    d = table.shape[1]
    h = f // d
    dtype = q.dtype

    def heads(a):                                        # [B, H, L, d]
        return a.float().reshape(b, length, h, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    table = table.float()
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
        if dtype == torch.float32:
            out[:, :, i0:i0 + block] = torch.matmul(
                torch.softmax(scores, dim=-1), vh)
        else:
            p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            out[:, :, i0:i0 + block] = torch.matmul(
                p.to(dtype).float(), vh) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(b, length, f).to(dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            table: torch.Tensor, maxlen: int,
            key_len: torch.Tensor) -> torch.Tensor:
    """The K12 launch on checked CUDA tensors (no autograd): the float32
    instance or the bfloat16 one, by q's dtype."""
    b, length, f = q.shape
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    entry = "sep_flash_relpos_bf16" if bf16 else "sep_flash_relpos_f32"
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), b, length, f // table.shape[1],
        table.shape[1], maxlen, _build.stream_handle(q.device))
    _build.check_launch(entry, err)
    _build.count_launch(flash_relpos_attention, "bf16" if bf16 else "")
    return out


def _with_grad(kernel, q, k, v, table, maxlen, key_len):
    """``kernel(q, k, v, table, maxlen, key_len)`` with the gradient of
    ``flash_relpos_attention_plain`` with respect to q, k, v and the
    table, as the JAX package's ``_bwd`` returns."""
    return with_plain_grad(
        lambda *a: kernel(*a[:4], maxlen, a[4]),
        lambda *a: flash_relpos_attention_plain(*a[:4], maxlen, a[4]),
        q, k, v, table, key_len)


def flash_relpos_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, table: torch.Tensor, maxlen: int,
                           lens: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Rel-pos attention without an [L, L] tensor: q, k, v [B, L, H*d]
    float32 or bfloat16, ``table`` the raw [2*maxlen, d] embedding in
    their dtype, ``lens`` [B] the valid keys per row (optional).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    needs every ``lens[b] >= 1``; their gradient recomputes the plain
    version."""
    if q.device.type == "cpu":
        return flash_relpos_attention_plain(q, k, v, table, maxlen, lens)
    b, length, f = q.shape
    n, d = table.shape
    if f % d:
        raise ValueError(f"flash_relpos_attention: width {f} is not a "
                         f"multiple of the head dim {d}")
    _build.check_width("flash_relpos_attention", "head dim", d,
                       SUPPORTED_HEAD_DIMS, _build.OTHER_PRESETS)
    if n != 2 * maxlen:
        raise ValueError(
            f"flash_relpos_attention: table rows {n} != 2*{maxlen}")
    _build.check_dtype("flash_relpos_attention", q,
                       _build.dtypes_at(d, BF16_HEAD_DIMS))
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(a, f"flash_relpos_attention {name}",
                            (b, length, f), q.device, q.dtype)
    _build.check_tensor(table, "flash_relpos_attention table", (n, d),
                        q.device, q.dtype)
    key_len = _key_lens(b, length, lens, q.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _with_grad(_launch, q, k, v, table, maxlen, key_len)


def occupancy(d: int) -> Dict[str, int]:
    """K12's float32 instance at a T, S or M preset's head width ``d`` on
    the current card: blocks per SM, registers, local (spill) bytes and
    warps per block."""
    out = (ctypes.c_int * 4)()
    _build.check_launch("sep_flash_relpos_occupancy", _build.library()
                        .sep_flash_relpos_occupancy(d, ctypes.addressof(out)))
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "warps"),
                    out))


flash_relpos_attention.launches = 0
flash_relpos_attention.instance_launches = {}
