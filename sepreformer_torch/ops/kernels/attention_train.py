"""K13 and K14: the single-block train attention, with the rel-pos bias
and hash dropout in the kernel, forward and backward.

Replaces ``sepreformer_tpu/ops/pallas/attention_train.py::
flash_relpos_attention_train`` (forward ``_fwd_impl``, backward
``_bwd_impl``), which the JAX package runs for
``attention_train_impl="pallas"`` in training and, at dropout 0 with key
lengths, for ``attention_impl="single"`` in eval, at lengths up to 512.
The CUDA kernels are ``sepreformer_torch/csrc/attention_train.cu``;
``attention_train_plain`` is the same function in PyTorch (the JAX
package's ``attention_train_reference``) and ``attention_train_bwd_plain``
the formulas of its ``_bwd_kernel``.  Tensors are [B, H, L, d] as in the
JAX package; ``table`` is the raw [2*maxlen, d] embedding.  The dropout
mask is the JAX kernel's hash mask at row ``bh * block + i``, with
``block = pick_block(L)``, so both packages drop the same probabilities
for the same seed.

K13 and K14 also take bfloat16 streams (q, k, v and the table bfloat16;
the caller casts the float32 table, as the JAX package passes
``pos.table.astype(x.dtype)``), with the JAX kernels' rounding steps
(``attention_train.py:84-172``): the scores sum the exact products of the
bfloat16 operands in float32 and are scaled after; the mask, softmax and
normalised probabilities stay float32; P · keep / (1 - p) is rounded to
bfloat16 before ·V and the output is rounded.  In the backward Pd is
rounded for dV, dP and the row sum stay float32, dS is rounded before
its products (dq, dk, the table's adjoint), dq, dk and dv are rounded,
and the table's gradient is summed in float32 and rounded to the table's
dtype.  ``attention_train_plain`` and ``attention_train_bwd_plain`` take
these steps for a bfloat16 q; the CPU's bfloat16 gradient is
``attention_train_bwd_plain`` (an autograd through the rounding would
round the gradients too).  K13's bfloat16 instance also writes ``out32``,
the float32 P·V of the unrounded weights, whose dot with dOut is the row
sum of dP·P that the JAX kernel takes; K14 reads it in place of the
rounded output.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sepreformer_torch.ops.kernels import _build
from sepreformer_torch.ops.kernels.hash_dropout import (
    keep_mask,
    seed_word,
    threshold,
)
from sepreformer_torch.ops.kernels.softmax_pv import NEG_INF, _key_lens

MAX_LENGTH = 512   # the JAX kernel is single-block: one [L, L] tile
BLOCK = 128
# K13's and K14's instances: Base's head width 16 and Large's 32, each
# for float32 and bfloat16 streams
TRAIN_HEAD_DIMS = (16, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def supported_length(length: int) -> bool:
    return length <= MAX_LENGTH


def pick_block(length: int) -> int:
    """The JAX kernel's padded length (``ops/pallas/attention.py::
    pick_block``): the next power of two from 128 up to 512, else 128.
    It sets the dropout hash's row stride."""
    if length <= MAX_LENGTH:
        return max(BLOCK, 1 << math.ceil(math.log2(length)))
    return BLOCK


def _padded(x: torch.Tensor, lp: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, lp - x.shape[2]))


def _rel_index(lp: int, maxlen: int, device) -> torch.Tensor:
    pos = torch.arange(lp, device=device)
    return torch.clamp(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen


def drop_scale(seed: int, b: int, h: int, block: int, p: float,
               device) -> torch.Tensor:
    """[B, H, block, block] keep / (1 - p) at site 0, row bh * block + i,
    column j: the JAX kernel's mask at its padded length ``block``."""
    rows = (torch.arange(b * h, device=device).reshape(b, h, 1, 1) * block
            + torch.arange(block, device=device).reshape(1, 1, block, 1))
    cols = torch.arange(block, device=device).reshape(1, 1, 1, block)
    return keep_mask(seed, 0, rows, cols, p) / (1.0 - p)


def _probs_and_scale(q, k, table, maxlen, seed, p, lens):
    """(pos_k [lp, lp, d], P [B, H, lp, lp], keep / (1 - p) or 1) at the
    padded length lp = pick_block(L), on the padded q and k.  A bfloat16
    q takes the JAX kernel's steps (``_recompute_probs``): float32 sums
    of the exact products, scaled after, e / max(sum e, 1e-30); pos_k is
    then float32 (the table's values)."""
    b, h, length, d = q.shape
    lp = pick_block(length)
    low = q.dtype != torch.float32
    if low:
        q, k, table = q.float(), k.float(), table.float()
    qp, kp = _padded(q, lp), _padded(k, lp)
    pos_k = table[_rel_index(lp, maxlen, q.device)]          # [lp, lp, d]
    s = torch.matmul(qp, kp.transpose(-1, -2))
    s = s + torch.einsum("bhid,ijd->bhij", qp, pos_k)
    s = s * (1.0 / math.sqrt(d)) if low else s / math.sqrt(d)
    key_len = _key_lens(b, length, lens, q.device)
    kmask = torch.arange(lp, device=q.device)[None] < key_len[:, None]
    s = torch.where(kmask[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    if low:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        probs = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    else:
        probs = torch.softmax(s, dim=-1)
    if p == 0.0:
        return pos_k, probs, torch.ones((), device=q.device)
    return pos_k, probs, drop_scale(seed, b, h, lp, p, q.device)


def _rounded(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 tensor rounded to ``dtype`` (bfloat16), as a float32
    tensor."""
    return a.to(dtype).float()


def attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          table: torch.Tensor, maxlen: int, seed: int,
                          p: float, lens: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q, k, v [B, H, L, d], ``table`` [2*maxlen, d] -> [B, H, L, d]:
    softmax((q_i·k_j + q_i·table[clip(i - j, -maxlen, maxlen - 1) +
    maxlen]) / sqrt(d)) over the keys j < min(L, lens[b]), times the hash
    keep mask / (1 - p) (no renormalisation), times V.  Differentiable in
    q, k, v and the table (float32).  A bfloat16 q, k, v and table give a
    bfloat16 result, with the kernel's rounding steps (the module
    docstring)."""
    length = q.shape[2]
    _, probs, scale = _probs_and_scale(q, k, table, maxlen, seed, p, lens)
    if q.dtype != torch.float32:
        pd = _rounded(probs * scale, q.dtype)
        out = torch.matmul(pd, _padded(v.float(), probs.shape[-1]))
        return out[:, :, :length].to(q.dtype)
    out = torch.matmul(probs * scale, _padded(v, probs.shape[-1]))
    return out[:, :, :length]


def attention_train_bwd_plain(q, k, v, table, maxlen, seed, p, lens, dout
                              ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dtable) of ``attention_train_plain`` for the output
    cotangent ``dout`` [B, H, L, d]: dV = (P∘Z)ᵀ·dO, dP = (dO·Vᵀ)∘Z,
    G = P∘(dP - rowsum(dP∘P)) / sqrt(d), dQ = G·K + Σ_j G_ij pe_{i-j},
    dK = Gᵀ·Q, d table[r] = Σ_{clamped i-j = r} G_ij q_i.  A bfloat16 q
    takes the JAX ``_bwd_kernel``'s steps: P∘Z rounded for dV, dP and the
    row sum float32, G rounded before its products, dq, dk and dv
    rounded, the table's gradient summed in float32 and rounded to the
    table's dtype."""
    b, h, length, d = q.shape
    pos_k, probs, scale = _probs_and_scale(q, k, table, maxlen, seed, p,
                                           lens)
    lp = probs.shape[-1]
    low = q.dtype != torch.float32
    qp, kp, vp, gp = (_padded(a.float() if low else a, lp)
                      for a in (q, k, v, dout))
    pd = probs * scale
    if low:
        pd = _rounded(pd, q.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), gp)
    dp = torch.matmul(gp, vp.transpose(-1, -2)) * scale
    if low:
        g = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
        g = _rounded(g * (1.0 / math.sqrt(d)), q.dtype)
    else:
        g = (probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
             / math.sqrt(d))
    dq = torch.matmul(g, kp) + torch.einsum("bhij,ijd->bhid", g, pos_k)
    dk = torch.matmul(g.transpose(-1, -2), qp)
    dpos = torch.einsum("bhij,bhid->ijd", g, qp)
    dtable = torch.zeros(table.shape, dtype=torch.float32,
                         device=q.device).index_add_(
        0, _rel_index(lp, maxlen, q.device).reshape(-1), dpos.reshape(-1, d))
    return tuple(a[:, :, :length].to(q.dtype) for a in (dq, dk, dv)) + (
        dtable.to(table.dtype),)


def _check(q, k, v, table, maxlen):
    b, h, length, d = q.shape
    _build.check_width("flash_relpos_attention_train", "head dim", d,
                       TRAIN_HEAD_DIMS, _build.OTHER_PRESETS)
    _build.check_dtype("flash_relpos_attention_train", q, SUPPORTED_DTYPES)
    if table.shape != (2 * maxlen, d):
        raise ValueError(f"flash_relpos_attention_train: table "
                         f"{tuple(table.shape)} != ({2 * maxlen}, {d})")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length, d), q.device, q.dtype)
    _build.check_tensor(table, "flash_relpos_attention_train table",
                        (2 * maxlen, d), q.device, q.dtype)
    return b, h, length, d


def _kernel_args(b, h, length, d, maxlen, seed, p):
    return (b * h, length, h, d, maxlen, pick_block(length),
            seed_word(seed, 0), threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p))


def attention_train_fwd(q, k, v, table, maxlen, seed, p, key_len, split=0):
    """K13 on float32 CUDA tensors: (out [B, H, L, d], row max and row
    sum [B, H, L] of the scaled scores); ``key_len`` int32 [B], each in
    [1, L].  ``split``: the warps per row tile (1, 2 or 4), or 0 for the
    launcher's rule (``fwd_occupancy`` reports it)."""
    b, h, length, d = _check(q, k, v, table, maxlen)
    _build.check_dtype("attention_train_fwd", q)
    out = torch.empty_like(q)
    row_max = torch.empty((b, h, length), dtype=torch.float32,
                          device=q.device)
    row_sum = torch.empty_like(row_max)
    err = _build.library().sep_attn_train_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), row_max.data_ptr(),
        row_sum.data_ptr(), *_kernel_args(b, h, length, d, maxlen, seed, p),
        split, _build.stream_handle(q.device))
    _build.check_launch("sep_attn_train_fwd_f32", err)
    _build.count_launch(attention_train_fwd)
    return out, row_max, row_sum


def attention_train_fwd_bf16(q, k, v, table, maxlen, seed, p, key_len,
                             split=0):
    """K13's bfloat16 instance on CUDA tensors (q, k, v and the table
    bfloat16): (out [B, H, L, d] bfloat16, out32 [B, H, L, d] float32,
    the P·V of the unrounded weights that K14 dots with dOut, row max
    and row sum [B, H, L]).  The kernel takes two passes over the keys,
    the row statistics first, since it rounds the normalised weights."""
    b, h, length, d = _check(q, k, v, table, maxlen)
    _build.check_dtype("attention_train_fwd_bf16", q, (torch.bfloat16,))
    out = torch.empty_like(q)
    out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    row_max = torch.empty((b, h, length), dtype=torch.float32,
                          device=q.device)
    row_sum = torch.empty_like(row_max)
    err = _build.library().sep_attn_train_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), out32.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(),
        *_kernel_args(b, h, length, d, maxlen, seed, p), split,
        _build.stream_handle(q.device))
    _build.check_launch("sep_attn_train_fwd_bf16", err)
    _build.count_launch(attention_train_fwd, "bf16")
    return out, out32, row_max, row_sum


def attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len, out,
                        dout, row_max, row_sum):
    """K14 on CUDA tensors: (dq, dk, dv [B, H, L, d], dtable [2*maxlen,
    d]) from K13's inputs and outputs and the output cotangent ``dout``
    (three launches: dq and the table's partials, dk and dv, the
    table's fixed-order sum).  With bfloat16 q, k, v, table and dout the
    bfloat16 instance runs, ``out`` is K13's float32 ``out32`` and the
    gradients come back bfloat16."""
    b, h, length, d = _check(q, k, v, table, maxlen)
    low = q.dtype != torch.float32
    for name, a, dtype in (("out", out, torch.float32),
                           ("dout", dout, q.dtype)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length, d), q.device, dtype)
    for name, a in (("row_max", row_max), ("row_sum", row_sum)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length), q.device)
    lib = _build.library()
    size = (lib.sep_attn_train_bwd_bf16_scratch_floats if low
            else lib.sep_attn_train_bwd_scratch_floats)(b * h, length, d)
    scratch = torch.empty(size, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dtable = torch.empty_like(table)
    entry = "sep_attn_train_bwd_bf16" if low else "sep_attn_train_bwd_f32"
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dtable.data_ptr(), scratch.data_ptr(), scratch.numel(),
        *_kernel_args(b, h, length, d, maxlen, seed, p),
        _build.stream_handle(q.device))
    _build.check_launch(entry, err)
    _build.count_launch(attention_train_bwd, "bf16" if low else "")
    return dq, dk, dv, dtable


Occupancy = Dict[str, Dict[str, int]]


def fwd_occupancy(bh: int, length: int, d: int = 16
                  ) -> Tuple[int, Occupancy]:
    """K13's launch on the current card at head width ``d``: the warps
    per row tile it takes at ``bh`` heads of ``length`` rows, and at each
    split (1, 2 and 4) its blocks per SM, registers, local (spill) bytes
    and warps per block."""
    out = (ctypes.c_int * 13)()
    _build.check_launch("sep_attn_train_fwd_occupancy",
                        _build.library().sep_attn_train_fwd_occupancy(
                            bh, length, d, ctypes.addressof(out)))
    keys = ("blocks_per_sm", "registers", "local_bytes", "warps")
    name = "K13" if d == 16 else f"K13 d={d}"
    per_split = {f"{name} split {s}": dict(zip(keys, out[1 + 4 * i:5 + 4 * i]))
                 for i, s in enumerate((1, 2, 4))}
    return out[0], per_split


for _wrapper in (attention_train_fwd, attention_train_bwd):
    _wrapper.launches = 0
    _wrapper.instance_launches = {}


class _FlashRelposAttentionTrain(torch.autograd.Function):
    """K13, and K14 in the backward, in the instance q's dtype picks; on
    bfloat16 CPU tensors the plain version forward and
    ``attention_train_bwd_plain`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, table, seed, maxlen, p, key_len):
        ctx.args = (seed, maxlen, p)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, table, key_len)
            return attention_train_plain(q, k, v, table, maxlen, seed, p,
                                         key_len)
        if q.dtype == torch.float32:
            out, row_max, row_sum = attention_train_fwd(
                q, k, v, table, maxlen, seed, p, key_len)
            dot_out = out
        else:
            out, dot_out, row_max, row_sum = attention_train_fwd_bf16(
                q, k, v, table, maxlen, seed, p, key_len)
        ctx.save_for_backward(q, k, v, table, key_len, dot_out, row_max,
                              row_sum)
        return out

    @staticmethod
    def backward(ctx, dout):
        seed, maxlen, p = ctx.args
        q, k, v, table, key_len, *saved = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_train_bwd_plain(q, k, v, table, maxlen, seed,
                                              p, key_len, dout)
        else:
            dot_out, row_max, row_sum = saved
            grads = attention_train_bwd(
                q, k, v, table, maxlen, seed, p, key_len, dot_out,
                dout.contiguous(), row_max, row_sum)
        return (*grads, None, None, None, None)


def flash_relpos_attention_train(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, table: torch.Tensor,
                                 seed: int, maxlen: int, p: float,
                                 lens: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Rel-pos attention with attention-prob hash dropout and a gradient
    in q, k, v and the table, without an [L, L] tensor on the card: q, k,
    v [B, H, L, d] with L <= 512, ``table`` [2*maxlen, d], all float32 or
    all bfloat16, ``seed`` the int hash seed, ``p`` the drop rate,
    ``lens`` [B] the valid keys per row or None.  float32 CPU tensors take
    the plain version and its autograd, bfloat16 CPU tensors the plain
    version with ``attention_train_bwd_plain`` as its backward; CUDA
    tensors launch K13, and K14 in the backward (each ``lens[b]`` must be
    >= 1)."""
    b, _, length, _ = q.shape
    for a in (q, k, v, table):
        _build.check_dtype("flash_relpos_attention_train", a,
                           SUPPORTED_DTYPES)
    if len({a.dtype for a in (q, k, v, table)}) != 1:
        raise ValueError("flash_relpos_attention_train: q, k, v and the "
                         "table must share one dtype")
    if not supported_length(length):
        raise NotImplementedError(
            f"flash_relpos_attention_train: length {length} > {MAX_LENGTH}; "
            f"the caller takes the dense attention there")
    if q.device.type == "cpu" and q.dtype == torch.float32:
        return attention_train_plain(q, k, v, table, maxlen, seed, p, lens)
    key_len = _key_lens(b, length, lens, q.device).contiguous()
    if lens is not None and q.device.type != "cpu":
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _FlashRelposAttentionTrain.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), table, int(seed),
        int(maxlen), float(p), key_len)
