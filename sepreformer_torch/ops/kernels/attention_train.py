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
# K13's and K14's instances: Base's head width 16 and Large's 32
TRAIN_HEAD_DIMS = (16, 32)


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
    padded length lp = pick_block(L), on the padded q and k."""
    b, h, length, d = q.shape
    lp = pick_block(length)
    qp, kp = _padded(q, lp), _padded(k, lp)
    pos_k = table[_rel_index(lp, maxlen, q.device)]          # [lp, lp, d]
    s = torch.matmul(qp, kp.transpose(-1, -2))
    s = s + torch.einsum("bhid,ijd->bhij", qp, pos_k)
    s = s / math.sqrt(d)
    key_len = _key_lens(b, length, lens, q.device)
    kmask = torch.arange(lp, device=q.device)[None] < key_len[:, None]
    s = torch.where(kmask[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(s, dim=-1)
    if p == 0.0:
        return pos_k, probs, torch.ones((), device=q.device)
    return pos_k, probs, drop_scale(seed, b, h, lp, p, q.device)


def attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          table: torch.Tensor, maxlen: int, seed: int,
                          p: float, lens: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q, k, v [B, H, L, d], ``table`` [2*maxlen, d] -> [B, H, L, d]:
    softmax((q_i·k_j + q_i·table[clip(i - j, -maxlen, maxlen - 1) +
    maxlen]) / sqrt(d)) over the keys j < min(L, lens[b]), times the hash
    keep mask / (1 - p) (no renormalisation), times V.  Differentiable in
    q, k, v and the table."""
    length = q.shape[2]
    _, probs, scale = _probs_and_scale(q, k, table, maxlen, seed, p, lens)
    out = torch.matmul(probs * scale, _padded(v, probs.shape[-1]))
    return out[:, :, :length]


def attention_train_bwd_plain(q, k, v, table, maxlen, seed, p, lens, dout
                              ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dtable) of ``attention_train_plain`` for the output
    cotangent ``dout`` [B, H, L, d]: dV = (P∘Z)ᵀ·dO, dP = (dO·Vᵀ)∘Z,
    G = P∘(dP - rowsum(dP∘P)) / sqrt(d), dQ = G·K + Σ_j G_ij pe_{i-j},
    dK = Gᵀ·Q, d table[r] = Σ_{clamped i-j = r} G_ij q_i."""
    b, h, length, d = q.shape
    pos_k, probs, scale = _probs_and_scale(q, k, table, maxlen, seed, p,
                                           lens)
    lp = probs.shape[-1]
    qp, kp, vp, gp = (_padded(a, lp) for a in (q, k, v, dout))
    dv = torch.matmul((probs * scale).transpose(-1, -2), gp)
    dp = torch.matmul(gp, vp.transpose(-1, -2)) * scale
    g = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True)) / math.sqrt(d)
    dq = torch.matmul(g, kp) + torch.einsum("bhij,ijd->bhid", g, pos_k)
    dk = torch.matmul(g.transpose(-1, -2), qp)
    dpos = torch.einsum("bhij,bhid->ijd", g, qp)
    dtable = torch.zeros_like(table).index_add_(
        0, _rel_index(lp, maxlen, q.device).reshape(-1), dpos.reshape(-1, d))
    return (dq[:, :, :length], dk[:, :, :length], dv[:, :, :length], dtable)


def _check(q, k, v, table, maxlen):
    b, h, length, d = q.shape
    _build.check_width("flash_relpos_attention_train", "head dim", d,
                       TRAIN_HEAD_DIMS, _build.OTHER_PRESETS)
    if table.shape != (2 * maxlen, d):
        raise ValueError(f"flash_relpos_attention_train: table "
                         f"{tuple(table.shape)} != ({2 * maxlen}, {d})")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length, d), q.device)
    _build.check_tensor(table, "flash_relpos_attention_train table",
                        (2 * maxlen, d), q.device)
    return b, h, length, d


def _kernel_args(b, h, length, d, maxlen, seed, p):
    return (b * h, length, h, d, maxlen, pick_block(length),
            seed_word(seed, 0), threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p))


def attention_train_fwd(q, k, v, table, maxlen, seed, p, key_len, split=0):
    """K13 on CUDA tensors: (out [B, H, L, d], row max and row sum
    [B, H, L] of the scaled scores); ``key_len`` int32 [B], each in
    [1, L].  ``split``: the warps per row tile (1, 2 or 4), or 0 for the
    launcher's rule (``fwd_occupancy`` reports it)."""
    b, h, length, d = _check(q, k, v, table, maxlen)
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
    attention_train_fwd.launches += 1
    return out, row_max, row_sum


def attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len, out,
                        dout, row_max, row_sum):
    """K14 on CUDA tensors: (dq, dk, dv [B, H, L, d], dtable [2*maxlen,
    d]) from K13's inputs and outputs and the output cotangent ``dout``
    (three launches: dq and the table's partials, dk and dv, the
    table's fixed-order sum)."""
    b, h, length, d = _check(q, k, v, table, maxlen)
    for name, a in (("out", out), ("dout", dout)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length, d), q.device)
    for name, a in (("row_max", row_max), ("row_sum", row_sum)):
        _build.check_tensor(a, f"flash_relpos_attention_train {name}",
                            (b, h, length), q.device)
    lib = _build.library()
    scratch = torch.empty(
        lib.sep_attn_train_bwd_scratch_floats(b * h, length, d),
        dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dtable = torch.empty_like(table)
    err = lib.sep_attn_train_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        key_len.data_ptr(), out.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dtable.data_ptr(), scratch.data_ptr(), scratch.numel(),
        *_kernel_args(b, h, length, d, maxlen, seed, p),
        _build.stream_handle(q.device))
    _build.check_launch("sep_attn_train_bwd_f32", err)
    attention_train_bwd.launches += 1
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


attention_train_fwd.launches = 0
attention_train_bwd.launches = 0


class _FlashRelposAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, table, seed, maxlen, p, key_len):
        out, row_max, row_sum = attention_train_fwd(q, k, v, table, maxlen,
                                                    seed, p, key_len)
        ctx.save_for_backward(q, k, v, table, key_len, out, row_max,
                              row_sum)
        ctx.args = (seed, maxlen, p)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, table, key_len, out, row_max, row_sum = ctx.saved_tensors
        seed, maxlen, p = ctx.args
        dq, dk, dv, dtable = attention_train_bwd(
            q, k, v, table, maxlen, seed, p, key_len, out, dout.contiguous(),
            row_max, row_sum)
        return dq, dk, dv, dtable, None, None, None, None


def flash_relpos_attention_train(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, table: torch.Tensor,
                                 seed: int, maxlen: int, p: float,
                                 lens: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Rel-pos attention with attention-prob hash dropout and a gradient
    in q, k, v and the table, without an [L, L] tensor on the card: q, k,
    v [B, H, L, d] float32 with L <= 512, ``table`` [2*maxlen, d],
    ``seed`` the int hash seed, ``p`` the drop rate, ``lens`` [B] the
    valid keys per row or None.  CPU tensors take the plain version and
    its autograd; CUDA tensors launch K13, and K14 in the backward (each
    ``lens[b]`` must be >= 1)."""
    b, _, length, _ = q.shape
    for a in (q, k, v, table):  # float32 alone, on either device
        _build.check_dtype("flash_relpos_attention_train", a)
    if not supported_length(length):
        raise NotImplementedError(
            f"flash_relpos_attention_train: length {length} > {MAX_LENGTH}; "
            f"the caller takes the dense attention there")
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, table, maxlen, seed, p, lens)
    key_len = _key_lens(b, length, lens, q.device).contiguous()
    if lens is not None:
        torch._assert_async(key_len.min() >= 1)  # no host sync
    return _FlashRelposAttentionTrain.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), table, int(seed),
        int(maxlen), float(p), key_len)
