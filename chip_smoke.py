#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sepreformer_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build     - compile the CUDA kernel library with plain nvcc (sm_90a).
2. kernels   - each kernel against its plain PyTorch version on the card,
               at the shapes SepReformer_Base_WSJ0 gives it: the eval
               kernels (K1 GCFN, K2 rel-pos, K3 masked softmax·V) for a
               B=4 x 4 s batch, the train kernels (K5 k65 depthwise
               backward, K7 and K8 GCFN with hash dropout forward and
               backward, K9 and K10 softmax·dropout·V forward and
               backward, K11 uPIT SI-SNR table) for a B=2 x 4 s train
               batch, and K12 (flash rel-pos attention) for the decoder
               batch of a 70 s request ([2, 8750, 128], maxlen 2000);
               times of the kernel, the plain version, a library call
               where one exists, and the least time the card could take.
3. serve     - Base at full width, seeded weights: three requests through
               ``Separator.__call__`` and one batched B=4 x 4 s forward
               with ragged lengths; every eval kernel's count must rise.
4. profile   - the same model: repeated requests and batched forwards on
               the host clock, then one batched forward traced with
               ``torch.profiler``: the card's idle share, kernel time by
               group, and each kernel's launches per forward.
5. cpu       - the same weights on the CPU (plain versions) against the
               card on a 1 s utterance, with the branches' LayerScale at
               0.5 so they carry signal; a control run on the card with
               TF32 allowed must exceed the limit, so the check can see a
               product that lost float32 accuracy.
6. train     - Base at full width, seeded weights: six ``train_step``s on
               seeded B=2 x 4 s batches (lr from the warmup schedule,
               alpha 0.4); the losses stay finite, the parameters and the
               BatchNorm statistics move, the train kernels' counts rise
               and K1's and K3's do not.  Then one ``eval_step`` through
               K1-K3, and one traced train step: idle share, kernel time
               by group, launches per step (one K7 and one K8 per GCFN),
               peak memory.
7. train_cpu - one train step at dropout 0, every LayerScale at 0.5, on a
               1 s crop, on the card and on the CPU from the same weights:
               the loss and every gradient agree, within a limit that a
               control run with TF32 allowed exceeds.  Then one Base-width
               GCFN in train mode at dropout 0.05 (the hash masks are the
               same on both): its output and ten gradients, card against
               CPU, within the same limit.
8. engine    - the training entry point, ``sepreformer_torch.cli.main``:
               a seeded synthetic corpus (16/4/4 utterances of 3-6 s),
               Base at full width trained for 2 epochs at batch 2 with
               validation and a best checkpoint, resumed for a third,
               then tested (SI-SNRi, SDRi); every kernel of the train and
               eval paths launches.
9. long      - long-form serving, Base at full width, seeded weights with
               every LayerScale at 0.5: a 70 s request (bottleneck length
               8750 > 8192) in full context through ``Separator.__call__``
               runs K12 in all 22 global attentions and no K2 or K3; the
               same request with the switch raised runs the dense K2/K3
               route and must agree within phase 5's limit, which
               control runs exceed (TF32 allowed; K12 on bfloat16 inputs;
               K12 without the rel-pos bias); a 300 s request in
               full context (L 37500, which only K12 can hold) with one
               traced forward; the same 300 s in 8 s chunks
               (``chunk_seconds``: K2 and K3, no K12); and the 70 s
               request as a wav through ``cli.main``'s ``infer_sample``.
               Wall times, audio-s/s and peak memory of each.

Prints one JSON line of kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SAMPLE_RATE = 8000
TRAIN_SECONDS = 4.0            # the dataset's 4 s crop (max_len 32000)
LONG_SECONDS = 70.0            # bottleneck length 8750: past K12's switch
LONGEST_SECONDS = 300.0        # bottleneck length 37500
CHUNK_SECONDS = 8.0            # phase 9's chunked serving
# wrapper -> the CUDA kernels it launches, as named in a profiler trace
KERNEL_SYMBOLS = {"fused_gcfn": "gcfn_kernel",
                  "materialize_pos_kt": "relpos_kernel",
                  "softmax_pv": "softmax_pv_kernel",
                  "depthwise_bwd": "depthwise_bwd",
                  "gcfn_train_fwd": "gcfn_train_fwd_kernel",
                  "gcfn_train_bwd": "gcfn_train_bwd",
                  "softmax_pv_train_fwd": "softmax_pv_train_fwd_kernel",
                  "softmax_pv_train_bwd": "softmax_pv_train_bwd_kernel",
                  "sisnr_pairwise_neg_fused": "pit_sisnr_kernel",
                  "flash_relpos_attention": "flash_relpos_kernel"}
EVAL_KERNELS = ("fused_gcfn", "materialize_pos_kt", "softmax_pv")
LONG_KERNELS = ("flash_relpos_attention",)
TRAIN_KERNELS = ("materialize_pos_kt", "depthwise_bwd", "gcfn_train_fwd",
                 "gcfn_train_bwd", "softmax_pv_train_fwd",
                 "softmax_pv_train_bwd", "sisnr_pairwise_neg_fused")
NO_BACKWARD = ("fused_gcfn", "softmax_pv", "flash_relpos_attention")
# |card - cpu| over max|out| allowed in phase 5; see PERF.md for the
# readings it sits between (float32 on the card, and TF32 allowed)
CPU_REL_LIMIT = 3e-5
# phase 7: max |card - cpu| over every gradient element, over the largest
# cpu gradient; see PERF.md for the readings it sits between
TRAIN_CPU_REL_LIMIT = 1e-4
KERNEL_GROUPS = (  # profile groups of the card's kernels, first match wins
    ("K7 gcfn_train_fwd", ("gcfn_train_fwd",)),
    ("K8 gcfn_train_bwd", ("gcfn_train_bwd",)),
    ("K1 gcfn", ("gcfn_kernel",)),
    ("K12 flash_relpos", ("flash_relpos",)),
    ("K2 relpos", ("relpos_kernel",)),
    ("K9 softmax_pv_train_fwd", ("softmax_pv_train_fwd",)),
    ("K10 softmax_pv_train_bwd", ("softmax_pv_train_bwd",)),
    ("K3 softmax_pv", ("softmax_pv_kernel",)),
    ("K5 depthwise_bwd", ("depthwise_bwd",)),
    ("K11 pit", ("pit_sisnr",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("conv (PyTorch, cuDNN)", ("conv", "cudnn", "implicit", "dgrad",
                               "wgrad")),
    ("copy / layout", ("copy", "cat", "transpose", "index", "gather",
                       "pad", "repeat", "scatter")),
    ("reduce", ("reduce", "norm", "softmax")),
)


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: bytes at the memory rate or
    float32 operations at the CUDA cores' rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def flash_relpos_ops(length, klens, maxlen, heads, d):
    """K12's float32 operations on these inputs, per head: 4*d per (query,
    valid key) pair for q·kᵀ and P·V, and 2*d per query row for each
    distinct clamped table row that its valid keys reach (q·tableᵀ is
    taken once per row and table row, as the plain version takes it)."""
    ops = 0
    for keys in klens:
        ops += 4 * d * length * keys
        for i in range(length):
            lo = max(min(i - keys + 1, maxlen - 1), -maxlen)
            ops += 2 * d * (min(i, maxlen - 1) - lo + 1)
    return heads * ops


def kernel_phase(torch, K, device_ms):
    """Each kernel against its plain version at the main path's shapes.
    ``ms`` is the kernel's device time, ``plain_ms`` and ``library_ms``
    the device time of all the kernels those calls run (durations from a
    profiler trace, not CUDA events: the wrappers' host work outlasts the
    small kernels)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = []

    def record(wrapper, kernel, plain, library, err, nbytes, flops, source,
               replaces, shape, tolerance):
        bound, bound_by = bound_ms(nbytes, flops)
        name = wrapper.__name__
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err,
                   ms=device_ms(kernel, kernel=KERNEL_SYMBOLS[name]),
                   plain_ms=device_ms(plain), bound_ms=bound,
                   bound_by=bound_by,
                   library_ms=None if library is None else device_ms(library))
        results.append(row)
        print(f"[kernels] {name}: {shape}; max |kernel - plain| {err:.3e} "
              f"({tolerance}); ms {row['ms']:.4f}, plain {row['plain_ms']:.4f}"
              f", library {row['library_ms']}, bound {bound:.4f} "
              f"({bound_by})")

    # K1: the widest GCFN of the path, [B=4, T=8000, F=128], ragged lengths
    b, t, f = 4, 8000, 128
    h = 6 * f
    x = randn(b, t, f)
    params = [randn(f), randn(f), randn(f, h, scale=0.1), randn(h, scale=0.1),
              randn(h, 3, scale=0.3), randn(h, scale=0.1),
              randn(h // 2, f, scale=0.1), randn(f, scale=0.1),
              randn(f, scale=0.5)]
    lens = torch.tensor([8000, 7008, 6000, 5008], device=dev)
    err = 0.0
    for ln in (lens, None):
        got = K.fused_gcfn(x, params, 1e-5, ln)
        ref = K.gcfn_plain(x, params, 1e-5, ln)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        err = max(err, (got - ref).abs().max().item())
    flops = b * t * (2 * f * h + 2 * (h // 2) * f       # the two products
                     + 8 * f + 7 * h + 5 * (h // 2) + 3 * f)  # LN, dw3, GLU
    record(K.fused_gcfn, lambda: K.fused_gcfn(x, params, 1e-5, lens),
           lambda: K.gcfn_plain(x, params, 1e-5, lens), None, err,
           4 * (2 * x.numel() + sum(p.numel() for p in params) + b), flops,
           source="sepreformer_torch/csrc/gcfn.cu",
           replaces="sepreformer_tpu/ops/pallas/gcfn.py:394",
           shape=f"x [{b}, {t}, {f}], hidden {h}, lens {lens.tolist()}",
           tolerance="rtol 1e-4, atol 1e-4 (float32)")

    # K2: pos_kt at the padded bottleneck length 512 from a [4000, 16] table
    lp, maxlen, d = 512, 2000, 16
    table = randn(2 * maxlen, d)
    got = K.materialize_pos_kt(table, lp, maxlen)
    ref = K.materialize_pos_kt_plain(table, lp, maxlen)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    idx = torch.from_numpy(K.relpos.relpos_index(lp, maxlen)).to(dev)
    flat = idx[:, None, :] * d + torch.arange(d, device=dev)[None, :, None]
    record(K.materialize_pos_kt,
           lambda: K.materialize_pos_kt(table, lp, maxlen),
           lambda: K.materialize_pos_kt_plain(table, lp, maxlen),
           lambda: torch.take(table, flat), (got - ref).abs().max().item(),
           4 * (got.numel() + table.numel()), 0,
           source="sepreformer_torch/csrc/relpos.cu",
           replaces="sepreformer_tpu/ops/pallas/relpos.py:106",
           shape=f"table [{2 * maxlen}, {d}] -> [{lp}, {d}, {lp}]",
           tolerance="rtol 1e-4, atol 1e-5 (an exact copy)")

    # K3: decoder attention, B*spks=8 rows, 8 heads, L=500 padded to 512
    b, heads, f, length = 8, 8, 128, 500
    d = f // heads
    scores = randn(b, heads, lp, lp, scale=3.0)
    v = randn(b, lp, f)
    klens = torch.tensor([500, 500, 438, 438, 376, 376, 313, 313], device=dev)
    got = K.softmax_pv(scores, v, klens, length)
    ref = K.softmax_pv_plain(scores, v, klens, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    kmask = torch.arange(lp, device=dev)[None] < klens[:, None]
    masked = torch.where(kmask[:, None, None, :], scores,
                         torch.tensor(-1e30, device=dev))
    vh = v.reshape(b, lp, heads, d).permute(0, 2, 1, 3).contiguous()
    keys = sum(klens.tolist())               # valid keys over the batch
    record(K.softmax_pv, lambda: K.softmax_pv(scores, v, klens, length),
           lambda: K.softmax_pv_plain(scores, v, klens, length),
           lambda: torch.matmul(torch.softmax(masked, dim=-1), vh),
           (got - ref).abs().max().item(),
           4 * (heads * lp * keys + keys * f + b * lp * f + b),
           heads * lp * keys * (2 * d + 4),
           source="sepreformer_torch/csrc/softmax_pv.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv.py:342",
           shape=(f"scores [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, {f}], "
                  f"lens {klens.tolist()}, length {length}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)")

    # K5: the widest k65 conv of a B=2 x 4 s train batch, in a decoder
    # stage (B*spks = 4 rows of 8000 frames)
    b, t, c, k = 4, 8000, 128, 65
    x, dy = randn(b, t, c), randn(b, t, c)
    w = randn(c, 1, k, scale=0.1)
    got, ref = K.depthwise_bwd(x, w, dy), K.depthwise_bwd_plain(x, w, dy)
    torch.cuda.synchronize()
    # dw and db sum B*T products each: float32 sums in another order
    for g, r, atol in zip(got, ref, (1e-5, 1e-3, 1e-3)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol)
    xp = torch.nn.functional.pad(x.transpose(1, 2), (k // 2, k // 2))
    dy_ncw = dy.transpose(1, 2).contiguous()
    record(K.depthwise_bwd, lambda: K.depthwise_bwd(x, w, dy),
           lambda: K.depthwise_bwd_plain(x, w, dy),
           lambda: torch.ops.aten.convolution_backward(
               dy_ncw, xp, w, [c], [1], [0], [1], False, [0], c,
               [True, True, True]),
           max((g - r).abs().max().item() for g, r in zip(got, ref)),
           4 * (3 * x.numel() + 2 * w.numel() + c),
           x.numel() * (4 * k + 1),
           source="sepreformer_torch/csrc/depthwise.cu",
           replaces="sepreformer_tpu/ops/pallas/depthwise.py:147",
           shape=f"x, dy [{b}, {t}, {c}], w [{c}, 1, {k}]",
           tolerance="rtol 1e-4; atol 1e-5 dx, 1e-3 dw and db")

    # K7 and K8: the widest GCFN of a B=2 x 4 s train batch, in a decoder
    # stage (B*spks = 4 rows of 8000 frames), p 0.05
    b, t, f, p, seed = 4, 8000, 128, 0.05, 4321
    h = 6 * f
    x, dout = randn(b, t, f), randn(b, t, f)
    params = [randn(f), randn(f), randn(f, h, scale=0.1), randn(h, scale=0.1),
              randn(h, 3, scale=0.3), randn(h, scale=0.1),
              randn(h // 2, f, scale=0.1), randn(f, scale=0.1),
              randn(f, scale=0.5)]
    got = K.gcfn_train_fwd(x, params, 1e-5, seed, p)
    ref = K.gcfn_train_plain(x, params, 1e-5, seed, p)
    torch.cuda.synchronize()
    # a wrong dropout mask errs by O(1) at p = 0.05
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    products = 2 * f * h + 2 * (h // 2) * f         # flops per row
    record(K.gcfn_train_fwd,
           lambda: K.gcfn_train_fwd(x, params, 1e-5, seed, p),
           lambda: K.gcfn_train_plain(x, params, 1e-5, seed, p), None,
           (got - ref).abs().max().item(),
           4 * (2 * x.numel() + sum(q.numel() for q in params)),
           b * t * (products + 8 * f + 7 * h + 6 * (h // 2) + 4 * f),
           source="sepreformer_torch/csrc/gcfn_train.cu",
           replaces="sepreformer_tpu/ops/pallas/gcfn_train.py:549",
           shape=f"x [{b}, {t}, {f}], hidden {h}, p {p}",
           tolerance="rtol 1e-4, atol 1e-4 (float32)")
    dx, dparams = K.gcfn_train_bwd(x, params, 1e-5, seed, p, dout)
    ref_dx, ref_dparams = K.gcfn_train_bwd_plain(x, params, 1e-5, seed, p,
                                                 dout)
    torch.cuda.synchronize()
    err = 0.0
    # dx, then the nine parameter gradients: each sums B*T rows in another
    # order than the plain version's cuBLAS products
    for g, r in zip((dx, *dparams), (ref_dx, *ref_dparams)):
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * r.abs().max().item() + 1e-6)
        err = max(err, (g - r).abs().max().item())
    record(K.gcfn_train_bwd,
           lambda: K.gcfn_train_bwd(x, params, 1e-5, seed, p, dout),
           lambda: K.gcfn_train_bwd_plain(x, params, 1e-5, seed, p, dout),
           None, err,
           4 * (3 * x.numel() + 2 * sum(q.numel() for q in params)),
           # the forward's products again, then dg, dWout, dWin and dxn
           b * t * (3 * products + 40 * f + 20 * h),
           source="sepreformer_torch/csrc/gcfn_train.cu",
           replaces="sepreformer_tpu/ops/pallas/gcfn_train.py:599",
           shape=f"x, dout [{b}, {t}, {f}], hidden {h}, p {p}",
           tolerance="rtol 1e-4; atol 1e-5 x max|plain| + 1e-6, ten outputs")

    # K9 and K10: decoder attention of a B=2 x 4 s train batch (B*spks=4
    # rows, 8 heads, L=500 padded to 512), no key lengths, as in training
    b, f, length, seed = 4, 128, 500, 1234
    scores = randn(b, heads, lp, lp, scale=3.0)
    v, dout = randn(b, lp, f), randn(b, lp, f)
    key_len = torch.full((b,), length, dtype=torch.int32, device=dev)
    err = 0.0
    for p in (0.05, 0.0):
        out, row_max, row_sum = K.softmax_pv_train_fwd(scores, v, seed,
                                                       key_len, length, p)
        ref = K.softmax_pv_dropout_plain(scores, v, seed, None, length, p)
        torch.cuda.synchronize()
        # a wrong dropout mask errs by O(1) at p = 0.05
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
        err = max(err, (out - ref).abs().max().item())
    p = 0.05
    out, row_max, row_sum = K.softmax_pv_train_fwd(scores, v, seed, key_len,
                                                   length, p)
    keys = b * length
    record(K.softmax_pv_train_fwd,
           lambda: K.softmax_pv_train_fwd(scores, v, seed, key_len, length,
                                          p),
           lambda: K.softmax_pv_dropout_plain(scores, v, seed, None, length,
                                              p),
           None, err,
           # the function's own bytes: scores and V of the valid keys in,
           # out written; the row stats are this design's residuals
           4 * (heads * lp * keys + keys * f + b * lp * f),
           heads * lp * keys * (2 * d + 4),
           source="sepreformer_torch/csrc/softmax_pv_train.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:221",
           shape=(f"scores [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, {f}], "
                  f"length {length}, p 0.05 and 0"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)")
    ds, dv = K.softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum,
                                    seed, key_len, length, p)
    ds_ref, dv_ref = K.softmax_pv_dropout_bwd_plain(scores, v, seed, None,
                                                    length, p, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(ds, ds_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    record(K.softmax_pv_train_bwd,
           lambda: K.softmax_pv_train_bwd(scores, v, out, dout, row_max,
                                          row_sum, seed, key_len, length, p),
           lambda: K.softmax_pv_dropout_bwd_plain(scores, v, seed, None,
                                                  length, p, dout),
           None, max((ds - ds_ref).abs().max().item(),
                     (dv - dv_ref).abs().max().item()),
           # JAX's K10 reads scores, v and dout: scores and V of the valid
           # keys and dout in, the full dScores and dV written
           4 * (heads * lp * keys + scores.numel() + keys * f
                + 2 * b * lp * f),
           heads * lp * keys * (4 * d + 8),
           source="sepreformer_torch/csrc/softmax_pv_train.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:249",
           shape=(f"scores [{b}, {heads}, {lp}, {lp}], v, out, dout "
                  f"[{b}, {lp}, {f}], length {length}, p 0.05"),
           tolerance="rtol 1e-4; atol 1e-5 dScores, 1e-4 dV")

    # K11: the time-loss table of a B=2 x 4 s batch, two speakers
    spk, b, t = 2, 2, 32000
    src = randn(spk, b, t, scale=0.1)
    est = src.flip(0) + randn(spk, b, t, scale=0.02)
    got = K.sisnr_pairwise_neg_fused(est, src)
    ref = K.sisnr_pairwise_neg(est, src)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    record(K.sisnr_pairwise_neg_fused,
           lambda: K.sisnr_pairwise_neg_fused(est, src),
           lambda: K.sisnr_pairwise_neg(est, src), None,
           (got - ref).abs().max().item(),
           4 * (2 * est.numel() + b * spk * spk),
           b * spk * spk * t * 11,
           source="sepreformer_torch/csrc/pit.cu",
           replaces="sepreformer_tpu/ops/pallas/pit.py:70",
           shape=f"est, src [{spk}, {b}, {t}]",
           tolerance="rtol 1e-4, atol 1e-4 (dB, float32)")
    flash_kernel_row(torch, K, device_ms, randn, record)
    return results


def flash_kernel_row(torch, K, device_ms, randn, record):
    """K12 at the decoder batch of a 70 s request in full context (B*spks
    = 2 rows, 8 heads, L = 8750 > 8192, maxlen 2000, ragged key lengths),
    against its plain version; the library yardstick is PyTorch's SDPA
    with the rel-pos bias and the key mask as a float mask built outside
    the timed call; today's dense route at the same shape (K2, the score
    products, K3) is timed beside it.  ``record`` adds the row."""
    from sepreformer_torch.models.blocks import fused_pv_scores, pad_time

    dev = torch.device("cuda")
    b, length, maxlen, heads, d = 2, 8750, 2000, 8, 16
    f = heads * d
    q, k, v = randn(b, length, f), randn(b, length, f), randn(b, length, f)
    table = randn(2 * maxlen, d)
    klens = torch.tensor([8750, 7000], device=dev)
    got = K.flash_relpos_attention(q, k, v, table, maxlen, klens)
    ref = K.flash_relpos_attention_plain(q, k, v, table, maxlen, klens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    err = (got - ref).abs().max().item()
    del got

    def split(a):                                   # [B, H, L, d]
        return a.reshape(b, length, heads, d).transpose(1, 2).contiguous()

    qh, kh, vh = split(q), split(k), split(v)
    # the mask's rows padded to a multiple of 16 floats, so SDPA takes it
    # as it is
    storage = torch.empty(b, heads, length, -(-length // 16) * 16,
                          device=dev)
    bias = storage[..., :length]
    pos = torch.arange(length, device=dev)
    with torch.no_grad():
        for i0 in range(0, length, 1024):
            by_row = torch.matmul(qh[:, :, i0:i0 + 1024], table.t())
            idx = torch.clamp(pos[i0:i0 + 1024, None] - pos[None],
                              -maxlen, maxlen - 1) + maxlen
            bias[:, :, i0:i0 + 1024] = torch.gather(
                by_row, 3, idx.expand(b, heads, *idx.shape)) / math.sqrt(d)
        kmask = pos[None] < klens[:, None]
        bias.masked_fill_(~kmask[:, None, None, :], float("-inf"))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias)

    lib_err = (library().transpose(1, 2).reshape(b, length, f)
               - ref).abs().max().item()
    print(f"[kernels] SDPA with the bias as a float mask: max |sdpa - plain| "
          f"{lib_err:.3e}")
    keys = sum(klens.tolist())
    lp = -(-length // 128) * 128
    q4, k4 = q.reshape(b, length, heads, d), k.reshape(b, length, heads, d)
    vpad = pad_time(v, lp).contiguous()

    def dense():
        kt = K.materialize_pos_kt(table, lp, maxlen)
        return K.softmax_pv(fused_pv_scores(q4, k4, kt), vpad, klens, length)

    torch.testing.assert_close(dense()[:, :length], ref, rtol=1e-4,
                               atol=1e-5)
    record(K.flash_relpos_attention,
           lambda: K.flash_relpos_attention(q, k, v, table, maxlen, klens),
           lambda: K.flash_relpos_attention_plain(q, k, v, table, maxlen,
                                                  klens),
           library, err,
           # q in and out written; k and v of the valid keys; the table
           4 * (2 * q.numel() + 2 * keys * f + table.numel() + b),
           flash_relpos_ops(length, klens.tolist(), maxlen, heads, d),
           source="sepreformer_torch/csrc/flash_relpos.cu",
           replaces="sepreformer_tpu/ops/pallas/attention.py:237",
           shape=(f"q, k, v [{b}, {length}, {f}], table [{2 * maxlen}, "
                  f"{d}], lens {klens.tolist()}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)")
    del storage, bias
    torch.cuda.empty_cache()
    print(f"[kernels] the same shape through the dense route (K2 pos_kt "
          f"[{lp}, {d}, {lp}], the score products, K3): "
          f"{device_ms(dense):.4f} ms")
    torch.cuda.empty_cache()


def serve_phase(torch, np, sep_torch, K):
    """Base at full width: three requests and one ragged B=4 x 4 s batch."""
    t0 = time.perf_counter()
    sep = sep_torch.load_separator("SepReformer_Base_WSJ0", device="cuda",
                                   seed=0)
    print(f"[serve] Base built in {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in sep.model.parameters())} parameters")
    rng = np.random.default_rng(0)
    sep((rng.normal(size=4 * SAMPLE_RATE) * 0.1).astype(np.float32))  # warm

    K.reset_launches()
    torch.cuda.synchronize()
    forwards = 0
    for seconds in (2.0, 3.3, 4.0):
        n = int(seconds * SAMPLE_RATE)
        wav = (rng.normal(size=n) * 0.1).astype(np.float32)
        t0 = time.perf_counter()
        out = sep(wav)
        dt = time.perf_counter() - t0
        forwards += 1
        assert len(out) == 2 and all(o.shape == (n,) for o in out)
        assert all(np.isfinite(o).all() for o in out), "non-finite audio"
        print(f"[serve] request {seconds:.1f} s: {dt * 1e3:.2f} ms, "
              f"{seconds / dt:.2f} audio-s/s")
    lengths = [32000, 28000, 24000, 20000]
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.normal(size=n) * 0.1
    t0 = time.perf_counter()
    audio = sep.separate(batch, lengths)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    forwards += 1
    assert tuple(audio.shape) == (2, 4, 32000), tuple(audio.shape)
    assert torch.isfinite(audio).all().item(), "non-finite batched audio"
    print(f"[serve] batch B=4 x 4 s (lengths {lengths}): {dt * 1e3:.2f} ms, "
          f"{sum(lengths) / SAMPLE_RATE / dt:.2f} audio-s/s")
    counts = K.launch_counts()
    print(f"[serve] launches over {forwards} forwards: {counts}")
    missing = [name for name in EVAL_KERNELS if counts[name] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    return sep, counts


def profile_phase(torch, np, sep, K, busy_us, kernel_events, iters=5):
    """Where the served model spends the card's time: host-clock times of
    repeated requests and batched forwards, then one traced forward."""
    rng = np.random.default_rng(2)
    for seconds in (2.0, 4.0):
        wav = (rng.normal(size=int(seconds * SAMPLE_RATE)) * 0.1).astype(
            np.float32)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            sep(wav)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"[profile] request {seconds:.1f} s over {iters} calls, ms: "
              f"{[round(t, 2) for t in times]}")
    lengths = [32000, 28000, 24000, 20000]
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.normal(size=n) * 0.1
    x = torch.from_numpy(batch).to(sep.device)
    lens = torch.tensor(lengths, device=sep.device)

    def forward():
        with torch.inference_mode():
            return sep.model(x, lengths=lens)

    forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(walls)
    print(f"[profile] batch B=4 x 4 s over {iters} forwards, ms: "
          f"{[round(t, 2) for t in walls]}; "
          f"{sum(lengths) / SAMPLE_RATE / (median / 1e3):.2f} audio-s/s at "
          f"the median")

    K.reset_launches()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = kernel_events(prof)
    print_trace("profile", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "forward")


def cpu_phase(torch, np, sep_torch, sep):
    """The card's output against the CPU's plain path on the same weights,
    with every LayerScale at 0.5 (at the init's 1e-5 the branches are too
    small to show an error).  A control run on the card with TF32 allowed
    shows that the limit is tight enough to catch it."""
    rng = np.random.default_rng(1)
    wav = (rng.normal(size=SAMPLE_RATE) * 0.1).astype(np.float32)
    model = copy.deepcopy(sep.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
    cpu = np.stack(sep_torch.Separator(
        sep.variant, copy.deepcopy(model).to("cpu"))(wav))
    scale = float(np.abs(cpu).max())
    errs = {}
    for label, tf32 in (("float32", False), ("control, TF32 allowed", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            gpu = np.stack(sep_torch.Separator(sep.variant, model)(wav))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        assert np.isfinite(gpu).all(), label
        errs[label] = float(np.abs(gpu - cpu).max()) / scale
        print(f"[cpu] {label}: max |card - cpu| / max|out| "
              f"{errs[label]:.3e} (max|out| {scale:.3f}), limit "
              f"{CPU_REL_LIMIT:.1e}")
    assert errs["float32"] <= CPU_REL_LIMIT, "card disagrees with the CPU"
    assert errs["control, TF32 allowed"] > CPU_REL_LIMIT, (
        "the limit does not catch TF32 products")


def synthetic_batch(torch, np, rng, batch, samples, spks=2):
    """A seeded stand-in for a training batch: ``spks`` sources of noise
    shaped by random 9-tap filters at 0.1 rms, and their sum.  Returns
    (mixture [B, T], sources [S, B, T]) on the CPU."""
    noise = rng.normal(size=(spks, batch, samples + 8))
    taps = rng.uniform(-1.0, 1.0, size=(spks, batch, 9))
    src = np.stack([[np.convolve(noise[i, j], taps[i, j], "valid")[:samples]
                     for j in range(batch)] for i in range(spks)])
    src = 0.1 * src / src.std(axis=-1, keepdims=True)
    src = torch.from_numpy(src.astype(np.float32))
    return src.sum(dim=0), src


def group_kernels(kernels):
    by_group, by_name = defaultdict(float), defaultdict(float)
    count = defaultdict(int)
    for name, _, dur in kernels:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "elementwise / other")
        by_group[group] += dur
        by_name[name[:80]] += dur
        count[name[:80]] += 1
    return by_group, by_name, count


def print_trace(tag, kernels, busy, window_us, ours, what):
    by_group, by_name, count = group_kernels(kernels)
    print(f"[{tag}] traced {what}: window {window_us / 1e3:.2f} ms, card "
          f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / window_us:.3f}, "
          f"{len(kernels)} kernel launches; ours per {what} {ours}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] group {group}: {us / 1e3:.3f} ms")
    for name in sorted(by_name, key=lambda n: -by_name[n])[:10]:
        print(f"[{tag}] kernel {by_name[name] / 1e3:.3f} ms "
              f"x{count[name]}: {name}")


def train_phase(torch, np, sep_torch, K, busy_us, kernel_events, steps=6):
    """Base at full width: ``steps`` train steps on seeded B=2 x 4 s
    batches, one eval step, one traced train step."""
    from sepreformer_torch.engine import (
        LRController,
        create_train_state,
        eval_step,
        train_step,
    )

    cfg = sep_torch.get_variant("SepReformer_Base_WSJ0")
    o = cfg.optim
    t0 = time.perf_counter()
    state = create_train_state(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    print(f"[train] Base built in {time.perf_counter() - t0:.2f} s; batch "
          f"{cfg.dataset.batch_size} x {cfg.dataset.max_len} samples, "
          f"dropout {cfg.model.dropout}")
    lrc = LRController(o.lr, o.warmup_steps, o.plateau_factor,
                       o.plateau_patience, o.plateau_min_lr)
    rng = np.random.default_rng(3)
    batches = [tuple(a.cuda() for a in synthetic_batch(
        torch, np, rng, cfg.dataset.batch_size, cfg.dataset.max_len))
        for _ in range(steps + 2)]
    model = state.model
    watched = {name: p.detach().clone() for name, p in
               model.named_parameters() if name.endswith(
                   ("pe_k.weight", "dw_conv_1d.weight", "linear_q.weight"))}
    watched.update({name: b.clone() for name, b in model.named_buffers()
                    if name.endswith(("running_mean", "running_var"))})
    gen = torch.Generator().manual_seed(1)

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    times = []
    for step in range(steps):
        lrc.warmup_step()
        mix, src = batches[step]
        t0 = time.perf_counter()
        metrics = train_step(state, mix, src, lrc.lr, 0.4, gen)
        values = {k: float(v) for k, v in metrics.items()}  # waits
        times.append((time.perf_counter() - t0) * 1e3)
        assert all(np.isfinite(v) for v in values.values()), values
        print(f"[train] step {step}: {times[-1]:.2f} ms, lr {lrc.lr:.2e}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] launches over {steps} steps: {counts}")
    missing = [n for n in TRAIN_KERNELS if counts[n] == 0]
    assert not missing, f"train kernels never launched: {missing}"
    stray = [n for n in NO_BACKWARD if counts[n]]
    assert not stray, f"eval kernels without a backward ran: {stray}"
    gcfns = sum(type(m).__name__ == "GCFN" for m in model.modules())
    per_step = {n: counts[n] / steps for n in ("gcfn_train_fwd",
                                               "gcfn_train_bwd")}
    print(f"[train] {gcfns} GCFNs; K7, K8 launches per step {per_step}")
    assert all(v == gcfns for v in per_step.values()), (
        "one K7 and one K8 launch per GCFN and step")
    now = dict(model.named_parameters())
    now.update(model.named_buffers())
    frozen = [n for n, before in watched.items()
              if torch.equal(before, now[n].detach())]
    assert not frozen, f"unchanged by training: {frozen}"
    median = statistics.median(times[1:])
    batch_s = cfg.dataset.batch_size * TRAIN_SECONDS
    print(f"[train] step ms after the first: "
          f"{[round(t, 2) for t in times[1:]]}; median {median:.2f} ms, "
          f"{batch_s / (median / 1e3):.2f} training audio-s/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")

    K.reset_launches()
    mix, src = batches[steps]
    metrics = {k: float(v) for k, v in eval_step(state, mix, src).items()}
    eval_counts = K.launch_counts()
    print(f"[train] eval step: {metrics}; launches {eval_counts}")
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    missing = [n for n in EVAL_KERNELS if eval_counts[n] == 0]
    assert not missing, f"eval kernels never launched: {missing}"

    mix, src = batches[steps + 1]
    K.reset_launches()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_step(state, mix, src, lrc.lr, 0.4, gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = kernel_events(prof)
    print_trace("train", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "train step")
    return counts


def train_cpu_phase(torch, np, sep_torch):
    """One train step on the card and on the CPU from the same weights:
    dropout 0, every LayerScale at 0.5, a 1 s crop.  The loss and every
    gradient (read after the step's clip) must agree; a control run on
    the card with TF32 allowed must exceed the gradient limit."""
    import dataclasses

    from sepreformer_torch.engine import create_train_state, train_step
    from sepreformer_torch.models import build_model

    base = sep_torch.get_variant("SepReformer_Base_WSJ0")
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, dropout=0.0))
    model = build_model(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
    mix, src = synthetic_batch(torch, np, np.random.default_rng(5),
                               cfg.dataset.batch_size, SAMPLE_RATE)

    def step(device):
        state = create_train_state(cfg, model=copy.deepcopy(model).to(device))
        metrics = train_step(state, mix, src, 1e-3, 0.4,
                             torch.Generator().manual_seed(6))
        grads = {n: p.grad.detach().cpu()
                 for n, p in state.model.named_parameters()}
        return float(metrics["total_loss"]), grads

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = step("cpu")
    print(f"[train_cpu] CPU step {time.perf_counter() - t0:.2f} s, "
          f"loss {cpu_loss:.6f}")
    scale = max(g.abs().max().item() for g in cpu_grads.values())
    errs = {}
    for label, tf32 in (("float32", False), ("control, TF32 allowed", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            loss, grads = step("cuda")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        assert all(torch.isfinite(g).all() for g in grads.values()), label
        worst = max(grads, key=lambda n: (grads[n] - cpu_grads[n]).abs().max())
        errs[label] = (grads[worst] - cpu_grads[worst]).abs().max().item()
        errs[label] /= scale
        loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
        print(f"[train_cpu] {label}: loss {loss:.6f} (|card - cpu| / |cpu| "
              f"{loss_err:.3e}); max |card - cpu| over every gradient / max "
              f"|cpu gradient| {errs[label]:.3e} (max {scale:.3e}, worst "
              f"{worst}), limit {TRAIN_CPU_REL_LIMIT:.1e}")
        if not tf32:
            assert loss_err <= TRAIN_CPU_REL_LIMIT, "loss disagrees"
    assert errs["float32"] <= TRAIN_CPU_REL_LIMIT, (
        "card gradients disagree with the CPU")
    assert errs["control, TF32 allowed"] > TRAIN_CPU_REL_LIMIT, (
        "the limit does not catch TF32 products")
    gcfn_train_cpu(torch, np)


def gcfn_train_cpu(torch, np):
    """One Base-width GCFN in train mode at dropout 0.05 on the card (K7,
    K8) and on the CPU (plain, the same hash masks): the output and the
    ten gradients (x and nine parameters) within the phase's limit, each
    over its largest CPU value."""
    from sepreformer_torch.models.blocks import GCFN, TrainMode

    gen = torch.Generator().manual_seed(7)
    gcfn = GCFN(128)
    with torch.no_grad():
        for prm in gcfn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.2)
        gcfn.Layer_scale.layer_scale.fill_(0.5)
    x = torch.randn(2, 2000, 128, generator=gen)
    w = torch.randn(2, 2000, 128, generator=gen)

    def run(device):
        module = copy.deepcopy(gcfn).to(device)
        xd = x.to(device).detach().requires_grad_()
        train = TrainMode(0.05, torch.Generator(device=device),
                          torch.Generator().manual_seed(8))
        out = module(xd, None, train)
        (out * w.to(device)).sum().backward()
        grads = [xd.grad] + [prm.grad for prm in module.parameters()]
        return [a.detach().cpu() for a in [out] + grads]

    cpu, card = run("cpu"), run("cuda")
    names = ["out", "dx"] + [n for n, _ in gcfn.named_parameters()]
    worst = max(((c - g).abs().max().item() / g.abs().max().item(), n)
                for n, c, g in zip(names, card, cpu))
    print(f"[train_cpu] GCFN [2, 2000, 128], p 0.05: max |card - cpu| / "
          f"max|cpu| over the output and ten gradients {worst[0]:.3e} "
          f"(worst {worst[1]}), limit {TRAIN_CPU_REL_LIMIT:.1e}")
    assert worst[0] <= TRAIN_CPU_REL_LIMIT, "the train GCFN disagrees"


def engine_phase(torch, np, K):
    """Train Base from ``sepreformer_torch.cli.main`` on a seeded synthetic
    corpus: 2 epochs, a resumed third, then test."""
    import csv
    import logging
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.data.synth import generate_corpus

    lines = []

    class Collect(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("sepreformer_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(Collect())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        generate_corpus(os.path.join(tmp, "corpus"), n_train=16, n_valid=4,
                        n_test=4, seed=0)
        print(f"[engine] corpus 16/4/4 utterances of 3-6 s in "
              f"{time.perf_counter() - t0:.2f} s")
        work = os.path.join(tmp, "work")
        args = ["--model", "SepReformer_Base_WSJ0", "--scp-root",
                os.path.join(tmp, "corpus"), "--scp-dir", "scp",
                "--workdir", work, "--batch-size", "2",
                "--set", "engine.test_epochs="]
        K.reset_launches()
        for mode, extra in (("train", ["--max-epoch", "3"]),
                            ("resume", ["--max-epoch", "4"]),
                            ("test", ["--engine-mode", "test"])):
            t0 = time.perf_counter()
            assert cli.main(args + extra) == 0, mode
            print(f"[engine] {mode}: {time.perf_counter() - t0:.2f} s")
        counts = K.launch_counts()
        for line in lines:
            print(f"[engine] log: {line}")
        epochs = [ln for ln in lines if ln.startswith("epoch ")]
        assert len(epochs) == 3, epochs
        assert any(ln.startswith("resumed from epoch") for ln in lines)
        for ln in epochs:
            losses = [float(v) for v in ln.split()[3:6:2]]   # train, valid
            assert all(np.isfinite(v) for v in losses), ln
        ckpt = os.path.join(work, "log", "scratch_weights", "epoch.0003.pth")
        assert os.path.exists(ckpt), "no checkpoint of the resumed epoch"
        means = {}
        for name in ("SISNRi", "SDRi"):
            with open(os.path.join(work, f"test_{name}_value.csv")) as f:
                rows = list(csv.reader(f))
            assert len(rows) == 4, rows
            means[name] = float(np.mean([float(r[1]) for r in rows]))
        print(f"[engine] test over 4 utterances: SI-SNRi {means['SISNRi']:.4f}"
              f" dB, SDRi {means['SDRi']:.4f} dB")
        assert all(np.isfinite(v) for v in means.values()), means
    print(f"[engine] launches over the three runs: {counts}")
    missing = [n for n in TRAIN_KERNELS + EVAL_KERNELS if counts[n] == 0]
    assert not missing, f"kernels never launched by the CLI: {missing}"
    return counts


class peak_by_module:
    """Context: for each top-level part of a SepReformer forward (the
    encoder, each separator stage, the output layer and decoder, each aux
    head), the bytes allocated when it starts and the peak while it runs,
    read from the caching allocator's counters (no synchronisation)."""

    def __init__(self, torch, model):
        sep = model.separator
        self.torch = torch
        self.parts = {"audio_encoder": model.audio_encoder,
                      "feature_projector": model.feature_projector,
                      "bottleneck_G": sep.bottleneck_G,
                      "out_layer": model.out_layer,
                      "audio_decoder": model.audio_decoder}
        for prefix, mods in (("enc_stages", sep.enc_stages),
                             ("dec_stages", sep.dec_stages),
                             ("out_layer_bn", model.out_layer_bn),
                             ("decoder_bn", model.decoder_bn)):
            self.parts.update({f"{prefix}.{i}": m for i, m in enumerate(mods)})
        self.peaks, self.handles = {}, []

    def __enter__(self):
        cuda = self.torch.cuda
        for name, module in self.parts.items():
            def pre(module, args, name=name):
                cuda.reset_peak_memory_stats()
                self.peaks[name] = (cuda.memory_allocated(), 0)

            def post(module, args, out, name=name):
                self.peaks[name] = (self.peaks[name][0],
                                    max(self.peaks[name][1],
                                        cuda.max_memory_allocated()))
            self.handles += [module.register_forward_pre_hook(pre),
                             module.register_forward_hook(post)]
        return self.peaks

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def size_checks(torch, K, frames):
    """K1 and K12 against their plain versions at the sizes a 300 s
    request gives them: the decoder's last GCFN on [2, frames, 128] and
    the decoder's attention at L = frames / 16, ragged.  Both index with
    64-bit offsets; at 300 s the largest element offset, K1's x at
    2 * 600000 * 128, is 1.5e8, far below 2**31 (K1 keeps its hidden
    width in shared memory).  An int32 offset into x would first wrap at
    2**31 / 256 = 8.4e6 frames, a 70 min input at 8 kHz."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    f, h = 128, 768
    x = randn(2, frames, f)
    params = [randn(f), randn(f), randn(f, h, scale=0.1), randn(h, scale=0.1),
              randn(h, 3, scale=0.3), randn(h, scale=0.1),
              randn(h // 2, f, scale=0.1), randn(f, scale=0.1),
              randn(f, scale=0.5)]
    lens = torch.tensor([frames, frames * 3 // 4], device=dev)
    got = K.fused_gcfn(x, params, 1e-5, lens)
    ref = K.gcfn_plain(x, params, 1e-5, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    print(f"[long] K1 at x [2, {frames}, {f}], lens {lens.tolist()}: max "
          f"|kernel - plain| {(got - ref).abs().max().item():.3e}")
    del x, got, ref
    length = frames // 16
    q, k, v = randn(2, length, f), randn(2, length, f), randn(2, length, f)
    table = randn(4000, 16)
    lens = torch.tensor([length, length * 4 // 5], device=dev)
    got = K.flash_relpos_attention(q, k, v, table, 2000, lens)
    ref = K.flash_relpos_attention_plain(q, k, v, table, 2000, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    print(f"[long] K12 at q, k, v [2, {length}, {f}], lens {lens.tolist()}: "
          f"max |kernel - plain| {(got - ref).abs().max().item():.3e}")
    torch.cuda.empty_cache()


def long_phase(torch, np, sep_torch, K, busy_us, kernel_events):
    """Long-form serving of Base at full width, seeded weights, every
    LayerScale at 0.5 (so that the attention branches carry signal): a
    70 s request in full context (K12) against the dense K2/K3 route
    with three controls, a 300 s request in full context with one traced
    forward, the same 300 s in 8 s chunks, and the 70 s request as a wav
    through ``cli.main``'s ``infer_sample``.  Returns the kernels'
    launches over the runs of the main path (not the comparison runs)."""
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.data.audio import read_wav, write_wav
    from sepreformer_torch.models import blocks

    variant = sep_torch.get_variant("SepReformer_Base_WSJ0")
    model = sep_torch.build_model(variant.model, device="cuda",
                                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
    sep = sep_torch.Separator(variant, model)
    global_attentions = sum(type(m).__name__ == "EGA" for m in model.modules())
    rng = np.random.default_rng(9)
    total = defaultdict(int)

    def run(label, fn, seconds, main_path=True):
        """``fn()`` with every count at 0 just before and read just after,
        on the host clock, with the peak memory of the call."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        if main_path:
            for name, n in counts.items():
                total[name] += n
        ours = {n: c for n, c in counts.items() if c}
        print(f"[long] {label}: {dt:.3f} s wall, {seconds / dt:.2f} "
              f"audio-s/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {ours}")
        return out, counts

    def separated(separator, wav):
        out = np.stack(separator(wav))
        assert out.shape == (2, len(wav)), out.shape
        assert np.isfinite(out).all(), "non-finite audio"
        return out

    # a. 70 s in full context: K12 in every global attention, no pos_kt
    n70 = int(LONG_SECONDS * SAMPLE_RATE)
    wav70 = (rng.normal(size=n70) * 0.1).astype(np.float32)
    for label in ("70 s full context, K12 route (first call)",
                  "70 s full context, K12 route"):
        flash, counts = run(label, lambda: separated(sep, wav70),
                            LONG_SECONDS)
        assert counts["flash_relpos_attention"] == global_attentions == 22
        assert counts["materialize_pos_kt"] == counts["softmax_pv"] == 0
    saved = blocks.FUSED_PV_MAX_LENGTH
    blocks.FUSED_PV_MAX_LENGTH = 10 ** 9
    try:
        dense, counts = run("70 s full context, dense K2/K3 route (switch "
                            "raised)", lambda: separated(sep, wav70),
                            LONG_SECONDS, main_path=False)
    finally:
        blocks.FUSED_PV_MAX_LENGTH = saved
    assert counts["flash_relpos_attention"] == 0
    assert counts["materialize_pos_kt"] == 1
    assert counts["softmax_pv"] == global_attentions
    scale = float(np.abs(dense).max())
    errs = {"float32": float(np.abs(flash - dense).max()) / scale}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        control, _ = run("70 s full context, K12 route, TF32 allowed",
                         lambda: separated(sep, wav70), LONG_SECONDS,
                         main_path=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    errs["control, TF32 allowed"] = float(
        np.abs(control - dense).max()) / scale
    # TF32 reaches only the cuBLAS and cuDNN products (K12 runs FMAs), so
    # two controls change the K12 route itself: K12 on inputs rounded to
    # bfloat16 (what a bfloat16 version of the route would read), and K12
    # without the rel-pos bias
    routes = {
        "control, K12 on bfloat16 inputs":
            lambda q, k, v, table, maxlen, lens: K.flash_relpos_attention(
                *(a.bfloat16().float() for a in (q, k, v, table)), maxlen,
                lens),
        "control, K12 without the bias":
            lambda q, k, v, table, maxlen, lens: K.flash_relpos_attention(
                q, k, v, torch.zeros_like(table), maxlen, lens),
    }
    k12_route = blocks.flash_relpos_attention
    for label, route in routes.items():
        blocks.flash_relpos_attention = route
        try:
            control, counts = run(f"70 s full context, {label}",
                                  lambda: separated(sep, wav70),
                                  LONG_SECONDS, main_path=False)
        finally:
            blocks.flash_relpos_attention = k12_route
        assert counts["flash_relpos_attention"] == global_attentions
        errs[label] = float(np.abs(control - dense).max()) / scale
    for label, e in errs.items():
        print(f"[long] K12 route against the dense route, {label}: max |d| "
              f"/ max|out| {e:.3e} (max|out| {scale:.3f}), limit "
              f"{CPU_REL_LIMIT:.1e}")
    assert errs["float32"] <= CPU_REL_LIMIT, "K12 route disagrees"
    for label, e in errs.items():
        assert label == "float32" or e > CPU_REL_LIMIT, (
            f"the limit does not catch the {label}")
    del flash, dense, control

    # b. 300 s in full context (L 37500: only K12 holds it), then traced
    n300 = int(LONGEST_SECONDS * SAMPLE_RATE)
    wav300 = (rng.normal(size=n300) * 0.1).astype(np.float32)
    _, counts = run("300 s full context", lambda: separated(sep, wav300),
                    LONGEST_SECONDS)
    assert counts["flash_relpos_attention"] == global_attentions
    assert counts["materialize_pos_kt"] == counts["softmax_pv"] == 0
    size_checks(torch, K, n300 // variant.model.enc_stride)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    K.reset_launches()
    torch.cuda.synchronize()
    with peak_by_module(torch, model) as peaks, \
            torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sep.separate(wav300[None], [n300])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels = kernel_events(prof)
    print_trace("long", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "300 s forward")
    for name, (before, peak) in peaks.items():
        print(f"[long] traced 300 s forward, memory by module: {name}: "
              f"{before / 2**30:.3f} GiB held at its start, peak "
              f"{peak / 2**30:.3f} GiB")

    # c. the same 300 s in 8 s chunks: K2 and K3, no K12
    chunked = sep_torch.Separator(variant, model, chunk_seconds=CHUNK_SECONDS)
    _, counts = run(f"300 s in {CHUNK_SECONDS:.0f} s chunks",
                    lambda: separated(chunked, wav300), LONGEST_SECONDS)
    assert counts["flash_relpos_attention"] == 0
    assert counts["materialize_pos_kt"] > 0 and counts["softmax_pv"] > 0
    del sep, chunked, model
    torch.cuda.empty_cache()

    # d. the 70 s request as a wav through the CLI, in full context
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "long70.wav")
        write_wav(path, wav70, SAMPLE_RATE)
        out_dir = os.path.join(tmp, "out")
        args = ["--model", "SepReformer_Base_WSJ0", "--engine-mode",
                "infer_sample", "--sample-file", path, "--workdir",
                os.path.join(tmp, "work"), "--out-wav-dir", out_dir]
        status, counts = run("cli infer_sample, 70 s wav (with the model's "
                             "set-up)", lambda: cli.main(args), LONG_SECONDS)
        assert status == 0
        assert counts["flash_relpos_attention"] == global_attentions
        for i in range(2):
            x, rate = read_wav(os.path.join(out_dir, f"long70_out_{i}.wav"))
            assert rate == SAMPLE_RATE and x.shape == (n70,), x.shape
            assert np.isfinite(x).all() and np.abs(x).max() > 0.5
    print(f"[long] launches over the phase's main-path runs: {dict(total)}")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        import sepreformer_torch as sep_torch
        from sepreformer_torch.ops import kernels as K
        from sepreformer_torch.ops.kernels import _build
        from sepreformer_torch.profiling import (
            busy_us,
            device_ms,
            kernel_events,
        )
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 1
    if not os.path.abspath(sep_torch.__file__).startswith(ROOT + os.sep):
        print(f"chip_smoke: imported {sep_torch.__file__}, not the package "
              f"beside this script", file=sys.stderr)
        return 1
    jax_like = [m for m in ("jax", "flax", "sepreformer_tpu")
                if m in sys.modules]
    if jax_like:
        print(f"chip_smoke: the port imported {jax_like}", file=sys.stderr)
        return 1

    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    ok = True
    phase_s = {}

    def run(name, fn, *fn_args):
        nonlocal ok
        t0 = time.perf_counter()
        try:
            return fn(*fn_args)
        except Exception as exc:  # report the phase, run the rest
            import traceback

            traceback.print_exc()
            print(f"[{name}] FAILED: {exc!r}")
            ok = False
            return None
        finally:
            phase_s[name] = time.perf_counter() - t0
            print(f"[{name}] {phase_s[name]:.2f} s")

    lib = run("build", _build.library)
    if lib is None:
        return 1
    log = _build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    kernels = run("kernels", kernel_phase, torch, K, device_ms) or []
    served = run("serve", serve_phase, torch, np, sep_torch, K)
    counts = served[1] if served else {}
    if served:
        run("profile", profile_phase, torch, np, served[0], K, busy_us,
            kernel_events)
        run("cpu", cpu_phase, torch, np, sep_torch, served[0])
        del served
    train_counts = run("train", train_phase, torch, np, sep_torch, K,
                       busy_us, kernel_events) or {}
    run("train_cpu", train_cpu_phase, torch, np, sep_torch)
    run("engine", engine_phase, torch, np, K)
    long_counts = run("long", long_phase, torch, np, sep_torch, K, busy_us,
                      kernel_events) or {}

    # each kernel's launches on the main path of its slice: the eval
    # kernels' in serving, the train kernels' in training, K12's in
    # long-form serving
    for row in kernels:
        name = row["name"]
        row["launches"] = (counts.get(name, 0) if name in EVAL_KERNELS
                           else long_counts.get(name, 0)
                           if name in LONG_KERNELS
                           else train_counts.get(name, 0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    print("[phases] " + ", ".join(f"{k} {v:.2f} s" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    if not ok:
        return 1
    # the run used one card, whatever the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
