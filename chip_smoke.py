#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sepreformer_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build     - compile the CUDA kernel library with plain nvcc (sm_90a).
2. kernels   - each kernel against its plain PyTorch version on the card,
               at the shapes SepReformer_Base_WSJ0 gives it: the eval
               kernels (K1 GCFN, K2 rel-pos, K3 masked softmax·V) for a
               B=4 x 4 s batch, the train kernels (K5 k65 depthwise
               backward, K9 and K10 softmax·dropout·V forward and
               backward, K11 uPIT SI-SNR table) for a B=2 x 4 s train
               batch; times of the kernel, the plain version, a library
               call where one exists, and the least time the card could
               take.
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
               by group, launches per step, peak memory.
7. train_cpu - one train step at dropout 0, every LayerScale at 0.5, on a
               1 s crop, on the card and on the CPU from the same weights:
               the loss and every gradient agree, within a limit that a
               control run with TF32 allowed exceeds.

Prints one JSON line of kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import copy
import json
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
# wrapper -> the CUDA kernels it launches, as named in a profiler trace
KERNEL_SYMBOLS = {"fused_gcfn": "gcfn_kernel",
                  "materialize_pos_kt": "relpos_kernel",
                  "softmax_pv": "softmax_pv_kernel",
                  "depthwise_bwd": "depthwise_bwd",
                  "softmax_pv_train_fwd": "softmax_pv_train_fwd_kernel",
                  "softmax_pv_train_bwd": "softmax_pv_train_bwd_kernel",
                  "sisnr_pairwise_neg_fused": "pit_sisnr_kernel"}
EVAL_KERNELS = ("fused_gcfn", "materialize_pos_kt", "softmax_pv")
TRAIN_KERNELS = ("materialize_pos_kt", "depthwise_bwd",
                 "softmax_pv_train_fwd", "softmax_pv_train_bwd",
                 "sisnr_pairwise_neg_fused")
NO_BACKWARD = ("fused_gcfn", "softmax_pv")
# |card - cpu| over max|out| allowed in phase 5; see PERF.md for the
# readings it sits between (float32 on the card, and TF32 allowed)
CPU_REL_LIMIT = 3e-5
# phase 7: max |card - cpu| over every gradient element, over the largest
# cpu gradient; see PERF.md for the readings it sits between
TRAIN_CPU_REL_LIMIT = 1e-4
KERNEL_GROUPS = (  # profile groups of the card's kernels, first match wins
    ("K1 gcfn", ("gcfn_kernel",)),
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

    # K9 and K10: decoder attention of a B=2 x 4 s train batch (B*spks=4
    # rows, 8 heads, L=500 padded to 512), no key lengths, as in training
    b, length, seed = 4, 500, 1234
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
    return results


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

    # each kernel's launches on the main path of its slice: the eval
    # kernels' in serving, the train kernels' in training
    for row in kernels:
        name = row["name"]
        row["launches"] = (counts.get(name, 0) if name in EVAL_KERNELS
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
