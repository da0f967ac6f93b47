#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sepreformer_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build     - compile the CUDA kernel library with plain nvcc (sm_90a),
               one nvcc per source, all started together.
2. kernels   - each kernel against its plain PyTorch version on the card,
               at the shapes SepReformer_Base_WSJ0 gives it: the eval
               kernels (K1 GCFN, K2 rel-pos, K3 masked softmax·V) for a
               B=4 x 4 s batch, the train kernels (K5 k65 depthwise
               backward, K7 and K8 GCFN with hash dropout forward and
               backward, K9 and K10 softmax·dropout·V forward and
               backward, K11 uPIT SI-SNR table) for a B=2 x 4 s train
               batch, and K12 (flash rel-pos attention) for the decoder
               batch of a 70 s request ([2, 8750, 128], maxlen 2000),
               and the fused eval blocks' K15 (CLA) and K16 (EGA tail +
               GCFN) and the k65 forward K4 at [4, 8000, 128], and the
               two-tensor forms K3b (beside K3's shape) and K9b/K10b
               (beside K9's and K10's); times of the kernel, the plain
               version, a library call where one exists, and the least
               time the card could take (for K1, K3, K3b, K7, K8, K9,
               K9b, K12, K13, K14, K15 and K16, which take their products
               on the tensor cores as 3xTF32, with those products and
               their exponentials at the tensor cores' and the SFUs'
               rates, and the CUDA-core bound of earlier readings on a
               line before; K1's products counted on the rows its lengths
               need), K5's, K6's, K8's, K14's and K15's times by launch,
               K2's, K3's, K3b's, K4's, K5's, K6's, K9's, K9b's, K10's,
               K11's, K13's, K15's and K16's blocks per SM (K11's cluster)
               and five timings with their median (K2's, K3's, K3b's,
               K4's, K5's, K6's, K9's, K9b's, K11's and K13's registers
               and spills too, K2's grid and tiles, and the warps per row
               tile K13 takes), K2 also at [1024, 16, 1024] (the 8 s
               chunks), bit-equal to plain at both, an empty launch of K11's
               grid, cluster and shared memory timed beside it (K11's
               floor), a SHA-1 of K12's output bytes on fixed-seed inputs
               (to compare trees bit for bit), K1's, K3's, K5's, K6's,
               K7's, K8's, K9's, K10's, K11's, K12's, K13's (with its row
               statistics), K14's, K15's and K16's bits on a repeat call,
               K13 also at the routes' other shapes, each with its split
               ([2, 8, 500] at p 0.05, the "pallas" step's encoder; [8,
               8, 500] at p 0 with key lengths, the "single" serve's
               decoder): against its plain version, bits on a repeat
               call, K14 on its row statistics, five timings,
               K7's and its
               plain version's distance from a float64 run, K2's, K3's,
               K4's and K9's five timings also with the calls taken in
               turn over copies of their inputs whose total exceeds twice
               the L2, so each call reads them from memory (K2's and
               K4's outputs held, so each call also writes to memory the
               calls before it did not); and the port's
               scores producer followed by K3 against a two-tensor
               producer (no add pass) followed by K3b, at K3's shape.
               Then the instances at Large's widths, at the shapes Large's
               serving path gives them, each against its plain version
               and bit-equal on a repeat call, with its times and bound:
               K1 at [4, 8000, 256], K2 at [512, 32, 512] from a [4000,
               32] table (its grid and blocks per SM), K3 and K3b at [8,
               8, 512, 512] with head width 32 (ragged), K12 at [2, 8750,
               256] with head width 32, K15 and K16 at [4, 8000, 256]
               (K16's x_down [4, 500, 256]; their blocks per SM,
               registers and spills, K15 by launch); and at the shapes
               Large's train
               step gives them (dropout 0.1): K5 at [2, 8000, 256], K7
               and K8 at [4, 8000, 256] (their blocks per SM, registers
               and spills, K8 by launch, K7 against float64), K9 and K10
               at [4, 8, 512, 512] with head width 32 (length 500), K9b
               and K10b beside them; K9's and K10's blocks per SM at both
               head widths; K13 and K14 at [4, 8, 500, 32] (K14 by
               launch, K13's split and occupancy at head width 32), K13
               at each split at [2, 8, 500, 32] and [4, 8, 500, 32] (the
               split rule's choice), and at the "pallas" step's encoder
               [2, 8, 500, 32] and the "single" serve's [8, 8, 500, 32].
3. serve     - Base at full width, seeded weights: three requests through
               ``Separator.__call__`` and one batched B=4 x 4 s forward
               with ragged lengths; every eval kernel's count must rise.
4. profile   - the same model: repeated requests and batched forwards on
               the host clock (the batch with the audio-only serving
               forward and with the aux heads, in turns), then one batched
               forward of each traced with ``torch.profiler``: the card's
               idle share, kernel time by group, and each kernel's
               launches per forward.
5. cpu       - the same weights on the CPU (plain versions) against the
               card on a 1 s utterance, with the branches' LayerScale at
               0.5 so they carry signal; a control run on the card with
               TF32 allowed must exceed the limit, so the check can see a
               product that lost float32 accuracy.
5b. eval_grad - gradients through the eval forward, as ``jax.grad`` of
               the JAX package's takes them through its eval kernels'
               custom VJPs: Base at full width, seeded weights, every
               LayerScale at 0.5, a 1 s request with lengths on the
               default route (K1, K2, K3 launch); the gradient of a fixed
               scalar of the output with respect to the mixture and
               every parameter, card against CPU within phase 7's limit,
               which a TF32 control exceeds; then K12's gradients (q, k,
               v, the table) at [1, 2000, 128] with lengths, card against
               CPU.
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
               control run with TF32 allowed exceeds; a witness run with
               K7's plain version in place of the kernel is printed
               beside.  Then one Base-width
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
               traced forward; the model's 300 s forward audio alone
               against the forward with the aux heads (the same audio
               bits; wall and peak memory of each); the same 300 s in 8 s
               chunks (``chunk_seconds``: K2 and K3, no K12); and the 70 s
               request as a wav through ``cli.main``'s ``infer_sample``.
               Wall times, audio-s/s and peak memory of each.
10. routes   - the JAX package's other routes, Base at full width, seeded
               weights: ``train_step``s on B=2 x 4 s with
               ``attention_train_impl="pallas"`` (K13 and K14 in all 22
               global attentions) and the depthwise module's ``BWD_MODE =
               "conv"`` (K6 in all 22 CLAs), where K2, K5, K9 and K10 must
               not launch, in turns with the default route's steps on the
               same batch, with one traced step; one such step card
               against CPU (phase 7's limit, with two controls: TF32
               allowed, K13/K14 without the rel-pos bias); a ragged
               B=4 x 4 s batch served on ``attention_impl="single"`` (K13
               in all 22 attentions, no K2 or K3) against the default
               route within phase 5's limit, and one such batch traced
               (both traces with K13's launches by B*H, row tiles and
               split); one epoch through ``cli.main`` with ``--set
               model.attention_train_impl=pallas`` on phase 8's synthetic
               corpus (finite losses).
11. fused    - the fused eval blocks, Base at full width, seeded weights,
               every LayerScale at 0.5 and seeded BatchNorm statistics:
               ``fused_local="on"`` and ``fused_pair="on"`` (K15 in the
               CLAs, K16 in the GlobalBlocks, where ``blocks.fused_route``
               allows) against the default route on requests of 2.0, 3.3
               and 4.0 s and a B=4 x 4 s batch without lengths (within
               phase 5's limit, with a TF32 control), each forward's
               launches against the rule's count, a ragged batch with
               lengths that launches neither; the batch's wall times in
               turns and one traced forward per route; 300 s in 8 s chunks
               and 70 s in full context on both routes; a train step at
               dropout 0 on the pair route against the default one
               (phase 7's limit, also with the default's ReLU masks in
               the aux heads; 22 K16 launches, none at dropout 0.05)
               and four steps of each in turns;
               ``infer_sample`` of a 70 s wav through ``cli.main`` with
               ``--set model.fused_local=on --set model.fused_pair=on``.
12. large    - ``SepReformer_Large_DM_WSJ0`` at full width (F 256, 8
               heads of 32, 4 stages), seeded weights, every LayerScale at
               0.5: a 1 s request card against CPU (phase 5's limit, with
               a TF32 control); a ragged B=4 x 4 s batch through
               ``Separator.separate`` (wall times, one traced forward with
               56 K1, 1 K2 and 22 K3 launches, peak memory); 70 s in full
               context (22 K12 launches at head width 32, no K2 or K3)
               against the dense route with the switch raised (phase 5's
               limit; controls: TF32 allowed, K12 without the bias); 300
               s in 8 s chunks; one ``SepReformer_Large_DM_WHAM`` request
               (a speaker-split block per stage) card against CPU;
               ``infer_sample`` of the 70 s wav through ``cli.main --model
               SepReformer_Large_DM_WSJ0``.  Then Large trains: six
               ``train_step``s on seeded B=2 x 4 s batches at dropout 0.1
               (finite losses, parameters and BatchNorm statistics moving,
               each step one K7 and one K8 per GCFN (56), one K9 and one
               K10 per global attention (22), one K5 per CLA (22), one K2
               and one K11, no eval kernel; host-clock step times, peak
               memory); one traced step (idle share, kernel time by group,
               K8's share); one step card against CPU at dropout 0 on a 1
               s crop (phase 7's limit, a TF32 control); one F=256 GCFN
               in train mode at dropout 0.1, card against CPU; one
               ``SepReformer_Large_DM_WHAM`` step (its speaker-split
               blocks' gradients finite); two epochs of ``cli.main --model
               SepReformer_Large_DM_WSJ0`` on phase 8's corpus (dynamic
               mixing), a resumed third and a test.  Then the "pallas"
               and "single" routes at head width 32: four Large B=2 x 4 s
               steps on ``attention_train_impl="pallas"`` (each one K13
               and one K14 per global attention (22), no K2, K9 or K10;
               host-clock step times, peak memory), one traced step, one
               step card against CPU at dropout 0 (phase 7's limit;
               controls: TF32 allowed, K13/K14 without the bias), one
               ``cli.main`` epoch with ``--set
               model.attention_train_impl=pallas`` on phase 8's corpus
               (finite losses), and a ragged B=4 x 4 s batch served on
               ``attention_impl="single"`` (22 K13 launches, no K2 or K3)
               against the default route within phase 5's limit, with
               one traced.  Then Large on the fused block routes (phase
               11 at Large's width, ``fused_phase``): requests of 2.0,
               3.3 and 4.0 s and a B=4 x 4 s batch without lengths on
               ``fused_local``/``fused_pair="on"`` against the default
               route (phase 5's limit, a TF32 control; 22 K15, 22 K16 and
               34 K1 a 4 s forward, against ``blocks.fused_route``), a
               ragged batch that launches neither, wall times in turns
               and one traced forward per route, 70 s in full context, a
               dropout-0 step on the pair route against the default
               (phase 7's limit with the default's ReLU masks in the aux
               heads, the unpinned reading printed beside; 22 K16), a
               step at the preset's 0.1
               with no K15 or K16, and ``infer_sample`` of a 70 s wav
               through ``cli.main --model SepReformer_Large_DM_WSJ0 --set
               model.fused_local=on --set model.fused_pair=on``.
13. bf16     - serving in bfloat16 (``model.compute_dtype="bfloat16"``),
               seeded weights, every LayerScale at 0.5: Base's ragged
               B=4 x 4 s batch through ``Separator.separate`` (56 K1 and
               22 K3 launches of their bfloat16 instances, none of the
               float32 ones; wall times in turns with float32), card
               against the port on the CPU in bfloat16 and against
               float32 on the card, one traced forward of each dtype;
               the batch with ``scores_dtype="bfloat16"`` (K3 on bfloat16
               scores) and with bfloat16 scores under float32 compute;
               70 s in full context (22 launches of K12's bfloat16
               instance) against float32; 300 s in 8 s chunks; 300 s in
               full context, traced, with its peak memory;
               ``infer_sample`` through ``cli.main`` with ``--set
               model.compute_dtype=bfloat16``; Large's batch against
               float32, traced, and its 70 s in full context; then
               ``train_step`` in bfloat16 and a bfloat16 tensor into
               K13, K15 and K16, each refused naming its ROADMAP item.
               Phase 2 also holds the bfloat16 instances against their
               plain versions at its shapes (K1 at F 128 and 256, K3 on
               float32 or bfloat16 scores with a bfloat16 V at head
               width 16, float32 scores at 32, bfloat16 scores with a
               float32 V; K12 at head widths 16 and 32), bit-equal on
               repeat, with their times, bounds (bytes at the bfloat16
               sizes, bfloat16 products at 989 TFLOP/s) and library
               calls (a bfloat16 softmax and matmul; bfloat16 SDPA).

Prints one JSON line of kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3      # H100 SXM TF32 tensor cores, three TF32
                               # products per float32-accurate product
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense (the
                               # data sheet's, for wgmma; not measured for
                               # the mma.sync the kernels use)
SFU_EXP_PER_S = 132 * 16 * 1.98e9  # H100 SXM: 16 SFU results per SM and
                                   # clock, 132 SMs, 1.98 GHz
SAMPLE_RATE = 8000
TRAIN_SECONDS = 4.0            # the dataset's 4 s crop (max_len 32000)
LONG_SECONDS = 70.0            # bottleneck length 8750: past K12's switch
LONGEST_SECONDS = 300.0        # bottleneck length 37500
CHUNK_SECONDS = 8.0            # phase 9's chunked serving
# wrapper -> the CUDA kernels it launches, as named in a profiler trace
KERNEL_SYMBOLS = {"fused_gcfn": "gcfn_kernel",
                  "materialize_pos_kt": "relpos_kernel",
                  "softmax_pv": "softmax_pv_kernel",
                  "softmax_pv_bias": "softmax_pv_kernel",
                  "depthwise_bwd": "depthwise_bwd",
                  "gcfn_train_fwd": "gcfn_train_fwd_kernel",
                  "gcfn_train_bwd": "gcfn_train_bwd",
                  "softmax_pv_train_fwd": "softmax_pv_train_fwd_kernel",
                  "softmax_pv_train_bwd": "softmax_pv_train_bwd_kernel",
                  "softmax_pv_train_fwd_bias": "softmax_pv_train_fwd_kernel",
                  "softmax_pv_train_bwd_bias": "softmax_pv_train_bwd_kernel",
                  "sisnr_pairwise_neg_fused": "pit_sisnr_kernel",
                  "flash_relpos_attention": "flash_relpos_kernel",
                  "depthwise_bwd_w": "depthwise_dw",
                  "attention_train_fwd": "attn_train_fwd",
                  "attention_train_bwd": "attn_train_bwd",
                  "depthwise_fwd": "depthwise_fwd_kernel",
                  "fused_cla": "cla_",       # cla_glu_ and cla_tail_kernel
                  "fused_ega_tail_gcfn": "ega_gcfn_kernel"}
# the bfloat16 instances' kernels, as named in a trace
BF16_SYMBOLS = {"fused_gcfn": "gcfn_bf16_kernel",
                "softmax_pv": "softmax_pv_bf16_kernel",
                "flash_relpos_attention": "flash_relpos_bf16_kernel"}
# max |kernel - plain| over max|out| allowed for the bfloat16 instances
# (tests/test_torch_cuda.py's limits), two bfloat16 ulps, and the mean
# (PERF.md section 2).  Where the kernel and its plain version round the
# probabilities against the same max (K1, which has none; K3 and K12 on
# scores whose row max lies in the first key tile of each warp that walks
# the row), the mean is held to BF16_MEAN, and the plain version with the
# rounding steps left out must exceed it: the limit sees them.  On other
# scores K3 and K12 round against each key tile's running max, the plain
# versions against the row's, which moves the mean as far as leaving the
# rounding out does (up to 5.6e-5 on an H100): BF16_TILE_MEAN, just above
# those readings, holds agreement only.
BF16_MAX = 2 * 2.0 ** -7
BF16_MEAN = 1e-5
BF16_TILE_MEAN = 6e-5
# max |a - b| over max|out| between two bfloat16 forwards that round at
# other places (the port on the card and on the CPU; scores stored in
# bfloat16 or float32), the CPU tests' port-against-JAX limit; bfloat16
# against float32, the JAX package's own bar (tests/test_bf16.py)
BF16_FORWARD_LIMIT = 2e-2
BF16_F32_LIMIT = 0.1
EVAL_KERNELS = ("fused_gcfn", "materialize_pos_kt", "softmax_pv")
LONG_KERNELS = ("flash_relpos_attention",)
ROUTE_KERNELS = ("depthwise_bwd_w", "attention_train_fwd",
                 "attention_train_bwd")
FUSED_KERNELS = ("fused_cla", "fused_ega_tail_gcfn")
# K4 and the two-tensor forms K3b, K9b, K10b: no route takes them
OFF_PATH_KERNELS = ("depthwise_fwd", "softmax_pv_bias",
                    "softmax_pv_train_fwd_bias", "softmax_pv_train_bwd_bias")
TRAIN_KERNELS = ("materialize_pos_kt", "depthwise_bwd", "gcfn_train_fwd",
                 "gcfn_train_bwd", "softmax_pv_train_fwd",
                 "softmax_pv_train_bwd", "sisnr_pairwise_neg_fused")
# eval kernels, which the train path must not take (their gradients
# recompute the plain versions; training has K7/K8, K9/K10, K13/K14)
EVAL_ONLY_KERNELS = ("fused_gcfn", "softmax_pv", "flash_relpos_attention")
# |card - cpu| over max|out| allowed in phase 5; see PERF.md for the
# readings it sits between (float32 on the card, and TF32 allowed)
CPU_REL_LIMIT = 3e-5
# phase 7: max |card - cpu| over every gradient element, over the largest
# cpu gradient; see PERF.md for the readings it sits between
TRAIN_CPU_REL_LIMIT = 1e-4
KERNEL_GROUPS = (  # profile groups of the card's kernels, first match wins
    ("K7 gcfn_train_fwd", ("gcfn_train_fwd",)),
    ("K8 gcfn_train_bwd", ("gcfn_train_bwd",)),
    # before K1: K16's kernel name holds "gcfn_kernel"
    ("K16 ega_gcfn", ("ega_gcfn_kernel",)),
    ("K15 cla", ("cla_glu_kernel", "cla_tail_kernel")),
    ("K4 depthwise_fwd", ("depthwise_fwd_kernel",)),
    ("K1 gcfn", ("gcfn_kernel", "gcfn_bf16_kernel")),
    ("K12 flash_relpos", ("flash_relpos",)),
    ("K13 attn_train_fwd", ("attn_train_fwd",)),
    ("K14 attn_train_bwd", ("attn_train_bwd",)),
    ("K2 relpos", ("relpos_kernel",)),
    ("K9 softmax_pv_train_fwd", ("softmax_pv_train_fwd",)),
    ("K10 softmax_pv_train_bwd", ("softmax_pv_train_bwd",)),
    ("K3 softmax_pv", ("softmax_pv_kernel", "softmax_pv_bf16_kernel")),
    ("K6 depthwise_dw", ("depthwise_dw",)),
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


def bound_ms(nbytes: float, flops: float, tc_flops: float = 0.0,
             exps: float = 0.0, bf16_flops: float = 0.0):
    """The least time the card could take: the longest of the bytes at the
    memory rate, the float32 operations at the CUDA cores' rate and, for a
    kernel that takes its products on the tensor cores at float32
    accuracy (3xTF32), those products at that rate, its bfloat16 products
    at the bf16 rate, and its exponentials at the SFUs' rate.  Returns
    (ms, "bytes" or "operations", the term)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "CUDA-core operations": flops / F32_FLOPS * 1e3,
             "3xTF32 products": tc_flops / TF32X3_FLOPS * 1e3,
             "bf16 products": bf16_flops / BF16_FLOPS * 1e3,
             "exponentials": exps / SFU_EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term == "bytes" else "operations", term)


def launch_split(torch, fn, symbol, labels, iters=20, attempts=3):
    """Device time of each launch of one call of ``fn`` (the kernels whose
    name contains ``symbol``, in launch order), mean over ``iters`` calls,
    printed with ``labels``."""
    from sepreformer_torch.profiling import kernel_events

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in kernel_events(prof) if symbol in e[0]),
                        key=lambda e: e[1])
        if len(events) == len(labels) * iters:
            break
    else:
        raise RuntimeError(f"launch_split: {len(events)} {symbol} kernels in "
                           f"{iters} calls, expected {len(labels)} each")
    ms = [sum(e[2] for e in events[i::len(labels)]) / iters / 1e3
          for i in range(len(labels))]
    print(f"[kernels] {symbol} by launch: " + ", ".join(
        f"{label} {t:.4f} ms" for label, t in zip(labels, ms)))
    return ms


def past_l2_timings(torch, device_ms, run, tensor, symbol, bound,
                    timings=5, out_bytes=0):
    """Timings of ``run(tensor)`` as ``record`` takes them, but with the
    calls taken in turn over copies of ``tensor`` whose total exceeds
    twice the card's L2: back-to-back calls on one tensor find part of it
    in L2, these read it from memory.  With ``out_bytes`` (the bytes of
    one call's output) the copies count those bytes too, and the outputs
    of the last calls are held, so that each call writes to memory that
    the calls before it did not.  Prints them beside the byte bound
    ``bound`` and returns their median."""
    from collections import deque

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    nbytes = tensor.numel() * tensor.element_size()
    copies = [tensor] + [tensor.clone()
                         for _ in range(2 * l2 // (nbytes + out_bytes) + 1)]
    held = deque(maxlen=len(copies) if out_bytes else 0)
    turn = [0]

    def call():
        turn[0] += 1
        held.append(run(copies[turn[0] % len(copies)]))

    times = [device_ms(call, kernel=symbol) for _ in range(timings)]
    median = statistics.median(times)
    total = len(copies) * (nbytes + out_bytes)
    print(f"[kernels] {symbol}: over {len(copies)} input tensors in turn"
          + (", each output held" if out_bytes else "") +
          f" ({total / 1e6:.0f} MB, L2 {l2 / 1e6:.0f} MB): "
          f"{timings} timings " + ", ".join(f"{ms:.4f}" for ms in times)
          + f" ms, median {median:.4f}, {median / bound:.2f}x the byte bound "
          f"{bound:.4f} ms")
    del copies, held
    torch.cuda.empty_cache()
    return median


def relpos_pairs(length, klens, maxlen):
    """(query, valid key) pairs of one head over the rows ``klens``, and
    (query, distinct clamped table row its valid keys reach) pairs."""
    pairs = rows = 0
    for keys in klens:
        pairs += length * keys
        for i in range(length):
            lo = max(min(i - keys + 1, maxlen - 1), -maxlen)
            rows += min(i, maxlen - 1) - lo + 1
    return pairs, rows


def flash_relpos_ops(length, klens, maxlen, heads, d):
    """K12's (and K13's) float32 operations on these inputs, per head:
    4*d per (query, valid key) pair for q·kᵀ and P·V, and 2*d per query
    row for each distinct clamped table row that its valid keys reach
    (q·tableᵀ is taken once per row and table row, as the plain version
    takes it)."""
    pairs, rows = relpos_pairs(length, klens, maxlen)
    return heads * (4 * d * pairs + 2 * d * rows)


def attention_train_bwd_ops(length, klens, maxlen, heads, d):
    """K14's: 10*d per pair (q·kᵀ, dO·vᵀ, dV, dQ, dK) and 6*d per (row,
    table row) (q·tableᵀ, its adjoints to dQ and to the table)."""
    pairs, rows = relpos_pairs(length, klens, maxlen)
    return heads * (10 * d * pairs + 6 * d * rows)


def kernel_phase(torch, K, device_ms):
    """Each kernel against its plain version at the main path's shapes.
    ``ms`` is the kernel's device time, ``plain_ms`` and ``library_ms``
    the device time of all the kernels those calls run (durations from a
    profiler trace, not CUDA events: the wrappers' host work outlasts the
    small kernels)."""
    from sepreformer_torch.ops.kernels.depthwise import (
        occupancy as depthwise_occupancy,
    )
    from sepreformer_torch.ops.kernels.pit import (
        empty_launch as pit_empty_launch,
    )
    from sepreformer_torch.ops.kernels.pit import occupancy as pit_occupancy
    from sepreformer_torch.ops.kernels.softmax_pv import (
        occupancy as softmax_pv_occupancy,
    )
    from sepreformer_torch.ops.kernels.softmax_pv_train import (
        bwd_blocks_per_sm,
        fwd_occupancy,
    )

    def print_occupancy(occupancy):
        for name, occ in occupancy.items():
            print(f"[kernels] {name}: {occ['warps']} warps, "
                  f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
                  f"registers, {occ['local_bytes']} local (spill) bytes")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    results = []

    def timed(label, kernel, name, timings, symbol=None):
        """The median of ``timings`` device timings of wrapper ``name``'s
        kernel (or of the kernels named ``symbol``) in ``kernel()``, each
        printed where there are several."""
        symbol = symbol or KERNEL_SYMBOLS[name]
        times = [device_ms(kernel, kernel=symbol) for _ in range(timings)]
        median = statistics.median(times)
        if timings > 1:
            print(f"[kernels] {label}: {timings} timings " + ", ".join(
                f"{ms:.4f}" for ms in times) + f" ms, median {median:.4f}")
        return median

    def record(wrapper, kernel, plain, library, err, nbytes, flops, source,
               replaces, shape, tolerance, tc_flops=0.0, exps=0.0,
               cuda_core_flops=None, timings=1, instance=None, symbol=None,
               bf16_flops=0.0):
        """A row of the kernels line; ``instance`` names a width (or
        dtype) instance of the wrapper's kernel (its row is "<wrapper>
        <instance>"), ``symbol`` its kernel's name in a trace where that
        is not ``KERNEL_SYMBOLS``'s."""
        bound, bound_by, term = bound_ms(nbytes, flops, tc_flops, exps,
                                         bf16_flops)
        symbol_of = wrapper.__name__
        name = symbol_of + (f" {instance}" if instance else "")
        if cuda_core_flops is not None:
            old, old_by, _ = bound_ms(nbytes, cuda_core_flops)
            print(f"[kernels] {name}: bound with every operation on the CUDA "
                  f"cores (the earlier CUDA-core design's count) {old:.4f} ms "
                  f"({old_by})")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err,
                   ms=timed(name, kernel, symbol_of, timings, symbol),
                   plain_ms=device_ms(plain), bound_ms=bound,
                   bound_by=bound_by,
                   library_ms=None if library is None else device_ms(library))
        results.append(row)
        print(f"[kernels] {name}: {shape}; max |kernel - plain| {err:.3e} "
              f"({tolerance}); ms {row['ms']:.4f}, plain {row['plain_ms']:.4f}"
              f", library {row['library_ms']}, bound {bound:.4f} "
              f"({term})")

    def bit_equal(name, run):
        """Fail unless two calls of ``run`` give the same bits."""
        first, again = run(), run()
        torch.cuda.synchronize()
        same = torch.equal(first, again)
        print(f"[kernels] {name}: bit-equal on a repeat call: {same}")
        assert same, f"{name} is not bit-equal on repeat"

    def gcfn_row(f, instance=None):
        """K1 at the widest GCFN of the path, [B=4, T=8000, F], ragged
        lengths: Base's F = 128, Large's F = 256."""
        b, t = 4, 8000
        h = 6 * f
        x = randn(b, t, f)
        params = [randn(f), randn(f), randn(f, h, scale=0.1),
                  randn(h, scale=0.1), randn(h, 3, scale=0.3),
                  randn(h, scale=0.1), randn(h // 2, f, scale=0.1),
                  randn(f, scale=0.1), randn(f, scale=0.5)]
        lens = torch.tensor([8000, 7008, 6000, 5008], device=dev)
        err = 0.0
        for ln in (lens, None):
            got = K.fused_gcfn(x, params, 1e-5, ln)
            ref = K.gcfn_plain(x, params, 1e-5, ln)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            err = max(err, (got - ref).abs().max().item())
        del got, ref
        bit_equal(f"fused_gcfn at F {f}",
                  lambda: K.fused_gcfn(x, params, 1e-5, lens))
        products = 2 * f * h + 2 * (h // 2) * f         # flops per row
        rest = 8 * f + 7 * h + 5 * (h // 2) + 3 * f     # LN, dw3, GLU
        # What these lengths need: u rows past a length are zero, so the
        # F->6F product runs on the valid rows only; from two rows past a
        # length the conv sees zeros alone and g is one row of constants,
        # so the GLU and the 3F->F product run on the valid rows, one more
        # and that row.
        valid = [min(n, t) for n in lens.tolist()]
        g_rows = sum(min(n + 1, t) + (n + 1 < t) for n in valid)
        tc_flops = sum(valid) * 2 * f * h + g_rows * 2 * (h // 2) * f
        record(K.fused_gcfn, lambda: K.fused_gcfn(x, params, 1e-5, lens),
               lambda: K.gcfn_plain(x, params, 1e-5, lens), None, err,
               4 * (2 * x.numel() + sum(p.numel() for p in params) + b),
               b * t * rest,
               source="sepreformer_torch/csrc/gcfn.cu",
               replaces="sepreformer_tpu/ops/pallas/gcfn.py:394",
               shape=f"x [{b}, {t}, {f}], hidden {h}, lens {lens.tolist()}",
               tolerance="rtol 1e-4, atol 1e-4 (float32)",
               # the two products on the tensor cores; a sigmoid per GLU
               # pair
               tc_flops=tc_flops, exps=g_rows * (h // 2),
               cuda_core_flops=b * t * (products + rest), instance=instance)
        del x, params
        torch.cuda.empty_cache()

    gcfn_row(128)

    def relpos_rows(d, lengths, instance=None):
        """K2: pos_kt at the padded bottleneck length 512 from a [4000, d]
        table (a 4 s forward; Base's d 16, Large's 32), at d 16 then at
        1024 (the 8 s chunks of long-form serving), each bit-equal to the
        plain version (an exact copy), with its grid and blocks per SM;
        Base's also past L2."""
        lp, maxlen = 512, 2000
        table = randn(2 * maxlen, d)
        for length in lengths:
            got = K.materialize_pos_kt(table, length, maxlen)
            ref = K.materialize_pos_kt_plain(table, length, maxlen)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            occ = K.relpos.occupancy(length, d)
            print(f"[kernels] materialize_pos_kt at [{length}, {d}, "
                  f"{length}]: bit-equal to plain: {same}; {occ['blocks']} "
                  f"blocks over {occ['tiles']} tiles, {occ['blocks_per_sm']} "
                  f"blocks per SM, {occ['registers']} registers, "
                  f"{occ['local_bytes']} local (spill) bytes")
            assert same, f"K2 is not bit-equal to plain at [{length}, {d}]"
            bit_equal("materialize_pos_kt",
                      lambda: K.materialize_pos_kt(table, length, maxlen))
            # the bytes it must move: the output, and the table rows of the
            # offsets i - j in [-(t - 1), t - 1] after the clip
            nbytes = 4 * (got.numel() + min(2 * length - 1, 2 * maxlen) * d)
            if length == lp:
                idx = torch.from_numpy(
                    K.relpos.relpos_index(lp, maxlen)).to(dev)
                flat = (idx[:, None, :] * d
                        + torch.arange(d, device=dev)[None, :, None])
                record(K.materialize_pos_kt,
                       lambda: K.materialize_pos_kt(table, lp, maxlen),
                       lambda: K.materialize_pos_kt_plain(table, lp, maxlen),
                       lambda: torch.take(table, flat),
                       (got - ref).abs().max().item(), nbytes, 0,
                       source="sepreformer_torch/csrc/relpos.cu",
                       replaces="sepreformer_tpu/ops/pallas/relpos.py:106",
                       shape=f"table [{2 * maxlen}, {d}] -> [{lp}, {d}, "
                             f"{lp}]",
                       tolerance="bit-equal (an exact copy)", timings=5,
                       instance=instance)
                bound = results[-1]["bound_ms"]
            else:
                bound = bound_ms(nbytes, 0)[0]
                ms = timed(f"materialize_pos_kt at [{length}, {d}, "
                           f"{length}]",
                           lambda: K.materialize_pos_kt(table, length,
                                                        maxlen),
                           "materialize_pos_kt", 5)
                print(f"[kernels] materialize_pos_kt at [{length}, {d}, "
                      f"{length}]: ms {ms:.4f}, bound {bound:.4f} (bytes)")
            if instance is None:
                past_l2_timings(
                    torch, device_ms,
                    lambda tab: K.materialize_pos_kt(tab, length, maxlen),
                    table, KERNEL_SYMBOLS["materialize_pos_kt"], bound,
                    out_bytes=4 * got.numel())
            del got, ref

    relpos_rows(16, (512, 1024))
    lp = 512

    def softmax_pv_row(d, instance=None):
        """K3 at the decoder attention, B*spks=8 rows, 8 heads, L=500
        padded to 512: Base's head width 16, Large's 32."""
        b, heads, length = 8, 8, 500
        f = heads * d
        scores = randn(b, heads, lp, lp, scale=3.0)
        v = randn(b, lp, f)
        klens = torch.tensor([500, 500, 438, 438, 376, 376, 313, 313],
                             device=dev)
        got = K.softmax_pv(scores, v, klens, length)
        ref = K.softmax_pv_plain(scores, v, klens, length)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        kmask = torch.arange(lp, device=dev)[None] < klens[:, None]
        masked = torch.where(kmask[:, None, None, :], scores,
                             torch.tensor(-1e30, device=dev))
        vh = v.reshape(b, lp, heads, d).permute(0, 2, 1, 3).contiguous()
        bit_equal(f"softmax_pv at head width {d}",
                  lambda: K.softmax_pv(scores, v, klens, length))
        keys = sum(klens.tolist())           # valid keys over the batch
        pairs = heads * lp * keys            # (query, valid key) pairs
        record(K.softmax_pv, lambda: K.softmax_pv(scores, v, klens, length),
               lambda: K.softmax_pv_plain(scores, v, klens, length),
               lambda: torch.matmul(torch.softmax(masked, dim=-1), vh),
               (got - ref).abs().max().item(),
               4 * (heads * lp * keys + keys * f + b * lp * f + b),
               # the online softmax's max, exponent argument and sum per
               # pair
               3 * pairs,
               source="sepreformer_torch/csrc/softmax_pv.cu",
               replaces="sepreformer_tpu/ops/pallas/softmax_pv.py:342",
               shape=(f"scores [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, "
                      f"{f}], lens {klens.tolist()}, length {length}"),
               tolerance="rtol 1e-4, atol 1e-5 (float32)",
               # P·V on the tensor cores; one exponential per pair
               tc_flops=2 * d * pairs, exps=pairs,
               cuda_core_flops=pairs * (2 * d + 4), timings=5,
               instance=instance)
        if instance is None:
            past_l2_timings(torch, device_ms,
                            lambda s: K.softmax_pv(s, v, klens, length),
                            scores, KERNEL_SYMBOLS["softmax_pv"],
                            results[-1]["bound_ms"])
        return scores, v

    scores, v = softmax_pv_row(16)
    print_occupancy(softmax_pv_occupancy())
    heads, d = 8, 16

    def depthwise_bwd_row(c, b, instance=None):
        """K5 at the widest k65 conv of a B=2 x 4 s train batch: Base's in
        a decoder stage (B*spks = 4 rows of 8000 frames, 128 channels),
        Large's at its first encoder stage ([2, 8000, 256]).  Returns its
        inputs for K6's row."""
        t, k = 8000, 65
        x, dy = randn(b, t, c), randn(b, t, c)
        w = randn(c, 1, k, scale=0.1)
        got, ref = K.depthwise_bwd(x, w, dy), K.depthwise_bwd_plain(x, w, dy)
        torch.cuda.synchronize()
        # dw and db sum B*T products each: float32 sums in another order
        for g, r, atol in zip(got, ref, (1e-5, 1e-3, 1e-3)):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=atol)
        bit_equal(f"depthwise_bwd at C {c}", lambda: torch.cat([
            a.flatten() for a in K.depthwise_bwd(x, w, dy)]))
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
               tolerance="rtol 1e-4; atol 1e-5 dx, 1e-3 dw and db",
               timings=5, instance=instance)
        launch_split(torch, lambda: K.depthwise_bwd(x, w, dy),
                     "depthwise_bwd", ("tiles", "reduce"))
        return x, dy, w, xp, dy_ncw

    b, t, c, k = 4, 8000, 128, 65
    x, dy, w, xp, dy_ncw = depthwise_bwd_row(c, b)
    bit_equal("depthwise_bwd_w", lambda: torch.cat([
        a.flatten() for a in K.depthwise_bwd_w(x, dy, k)]))
    print_occupancy({f"depthwise {name} at k {k}": occ for name, occ in
                     depthwise_occupancy(k).items() if name != "K4"})

    # K6: the same conv's dw and db alone (BWD_MODE "conv")
    got, ref = K.depthwise_bwd_w(x, dy, k), K.depthwise_bwd_w_plain(x, dy, k)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)
    record(K.depthwise_bwd_w, lambda: K.depthwise_bwd_w(x, dy, k),
           lambda: K.depthwise_bwd_w_plain(x, dy, k),
           lambda: torch.ops.aten.convolution_backward(
               dy_ncw, xp, w, [c], [1], [0], [1], False, [0], c,
               [False, True, True]),
           max((g - r).abs().max().item() for g, r in zip(got, ref)),
           4 * (2 * x.numel() + w.numel() + c), x.numel() * (2 * k + 1),
           source="sepreformer_torch/csrc/depthwise.cu",
           replaces="sepreformer_tpu/ops/pallas/depthwise.py:193",
           shape=f"x, dy [{b}, {t}, {c}], k {k}",
           tolerance="rtol 1e-4, atol 1e-3 (sums of B*T products)",
           timings=5)
    launch_split(torch, lambda: K.depthwise_bwd_w(x, dy, k), "depthwise_dw",
                 ("tiles", "reduce"))

    def gcfn_train_rows(f, p, instance=None):
        """K7 and K8 at the widest GCFN of a B=2 x 4 s train batch, in a
        decoder stage (B*spks = 4 rows of 8000 frames): Base's F = 128 at
        its dropout 0.05, Large's F = 256 at its 0.1."""
        b, t, seed = 4, 8000, 4321
        h = 6 * f
        x, dout = randn(b, t, f), randn(b, t, f)
        params = [randn(f), randn(f), randn(f, h, scale=0.1),
                  randn(h, scale=0.1), randn(h, 3, scale=0.3),
                  randn(h, scale=0.1), randn(h // 2, f, scale=0.1),
                  randn(f, scale=0.1), randn(f, scale=0.5)]
        got = K.gcfn_train_fwd(x, params, 1e-5, seed, p)
        ref = K.gcfn_train_plain(x, params, 1e-5, seed, p)
        torch.cuda.synchronize()
        # a wrong dropout mask errs by O(1) at p = 0.05
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        bit_equal(f"gcfn_train_fwd at F {f}",
                  lambda: K.gcfn_train_fwd(x, params, 1e-5, seed, p))
        # how far the kernel and the plain version each lie from float64
        exact = K.gcfn_train_plain(x.double(), [q.double() for q in params],
                                   1e-5, seed, p)
        print(f"[kernels] gcfn_train_fwd at F {f}: max |result - float64 "
              f"plain| {(got - exact).abs().max().item():.3e}, the float32 "
              f"plain version's {(ref - exact).abs().max().item():.3e}")
        del exact
        print_occupancy(K.gcfn_train.occupancy(f))
        products = 2 * f * h + 2 * (h // 2) * f         # flops per row
        rest = 8 * f + 7 * h + 6 * (h // 2) + 4 * f     # LN, dw3, GLU, drop
        record(K.gcfn_train_fwd,
               lambda: K.gcfn_train_fwd(x, params, 1e-5, seed, p),
               lambda: K.gcfn_train_plain(x, params, 1e-5, seed, p), None,
               (got - ref).abs().max().item(),
               4 * (2 * x.numel() + sum(q.numel() for q in params)),
               b * t * rest,
               source="sepreformer_torch/csrc/gcfn_train.cu",
               replaces="sepreformer_tpu/ops/pallas/gcfn_train.py:549",
               shape=f"x [{b}, {t}, {f}], hidden {h}, p {p}",
               tolerance="rtol 1e-4, atol 1e-4 (float32)",
               tc_flops=b * t * products, exps=b * t * (h // 2),
               cuda_core_flops=b * t * (products + rest), instance=instance)
        del got, ref
        dx, dparams = K.gcfn_train_bwd(x, params, 1e-5, seed, p, dout)
        ref_dx, ref_dparams = K.gcfn_train_bwd_plain(x, params, 1e-5, seed,
                                                     p, dout)
        torch.cuda.synchronize()
        err = 0.0
        # dx, then the nine parameter gradients: each sums B*T rows in
        # another order than the plain version's cuBLAS products
        for g, r in zip((dx, *dparams), (ref_dx, *ref_dparams)):
            torch.testing.assert_close(g, r, rtol=1e-4,
                                       atol=1e-5 * r.abs().max().item()
                                       + 1e-6)
            err = max(err, (g - r).abs().max().item())
        again = K.gcfn_train_bwd(x, params, 1e-5, seed, p, dout)
        torch.cuda.synchronize()
        same = all(torch.equal(g, a) for g, a in zip((dx, *dparams),
                                                     (again[0], *again[1])))
        print(f"[kernels] gcfn_train_bwd at F {f}: bit-equal on a repeat "
              f"call: {same}")
        assert same, f"K8 is not bit-equal on repeat at F {f}"
        del dx, dparams, ref_dx, ref_dparams, again
        record(K.gcfn_train_bwd,
               lambda: K.gcfn_train_bwd(x, params, 1e-5, seed, p, dout),
               lambda: K.gcfn_train_bwd_plain(x, params, 1e-5, seed, p,
                                              dout),
               None, err,
               4 * (3 * x.numel() + 2 * sum(q.numel() for q in params)),
               # the LN, conv, GLU, dropout and LN-backward work per row
               b * t * (40 * f + 20 * h),
               source="sepreformer_torch/csrc/gcfn_train.cu",
               replaces="sepreformer_tpu/ops/pallas/gcfn_train.py:599",
               shape=f"x, dout [{b}, {t}, {f}], hidden {h}, p {p}",
               tolerance="rtol 1e-4; atol 1e-5 x max|plain| + 1e-6, ten "
                         "outputs",
               # the forward's products again, then dg, dWout, dWin and
               # dxn, on the tensor cores; one exponential per gate
               tc_flops=b * t * 3 * products, exps=b * t * (h // 2),
               cuda_core_flops=b * t * (3 * products + 40 * f + 20 * h),
               instance=instance)
        launch_split(torch, lambda: K.gcfn_train_bwd(x, params, 1e-5, seed,
                                                     p, dout),
                     "gcfn_train_bwd", ("rows", "atb dWin", "atb dWout",
                                        "reduce dWin, dWout",
                                        "reduce small"))
        del x, dout, params
        torch.cuda.empty_cache()

    gcfn_train_rows(128, 0.05)

    def softmax_pv_train_rows(d, p, instance=None):
        """K9 and K10 at the decoder attention of a B=2 x 4 s train batch
        (B*spks=4 rows, 8 heads, L=500 padded to 512), no key lengths, as
        in training: Base's head width 16 at dropout 0.05, Large's 32 at
        0.1; Base's K9 also past L2."""
        b, length, seed = 4, 500, 1234
        f = heads * d
        scores = randn(b, heads, lp, lp, scale=3.0)
        v, dout = randn(b, lp, f), randn(b, lp, f)
        key_len = torch.full((b,), length, dtype=torch.int32, device=dev)
        err = 0.0
        for rate in (p, 0.0):
            out, row_max, row_sum = K.softmax_pv_train_fwd(
                scores, v, seed, key_len, length, rate)
            ref = K.softmax_pv_dropout_plain(scores, v, seed, None, length,
                                             rate)
            torch.cuda.synchronize()
            # a wrong dropout mask errs by O(1) at p = 0.05
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
            err = max(err, (out - ref).abs().max().item())
        out, row_max, row_sum = K.softmax_pv_train_fwd(scores, v, seed,
                                                       key_len, length, p)
        bit_equal(f"softmax_pv_train_fwd at head width {d}",
                  lambda: torch.cat([
                      a.flatten() for a in K.softmax_pv_train_fwd(
                          scores, v, seed, key_len, length, p)]))
        keys = b * length
        pairs = heads * lp * keys
        record(K.softmax_pv_train_fwd,
               lambda: K.softmax_pv_train_fwd(scores, v, seed, key_len,
                                              length, p),
               lambda: K.softmax_pv_dropout_plain(scores, v, seed, None,
                                                  length, p),
               None, err,
               # the function's own bytes: scores and V of the valid keys
               # in, out written; the row stats are this design's residuals
               4 * (heads * lp * keys + keys * f + b * lp * f),
               # the online softmax's three operations and the hash's
               # fifteen integer ones per pair
               18 * pairs,
               source="sepreformer_torch/csrc/softmax_pv_train.cu",
               replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:221",
               shape=(f"scores [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, "
                      f"{f}], length {length}, p {p} and 0"),
               tolerance="rtol 1e-4, atol 1e-5 (float32)",
               tc_flops=2 * d * pairs, exps=pairs,
               cuda_core_flops=pairs * (2 * d + 4), timings=5,
               instance=instance)
        if instance is None:
            past_l2_timings(torch, device_ms,
                            lambda s: K.softmax_pv_train_fwd(
                                s, v, seed, key_len, length, p),
                            scores, KERNEL_SYMBOLS["softmax_pv_train_fwd"],
                            results[-1]["bound_ms"])
        ds, dv = K.softmax_pv_train_bwd(scores, v, out, dout, row_max,
                                        row_sum, seed, key_len, length, p)
        ds_ref, dv_ref = K.softmax_pv_dropout_bwd_plain(
            scores, v, seed, None, length, p, dout)
        torch.cuda.synchronize()
        torch.testing.assert_close(ds, ds_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
        bit_equal(f"softmax_pv_train_bwd at head width {d}",
                  lambda: torch.cat([
                      a.flatten() for a in K.softmax_pv_train_bwd(
                          scores, v, out, dout, row_max, row_sum, seed,
                          key_len, length, p)]))
        record(K.softmax_pv_train_bwd,
               lambda: K.softmax_pv_train_bwd(scores, v, out, dout, row_max,
                                              row_sum, seed, key_len, length,
                                              p),
               lambda: K.softmax_pv_dropout_bwd_plain(scores, v, seed, None,
                                                      length, p, dout),
               None, max((ds - ds_ref).abs().max().item(),
                         (dv - dv_ref).abs().max().item()),
               # JAX's K10 reads scores, v and dout: scores and V of the
               # valid keys and dout in, the full dScores and dV written
               4 * (heads * lp * keys + scores.numel() + keys * f
                    + 2 * b * lp * f),
               heads * lp * keys * (4 * d + 8),
               source="sepreformer_torch/csrc/softmax_pv_train.cu",
               replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:249",
               shape=(f"scores [{b}, {heads}, {lp}, {lp}], v, out, dout "
                      f"[{b}, {lp}, {f}], length {length}, p {p}"),
               tolerance="rtol 1e-4; atol 1e-5 dScores, 1e-4 dV", timings=5,
               instance=instance)
        del scores, v, dout, out, ds, dv, ds_ref, dv_ref
        torch.cuda.empty_cache()

    softmax_pv_train_rows(16, 0.05)
    print_occupancy(fwd_occupancy())
    print(f"[kernels] softmax_pv_train_bwd: blocks per SM "
          f"{bwd_blocks_per_sm()}")

    # K11: the time-loss table of a B=2 x 4 s batch, two speakers
    spk, b, t = 2, 2, 32000
    src = randn(spk, b, t, scale=0.1)
    est = src.flip(0) + randn(spk, b, t, scale=0.02)
    got = K.sisnr_pairwise_neg_fused(est, src)
    ref = K.sisnr_pairwise_neg(est, src)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    bit_equal("sisnr_pairwise_neg_fused",
              lambda: K.sisnr_pairwise_neg_fused(est, src))
    occ = pit_occupancy(spk, t)
    print(f"[kernels] sisnr_pairwise_neg_fused: a cluster of "
          f"{occ['cluster_blocks']} blocks per batch entry, "
          f"{occ['held_samples']} samples per row held in "
          f"{occ['smem_bytes']} bytes of shared memory per block, "
          f"{occ['registers']} registers, {occ['local_bytes']} local (spill) "
          f"bytes, {occ['clusters_at_once']} clusters at once")
    empty = [device_ms(lambda: pit_empty_launch(est), kernel="pit_empty")
             for _ in range(5)]
    print(f"[kernels] sisnr_pairwise_neg_fused: an empty launch of the same "
          f"grid, cluster and shared memory: 5 timings " + ", ".join(
              f"{ms:.4f}" for ms in empty)
          + f" ms, median {statistics.median(empty):.4f}")
    record(K.sisnr_pairwise_neg_fused,
           lambda: K.sisnr_pairwise_neg_fused(est, src),
           lambda: K.sisnr_pairwise_neg(est, src), None,
           (got - ref).abs().max().item(),
           4 * (2 * est.numel() + b * spk * spk),
           b * spk * spk * t * 11,
           source="sepreformer_torch/csrc/pit.cu",
           replaces="sepreformer_tpu/ops/pallas/pit.py:70",
           shape=f"est, src [{spk}, {b}, {t}]",
           tolerance="rtol 1e-4, atol 1e-4 (dB, float32)", timings=5)
    flash_kernel_row(torch, K, device_ms, randn, record)
    attention_train_rows(torch, K, device_ms, randn, record)
    fused_kernel_rows(torch, K, device_ms, randn, record)
    bias_kernel_rows(torch, K, device_ms, randn, record)

    # The instances at Large's widths (SepReformer_Large_DM_WSJ0: F 256,
    # 8 heads of 32), at the shapes Large's serving path gives them
    del scores, v
    torch.cuda.empty_cache()
    gcfn_row(256, instance="F=256")
    relpos_rows(32, (512,), instance="d=32")
    softmax_pv_row(32, instance="d=32")
    bias_kernel_rows(torch, K, device_ms, randn, record, d=32,
                     instance="d=32")
    flash_kernel_row(torch, K, device_ms, randn, record, d=32)
    fused_kernel_rows(torch, K, device_ms, randn, record, f=256,
                      instance="F=256")
    # and at the shapes Large's train step gives them (B=2 x 4 s, dropout
    # 0.1): K5 at its first encoder stage, K7/K8 and K9/K10 as Base's rows
    # take them, K9b/K10b beside K9's and K10's
    del x, dy, w, xp, dy_ncw
    torch.cuda.empty_cache()
    depthwise_bwd_row(256, 2, instance="C=256")
    gcfn_train_rows(256, 0.1, instance="F=256")
    softmax_pv_train_rows(32, 0.1, instance="d=32")
    bias_train_rows(torch, K, randn, record, d=32, p=0.1, instance="d=32")
    # and the "pallas" train step's K13/K14 at Large's head width
    attention_train_rows(torch, K, device_ms, randn, record, d=32, p=0.1,
                         instance="d=32")
    # the bfloat16 instances of K1, K3 and K12 at the shapes above
    torch.cuda.empty_cache()
    bf16_kernel_rows(torch, K, device_ms, randn, record)
    return results


def bias_kernel_rows(torch, K, device_ms, randn, record, d=16,
                     instance=None):
    """The two-tensor forms, which no route takes: K3b at K3's shape
    (decoder attention of a B=4 x 4 s forward, [8, 8, 512, 512], ragged)
    at head width ``d`` (bit-equal on a repeat call), and at Base's 16
    K9b/K10b at K9's and K10's ([4, 8, 512, 512], length 500, p 0.05),
    each against its plain version; the library yardstick of K3b is
    softmax(scores + bias) · V.  Then, at Base's 16, the port's scores
    producer
    (``blocks.fused_pv_scores``: the two products, an add pass and a
    scale pass) followed by K3, against a two-tensor producer (q scaled
    first, so both products come scaled; the bias product's layout copy
    and no add) followed by K3b, at the same shape: a measurement, on no
    route."""
    from sepreformer_torch.models.blocks import fused_pv_scores, pad_time

    dev = torch.device("cuda")
    b, heads, lp, length = 8, 8, 512, 500
    f = heads * d
    scores, bias = randn(b, heads, lp, lp, scale=3.0), randn(b, heads, lp, lp)
    v = randn(b, lp, f)
    klens = torch.tensor([500, 500, 438, 438, 376, 376, 313, 313], device=dev)
    got = K.softmax_pv(scores, v, klens, length, bias=bias)
    ref = K.softmax_pv_plain(scores, v, klens, length, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    again = K.softmax_pv(scores, v, klens, length, bias=bias)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    print(f"[kernels] softmax_pv_bias at head width {d}: bit-equal on a "
          f"repeat call: {same}")
    assert same, f"K3b is not bit-equal on repeat at d {d}"
    del again
    kmask = torch.arange(lp, device=dev)[None] < klens[:, None]
    vh = v.reshape(b, lp, heads, d).permute(0, 2, 1, 3).contiguous()

    def library():
        masked = torch.where(kmask[:, None, None, :], scores + bias,
                             torch.tensor(-1e30, device=dev))
        return torch.matmul(torch.softmax(masked, dim=-1), vh)

    keys = sum(klens.tolist())               # valid keys over the batch
    record(K.softmax_pv_bias,
           lambda: K.softmax_pv(scores, v, klens, length, bias=bias),
           lambda: K.softmax_pv_plain(scores, v, klens, length, bias),
           library, (got - ref).abs().max().item(),
           # both score tensors and V of the valid keys in, out written
           4 * (2 * heads * lp * keys + keys * f + b * lp * f + b),
           # the add and the online softmax's three operations per pair
           4 * heads * lp * keys,
           source="sepreformer_torch/csrc/softmax_pv.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv.py:288",
           shape=(f"scores, bias [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, "
                  f"{f}], lens {klens.tolist()}, length {length}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)",
           tc_flops=2 * d * heads * lp * keys, exps=heads * lp * keys,
           cuda_core_flops=heads * lp * keys * (2 * d + 5), timings=5,
           instance=instance)
    if instance is not None:
        return

    # the producers at the same shape: q, k [8, 500, 8, 16], Base's table
    maxlen = 2000
    q, k = randn(b, length, heads, d), randn(b, length, heads, d)
    pos_kt = K.materialize_pos_kt(randn(2 * maxlen, d), lp, maxlen)

    def two_tensor_scores():
        qp = pad_time(q, lp).permute(0, 2, 1, 3) * (1.0 / math.sqrt(d))
        kp = pad_time(k, lp).permute(0, 2, 3, 1)
        qi = qp.permute(2, 0, 1, 3).reshape(lp, b * heads, d)
        rel = torch.matmul(qi, pos_kt).reshape(lp, b, heads, lp)
        return torch.matmul(qp, kp), rel.permute(1, 2, 0, 3).contiguous()

    def one_tensor():
        return K.softmax_pv(fused_pv_scores(q, k, pos_kt), v, klens, length)

    def two_tensor():
        qk, rel = two_tensor_scores()
        return K.softmax_pv(qk, v, klens, length, bias=rel)

    diff = (two_tensor() - one_tensor()).abs().max().item()
    one_ms, two_ms = device_ms(one_tensor), device_ms(two_tensor)
    print(f"[kernels] scores producer + K3 {one_ms:.4f} ms against the "
          f"two-tensor producer + K3b {two_ms:.4f} ms (scores [{b}, "
          f"{heads}, {lp}, {lp}], lens {klens.tolist()}); max |two - one| "
          f"{diff:.3e}")
    assert diff <= 1e-4, "the two producers disagree"

    bias_train_rows(torch, K, randn, record)


def bias_train_rows(torch, K, randn, record, d=16, p=0.05, instance=None):
    """K9b and K10b at K9's and K10's shape ([4, 8, 512, 512], length 500)
    and head width ``d``, each against its plain version: Base's 16 at
    dropout 0.05, Large's 32 at 0.1."""
    dev = torch.device("cuda")
    b, heads, lp, length, seed = 4, 8, 512, 500, 1234
    f = heads * d
    scores, bias = randn(b, heads, lp, lp, scale=3.0), randn(b, heads, lp, lp)
    v, dout = randn(b, lp, f), randn(b, lp, f)
    key_len = torch.full((b,), length, dtype=torch.int32, device=dev)
    out, row_max, row_sum = K.softmax_pv_train_fwd_bias(
        scores, bias, v, seed, key_len, length, p)
    ref = K.softmax_pv_dropout_plain(scores, v, seed, None, length, p, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    keys = b * length
    record(K.softmax_pv_train_fwd_bias,
           lambda: K.softmax_pv_train_fwd_bias(scores, bias, v, seed,
                                               key_len, length, p),
           lambda: K.softmax_pv_dropout_plain(scores, v, seed, None, length,
                                              p, bias),
           None, (out - ref).abs().max().item(),
           4 * (2 * heads * lp * keys + keys * f + b * lp * f),
           # the add, the softmax's three and the hash's fifteen per pair
           19 * heads * lp * keys,
           source="sepreformer_torch/csrc/softmax_pv_train.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:221",
           shape=(f"scores, bias [{b}, {heads}, {lp}, {lp}], v [{b}, {lp}, "
                  f"{f}], length {length}, p {p}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)",
           tc_flops=2 * d * heads * lp * keys, exps=heads * lp * keys,
           cuda_core_flops=heads * lp * keys * (2 * d + 5), timings=5,
           instance=instance)
    ds, dv = K.softmax_pv_train_bwd_bias(scores, bias, v, out, dout, row_max,
                                         row_sum, seed, key_len, length, p)
    ds_ref, dv_ref = K.softmax_pv_dropout_bwd_plain(scores, v, seed, None,
                                                    length, p, dout, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(ds, ds_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    if instance is not None:
        for name, run in (
                ("softmax_pv_train_fwd_bias", lambda: torch.cat([
                    a.flatten() for a in K.softmax_pv_train_fwd_bias(
                        scores, bias, v, seed, key_len, length, p)])),
                ("softmax_pv_train_bwd_bias", lambda: torch.cat([
                    a.flatten() for a in K.softmax_pv_train_bwd_bias(
                        scores, bias, v, out, dout, row_max, row_sum, seed,
                        key_len, length, p)]))):
            first, again = run(), run()
            torch.cuda.synchronize()
            same = torch.equal(first, again)
            print(f"[kernels] {name} at head width {d}: bit-equal on a "
                  f"repeat call: {same}")
            assert same, f"{name} is not bit-equal on repeat at d {d}"
    record(K.softmax_pv_train_bwd_bias,
           lambda: K.softmax_pv_train_bwd_bias(scores, bias, v, out, dout,
                                               row_max, row_sum, seed,
                                               key_len, length, p),
           lambda: K.softmax_pv_dropout_bwd_plain(scores, v, seed, None,
                                                  length, p, dout, bias),
           None, max((ds - ds_ref).abs().max().item(),
                     (dv - dv_ref).abs().max().item()),
           # as K10's, with the bias of the valid keys read too
           4 * (2 * heads * lp * keys + scores.numel() + keys * f
                + 2 * b * lp * f),
           heads * lp * keys * (4 * d + 9),
           source="sepreformer_torch/csrc/softmax_pv_train.cu",
           replaces="sepreformer_tpu/ops/pallas/softmax_pv_train.py:249",
           shape=(f"scores, bias [{b}, {heads}, {lp}, {lp}], v, out, dout "
                  f"[{b}, {lp}, {f}], length {length}, p {p}"),
           tolerance="rtol 1e-4; atol 1e-5 dScores, 1e-4 dV",
           instance=instance)
    del scores, bias, v, dout, out, ds, dv, ds_ref, dv_ref
    torch.cuda.empty_cache()


def ptxas_report():
    """The ptxas lines (registers, spills) of each kernel in the build
    log, by its name and template arguments ("cla_tail_kernel<256>")."""
    from sepreformer_torch.ops.kernels import _build

    log = _build.BUILD_DIR / "build.log"
    report, name = defaultdict(list), "?"
    if not log.exists():
        return report
    for line in log.read_text().splitlines():
        if "Function properties for" in line:  # a kernel's report follows
            # the mangled name's kernel and its template arguments
            found = re.search(r"\d+([A-Za-z_]+kernel)((?:I?L[ib]\d+E)*)",
                              line)
            args = re.findall(r"L[ib](\d+)E", found.group(2) if found
                              else "")
            name = (found.group(1) + (f"<{', '.join(args)}>" if args else "")
                    if found else line.split()[-1])
        elif "registers" in line or "spill" in line:
            report[name].append(line.strip())
    return report


def fused_kernel_rows(torch, K, device_ms, randn, record, f=128,
                      instance=None):
    """K15 and K16 at the widest blocks of a B=4 x 4 s forward without
    lengths ([4, 8000, F]; K16's attention output at the bottleneck
    length 500), against their plain versions, with their blocks per SM
    and their registers and spills from the build log; at Base's width
    (no ``instance``) K4 too.  No single PyTorch call computes K15's or
    K16's function; K4's library yardstick is the depthwise ``F.conv1d``
    that ``DepthwiseConv1d`` runs (its plain version too)."""
    from sepreformer_torch.ops.kernels.cla import (
        blocks_per_sm as cla_blocks_per_sm,
    )
    from sepreformer_torch.ops.kernels.depthwise import depthwise_forward
    from sepreformer_torch.ops.kernels.depthwise import (
        occupancy as depthwise_occupancy,
    )
    from sepreformer_torch.ops.kernels.ega_gcfn import blocks_per_sm

    b, t, k, length = 4, 8000, 65, 500
    h = 2 * f
    tag = "" if instance is None else f" {instance}"
    ptxas = ptxas_report()
    x = randn(b, t, f)
    # wdw as the CLA module passes it: the Conv1d weight [F, 1, k] as [k, F]
    cla = [randn(f), randn(f), randn(f, h, scale=0.1), randn(h, scale=0.1),
           randn(f, k, scale=0.1).t(), randn(f, scale=0.1),
           randn(f, h, scale=0.1), randn(h, scale=0.1),
           1.0 + randn(h, scale=0.1), randn(h, scale=0.1),
           randn(h, f, scale=0.1), randn(f, scale=0.1), randn(f, scale=0.5)]
    got = K.fused_cla(x, cla, 1e-5)
    ref = K.cla_plain(x, cla, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    same = torch.equal(got, K.fused_cla(x, cla, 1e-5))
    print(f"[kernels] fused_cla{tag}: bit-equal on a repeat call: {same}")
    assert same, f"K15{tag} is not bit-equal on repeat"
    print(f"[kernels] fused_cla{tag}: blocks per SM (GLU launch, tail) "
          f"{cla_blocks_per_sm(f)}")
    for kernel in (f"cla_glu_kernel<{f}>", f"cla_tail_kernel<{f}>"):
        print(f"[kernels] fused_cla{tag}: {kernel}: "
              + "; ".join(ptxas.get(kernel, ["not in the build log"])))
    # per row: three products on the tensor cores; on the CUDA cores the
    # conv, and LN, GLU, biases, the folded BN, GELU and the residual
    products = 3 * 2 * f * h
    rest = 2 * k * f + 37 * f
    record(K.fused_cla, lambda: K.fused_cla(x, cla, 1e-5),
           lambda: K.cla_plain(x, cla, 1e-5), None,
           (got - ref).abs().max().item(),
           4 * (2 * x.numel() + sum(q.numel() for q in cla)),
           b * t * rest,
           source="sepreformer_torch/csrc/cla.cu",
           replaces="sepreformer_tpu/ops/pallas/cla.py:209",
           shape=f"x [{b}, {t}, {f}], k {k}",
           tolerance="rtol 1e-4, atol 1e-4 (float32)",
           # a sigmoid per GLU pair
           tc_flops=b * t * products, exps=b * t * f,
           cuda_core_flops=b * t * (products + rest), timings=5,
           instance=instance)
    launch_split(torch, lambda: K.fused_cla(x, cla, 1e-5), "cla_",
                 ("GLU", "conv and tail"))
    del cla

    h6 = 6 * f
    xd = randn(b, length, f)
    gate = [randn(f), randn(f), randn(f, f, scale=0.1), randn(f, scale=0.1)]
    gcfn = [randn(f), randn(f), randn(f, h6, scale=0.1), randn(h6, scale=0.1),
            randn(h6, 3, scale=0.3), randn(h6, scale=0.1),
            randn(h6 // 2, f, scale=0.1), randn(f, scale=0.1),
            randn(f, scale=0.5)]
    got = K.fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5)
    ref = K.ega_tail_gcfn_plain(x, xd, gate, gcfn, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    same = torch.equal(got, K.fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5))
    print(f"[kernels] fused_ega_tail_gcfn{tag}: bit-equal on a repeat call: "
          f"{same}")
    assert same, f"K16{tag} is not bit-equal on repeat"
    print(f"[kernels] fused_ega_tail_gcfn{tag}: {blocks_per_sm(f)} blocks "
          f"per SM; ega_gcfn_kernel<{f}>: " + "; ".join(
              ptxas.get(f"ega_gcfn_kernel<{f}>", ["not in the build log"])))
    # per row: the gate's product and K1's two; the two LayerNorms, the
    # gated residual, the conv and the GLU, and the residual
    products = 2 * f * f + 2 * f * h6 + 2 * (h6 // 2) * f
    rest = 8 * f + 5 * f + 8 * f + 7 * h6 + 5 * (h6 // 2) + 3 * f
    record(K.fused_ega_tail_gcfn,
           lambda: K.fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5),
           lambda: K.ega_tail_gcfn_plain(x, xd, gate, gcfn, 1e-5), None,
           (got - ref).abs().max().item(),
           4 * (2 * x.numel() + xd.numel()
                + sum(q.numel() for q in gate + gcfn)),
           b * t * rest,
           source="sepreformer_torch/csrc/ega_gcfn.cu",
           replaces="sepreformer_tpu/ops/pallas/ega_gcfn.py:181",
           shape=f"x [{b}, {t}, {f}], x_down [{b}, {length}, {f}], hidden "
                 f"{h6}",
           tolerance="rtol 1e-4, atol 1e-4 (float32)",
           # the three products on the tensor cores; a sigmoid per gate
           # column and per GLU pair
           tc_flops=b * t * products, exps=b * t * (f + h6 // 2),
           cuda_core_flops=b * t * (products + rest), timings=5,
           instance=instance)
    del xd, gate, gcfn, got, ref
    if instance is not None:
        del x
        torch.cuda.empty_cache()
        return

    w, bias = randn(f, 1, k, scale=0.1), randn(f, scale=0.1)
    got = K.depthwise_fwd(x, w, bias)
    ref = K.depthwise_fwd_plain(x, w, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    same = torch.equal(got, K.depthwise_fwd(x, w, bias))
    print(f"[kernels] depthwise_fwd: bit-equal on a repeat call: {same}")
    assert same, "K4 is not bit-equal on repeat"
    occ = depthwise_occupancy(k)["K4"]
    print(f"[kernels] depthwise K4 at k {k}: {occ['warps']} warps, "
          f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
          f"registers, {occ['local_bytes']} local (spill) bytes")
    nbytes = 4 * (2 * x.numel() + w.numel() + f)
    record(K.depthwise_fwd, lambda: K.depthwise_fwd(x, w, bias),
           lambda: K.depthwise_fwd_plain(x, w, bias),
           lambda: depthwise_forward(x, w, bias),
           (got - ref).abs().max().item(), nbytes, x.numel() * (2 * k + 1),
           source="sepreformer_torch/csrc/depthwise.cu",
           replaces="sepreformer_tpu/ops/pallas/depthwise.py:117",
           shape=f"x [{b}, {t}, {f}], w [{f}, 1, {k}]",
           tolerance="rtol 1e-4, atol 1e-5 (float32)", timings=5)
    past_l2_timings(torch, device_ms,
                    lambda xx: K.depthwise_fwd(xx, w, bias), x,
                    KERNEL_SYMBOLS["depthwise_fwd"],
                    bound_ms(nbytes, x.numel() * (2 * k + 1))[0],
                    out_bytes=4 * x.numel())


def attention_train_rows(torch, K, device_ms, randn, record, d=16, p=0.05,
                         instance=None):
    """K13 and K14 at the decoder attention of a B=2 x 4 s train batch
    (B*spks = 4 rows, 8 heads, L = 500, maxlen 2000) at head width ``d``
    and dropout ``p`` (Base's 16 at 0.05, Large's 32 at 0.1), against
    their plain versions: the forward at atol 1e-5 and bit-equal on a
    repeat call, each gradient (from K13's row statistics) within phase
    7's limit of its largest value and bit-equal on a repeat call.  K13's
    library yardstick is SDPA with the rel-pos bias as a float mask (at
    p 0: SDPA's dropout is not the hash mask); no library call computes
    K14's four gradients.  At d 32 also K13 at each split at [2, 8, 500]
    and [4, 8, 500], the choice of its split rule."""
    from sepreformer_torch.ops.kernels.attention_train import (
        fwd_occupancy as attention_train_fwd_occupancy,
    )

    dev = torch.device("cuda")
    b, heads, length, maxlen, seed = 4, 8, 500, 2000, 4321
    q, k, v, dout = (randn(b, heads, length, d) for _ in range(4))
    table = randn(2 * maxlen, d)
    key_len = torch.full((b,), length, dtype=torch.int32, device=dev)
    klens = [length] * b
    out, row_max, row_sum = K.attention_train_fwd(q, k, v, table, maxlen,
                                                  seed, p, key_len)
    ref = K.attention_train_plain(q, k, v, table, maxlen, seed, p)
    torch.cuda.synchronize()
    # a wrong dropout mask or hash row errs by O(1) at p > 0
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    pos = torch.arange(length, device=dev)
    idx = torch.clamp(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen
    storage = torch.empty(b, heads, length, -(-length // 16) * 16, device=dev)
    bias = storage[..., :length]
    with torch.no_grad():
        bias.copy_(torch.gather(torch.matmul(q, table.t()), 3,
                                idx.expand(b, heads, length, length))
                   / math.sqrt(d))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias)

    lib_err = (library() - K.attention_train_plain(q, k, v, table, maxlen,
                                                   seed, 0.0)).abs().max()
    print(f"[kernels] SDPA with the bias as a float mask, p 0: max |sdpa - "
          f"plain| {lib_err.item():.3e}")
    again = K.attention_train_fwd(q, k, v, table, maxlen, seed, p, key_len)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip((out, row_max, row_sum),
                                                  again))
    print(f"[kernels] attention_train_fwd at head width {d}: bit-equal on a "
          f"repeat call (out, row max, row sum): {same}")
    assert same, f"K13 is not bit-equal on repeat at d {d}"
    del again
    split, occupancy = attention_train_fwd_occupancy(b * heads, length, d)
    print(f"[kernels] attention_train_fwd at head width {d}: {split} warps "
          f"per row tile at this shape")
    for name, occ in occupancy.items():
        print(f"[kernels] {name}: {occ['warps']} warps, "
              f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
              f"registers, {occ['local_bytes']} local (spill) bytes")
    keys = b * length
    pairs = heads * relpos_pairs(length, klens, maxlen)[0]
    record(K.attention_train_fwd,
           lambda: K.attention_train_fwd(q, k, v, table, maxlen, seed, p,
                                         key_len),
           lambda: K.attention_train_plain(q, k, v, table, maxlen, seed, p),
           library, (out - ref).abs().max().item(),
           # q in and out written, k and v of the valid keys, the table,
           # the row statistics written
           4 * (2 * q.numel() + 2 * keys * heads * d + table.numel() + b
                + 2 * b * heads * length),
           # the online softmax's max, subtraction and sum per pair
           3 * pairs,
           source="sepreformer_torch/csrc/attention_train.cu",
           replaces="sepreformer_tpu/ops/pallas/attention_train.py:202",
           shape=(f"q, k, v [{b}, {heads}, {length}, {d}], table "
                  f"[{2 * maxlen}, {d}], p {p}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)",
           # QKᵀ, P·V and q·tableᵀ on the tensor cores (the tile K12
           # runs); one exponential per pair
           tc_flops=flash_relpos_ops(length, klens, maxlen, heads, d),
           exps=pairs,
           cuda_core_flops=flash_relpos_ops(length, klens, maxlen, heads, d),
           timings=5, instance=instance)
    grads = K.attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                  out, dout, row_max, row_sum)
    refs = K.attention_train_bwd_plain(q, k, v, table, maxlen, seed, p, None,
                                       dout)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, r in zip(("dq", "dk", "dv", "dtable"), grads, refs):
        e = (g - r).abs().max().item()
        assert e <= TRAIN_CPU_REL_LIMIT * r.abs().max().item(), (name, e)
        err = max(err, e)
    again = K.attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                  out, dout, row_max, row_sum)
    torch.cuda.synchronize()
    same = all(torch.equal(g, a) for g, a in zip(grads, again))
    print(f"[kernels] attention_train_bwd at head width {d}: bit-equal on a "
          f"repeat call: {same}")
    assert same, f"K14 is not bit-equal on repeat at d {d}"
    pairs = heads * relpos_pairs(length, klens, maxlen)[0]
    products = attention_train_bwd_ops(length, klens, maxlen, heads, d)
    record(K.attention_train_bwd,
           lambda: K.attention_train_bwd(q, k, v, table, maxlen, seed, p,
                                         key_len, out, dout, row_max,
                                         row_sum),
           lambda: K.attention_train_bwd_plain(q, k, v, table, maxlen, seed,
                                               p, None, dout),
           None, err,
           # q, k, v, dout and the table in; dq, dk, dv and dtable out
           4 * (7 * q.numel() + 2 * table.numel() + b),
           # P, the dropout and G per pair: the exponent's FMA, the scale,
           # z dP - delta, times P and c
           6 * pairs,
           source="sepreformer_torch/csrc/attention_train.cu",
           replaces="sepreformer_tpu/ops/pallas/attention_train.py:226",
           shape=(f"q, k, v, out, dout [{b}, {heads}, {length}, {d}], "
                  f"table [{2 * maxlen}, {d}], p {p}"),
           tolerance=f"max |kernel - plain| <= {TRAIN_CPU_REL_LIMIT:.0e} x "
                     f"max|plain| per gradient",
           # QKᵀ, dO·Vᵀ, dV, dQ, dK, q·bandᵀ and both band adjoints on the
           # tensor cores; one exponential per pair
           tc_flops=products, exps=pairs, cuda_core_flops=products,
           timings=5 if instance else 1, instance=instance)
    launch_split(torch, lambda: K.attention_train_bwd(
        q, k, v, table, maxlen, seed, p, key_len, out, dout, row_max,
        row_sum), "attn_train_bwd", (f"dq d={d}", f"dk/dv d={d}",
                                     f"table d={d}"))
    del storage, bias
    if d == 32:
        # the split rule's choice at Large's two train shapes: the
        # encoder's [2, 8, 500] (128 blocks) and the decoder's [4, 8, 500]
        for rows in (2, 4):
            x = [randn(rows, heads, length, d) for _ in range(3)]
            kl = torch.full((rows,), length, dtype=torch.int32, device=dev)
            ref = K.attention_train_plain(*x, table, maxlen, seed, p)
            times = {}
            for sp in (1, 2, 4):
                def run(sp=sp):
                    return K.attention_train_fwd(*x, table, maxlen, seed, p,
                                                 kl, split=sp)
                got = run()
                torch.cuda.synchronize()
                torch.testing.assert_close(got[0], ref, rtol=1e-4, atol=1e-5)
                times[sp] = statistics.median(
                    device_ms(run, kernel=KERNEL_SYMBOLS[
                        "attention_train_fwd"]) for _ in range(5))
            rule = attention_train_fwd_occupancy(rows * heads, length, d)[0]
            print(f"[kernels] attention_train_fwd at [{rows}, {heads}, "
                  f"{length}, {d}], p {p}, by split (median of 5): " +
                  ", ".join(f"{sp}: {t:.4f} ms" for sp, t in times.items())
                  + f"; the rule takes {rule}")
            del x, ref
    # K13's other splits at the shapes the routes launch it at: the
    # "pallas" step's encoder ([2, 8, 500], p 0.05) and the "single"
    # serve's decoder ([8, 8, 500], p 0, key lengths of 4 s down to 2.5 s)
    for rows, p_case, klens in ((2, p, [length] * 2),
                                (8, 0.0, [500, 438, 375, 313] * 2)):
        attention_train_case(torch, K, device_ms, randn, rows, heads, length,
                             maxlen, d, p_case, seed, klens, table)


def attention_train_case(torch, K, device_ms, randn, rows, heads, length,
                         maxlen, d, p, seed, klens, table):
    """K13 at [rows, heads, length, d] against its plain version (rtol
    1e-4, atol 1e-5), bit-equal on a repeat call, K14 on its row
    statistics within phase 7's limit; prints its split and five
    timings beside the plain version's."""
    from sepreformer_torch.ops.kernels.attention_train import (
        fwd_occupancy as attention_train_fwd_occupancy,
    )

    q, k, v, dout = (randn(rows, heads, length, d) for _ in range(4))
    key_len = torch.tensor(klens, dtype=torch.int32, device=q.device)

    def run():
        return K.attention_train_fwd(q, k, v, table, maxlen, seed, p,
                                     key_len)

    out, row_max, row_sum = run()
    ref = K.attention_train_plain(q, k, v, table, maxlen, seed, p, key_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    again = run()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip((out, row_max, row_sum),
                                                  again))
    assert same, f"K13 at [{rows}, {heads}, {length}] is not bit-equal"
    grads = K.attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                  out, dout, row_max, row_sum)
    refs = K.attention_train_bwd_plain(q, k, v, table, maxlen, seed, p,
                                       key_len, dout)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv", "dtable"), grads, refs):
        e = (g - r).abs().max().item()
        assert e <= TRAIN_CPU_REL_LIMIT * r.abs().max().item(), (rows, name, e)
    split = attention_train_fwd_occupancy(rows * heads, length, d)[0]
    times = [device_ms(run, kernel=KERNEL_SYMBOLS["attention_train_fwd"])
             for _ in range(5)]
    plain = device_ms(lambda: K.attention_train_plain(
        q, k, v, table, maxlen, seed, p, key_len))
    print(f"[kernels] attention_train_fwd at [{rows}, {heads}, {length}, "
          f"{d}], p {p}, key lengths {sorted(set(klens), reverse=True)}: "
          f"split {split}; max |kernel - plain| "
          f"{(out - ref).abs().max().item():.3e} (rtol 1e-4, atol 1e-5); "
          f"bit-equal on a repeat call (out, row max, row sum): {same}; K14 "
          f"on its row statistics within {TRAIN_CPU_REL_LIMIT:.0e} x "
          f"max|plain|; 5 timings " + ", ".join(f"{t:.4f}" for t in times)
          + f" ms, median {statistics.median(times):.4f}, plain "
          f"{plain:.4f}")


def k12_checksum(torch, K):
    """SHA-1 of K12's output bytes at phase 2's shape ([2, 8750, 128],
    lens (8750, 7000), maxlen 2000) on inputs drawn from a fixed seed, so
    that two trees' runs on one card compare bit for bit."""
    import hashlib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1217)
    b, length, maxlen, f, d = 2, 8750, 2000, 128, 16
    q, k, v = (torch.randn(b, length, f, generator=gen, device=dev)
               for _ in range(3))
    table = torch.randn(2 * maxlen, d, generator=gen, device=dev)
    lens = torch.tensor([8750, 7000], device=dev)
    with torch.no_grad():
        out = K.flash_relpos_attention(q, k, v, table, maxlen, lens)
    return hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()


def flash_kernel_row(torch, K, device_ms, randn, record, d=16):
    """K12 at the decoder batch of a 70 s request in full context (B*spks
    = 2 rows, 8 heads of ``d``: Base's 16, Large's 32; L = 8750 > 8192,
    maxlen 2000, ragged key lengths), against its plain version; the
    library yardstick is PyTorch's SDPA with the rel-pos bias and the key
    mask as a float mask built outside the timed call; today's dense route
    at the same shape (K2, the score products, K3) is timed beside it.
    ``record`` adds the row."""
    from sepreformer_torch.models.blocks import fused_pv_scores, pad_time

    dev = torch.device("cuda")
    b, length, maxlen, heads = 2, 8750, 2000, 8
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
    again = K.flash_relpos_attention(q, k, v, table, maxlen, klens)
    assert torch.equal(again, K.flash_relpos_attention(q, k, v, table,
                                                       maxlen, klens)), (
        f"K12 is not bit-equal on repeat at head width {d}")
    del again
    if d == 16:
        print(f"[kernels] flash_relpos_attention: SHA-1 of the output bytes "
              f"on the fixed-seed inputs: {k12_checksum(torch, K)}")
    pairs = heads * relpos_pairs(length, klens.tolist(), maxlen)[0]
    record(K.flash_relpos_attention,
           lambda: K.flash_relpos_attention(q, k, v, table, maxlen, klens),
           lambda: K.flash_relpos_attention_plain(q, k, v, table, maxlen,
                                                  klens),
           library, err,
           # q in and out written; k and v of the valid keys; the table
           4 * (2 * q.numel() + 2 * keys * f + table.numel() + b),
           # the online softmax's max, subtraction and sum per pair
           3 * pairs,
           source="sepreformer_torch/csrc/flash_relpos.cu",
           replaces="sepreformer_tpu/ops/pallas/attention.py:237",
           shape=(f"q, k, v [{b}, {length}, {f}], table [{2 * maxlen}, "
                  f"{d}], lens {klens.tolist()}"),
           tolerance="rtol 1e-4, atol 1e-5 (float32)",
           # QKᵀ, P·V and q·tableᵀ on the tensor cores; one exponential
           # per pair
           tc_flops=flash_relpos_ops(length, klens.tolist(), maxlen, heads,
                                     d),
           exps=pairs,
           cuda_core_flops=flash_relpos_ops(length, klens.tolist(), maxlen,
                                            heads, d),
           instance=None if d == 16 else f"d={d}")
    del storage, bias
    torch.cuda.empty_cache()
    print(f"[kernels] the same shape through the dense route (K2 pos_kt "
          f"[{lp}, {d}, {lp}], the score products, K3): "
          f"{device_ms(dense):.4f} ms")
    torch.cuda.empty_cache()


def bf16_errors(got, ref):
    """(max, mean) |got - ref| over max|ref|, in float32."""
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max()
    return (d.max() / scale).item(), (d.mean() / scale).item()


def max_in_first_tiles(torch, scores, klens):
    """``scores`` [B, H, lp, lp] with each row's max over its valid keys
    (``klens[b]``) copied to keys 0, 64, 128 and 192: the first key tile of
    each of up to four warps that share a row in K3 (tiles of 64 keys,
    warp w taking the tiles n with n % SPLIT == w), whose running max is
    then the row's from its first tile on."""
    lp = scores.shape[-1]
    valid = torch.arange(lp, device=scores.device)[None] < klens[:, None]
    row_max = scores.float().masked_fill(
        ~valid[:, None, None, :], float("-inf")).amax(dim=-1)
    out = scores.clone()
    for j in range(0, min(lp, 256), 64):
        out[..., j] = row_max.to(scores.dtype)
    return out


def max_at_key0(torch, gen, b, length, heads, d, maxlen, device):
    """bfloat16 q, k, v [B, L, H*d] and a [2*maxlen, d] table on which every
    query's largest score is at key 0, so that K12's running max is the
    row's from its first key tile on: per head the keys are multiples
    lambda_j < 0.9 of one vector w (lambda_0 = 1), each query is w plus
    noise (q.w > 0), and a table of one repeated row adds the same bias to
    each of a query's keys."""
    w = torch.randn(heads, d, generator=gen)
    q = w + 0.3 * torch.randn(b, length, heads, d, generator=gen)
    lam = torch.rand(b, length, generator=gen) * 1.9 - 1.0
    lam[:, 0] = 1.0
    k = lam[..., None, None] * w
    v = torch.randn(b, length, heads, d, generator=gen)
    table = (0.5 * torch.randn(1, d, generator=gen)).expand(2 * maxlen, d)
    return [a.reshape(b, length, -1).to(device, torch.bfloat16).contiguous()
            for a in (q, k, v)] + [table.to(device, torch.bfloat16)
                                   .contiguous()]


def bf16_kernel_rows(torch, K, device_ms, randn, record):
    """The bfloat16 instances of K1, K3 and K12 at the shapes of their
    float32 rows: each against its plain bfloat16 version on the card
    (max and mean |kernel - plain| over max|out| within ``BF16_MAX`` and
    ``BF16_MEAN``, which the plain version without its rounding steps must
    exceed; K3 and K12 within ``BF16_TILE_MEAN``, and within ``BF16_MEAN``
    on scores whose row max is in the first key tiles; K3 on bfloat16
    scores and a float32 V, whose output is float32, at float32's bar),
    bit-equal on a repeat call, with its time,
    its bound (bytes at the bfloat16 sizes, bfloat16 products at
    ``BF16_FLOPS``) and a library call where one computes it: K3's a
    bfloat16 softmax and matmul, K12's bfloat16 SDPA with the rel-pos bias
    and the key mask as a bfloat16 float mask."""
    from sepreformer_torch.ops.kernels.softmax_pv import dtype_instance

    dev = torch.device("cuda")
    bf = torch.bfloat16

    tolerance = (f"max {BF16_MAX:.4f}, mean {BF16_MEAN:.0e} of max|out|, "
                 f"{BF16_TILE_MEAN:.0e} where p rounds against a tile's "
                 f"running max (bfloat16)")

    def check(name, run, plain, control=None, limit=BF16_MEAN):
        """Fail unless ``run()`` agrees with ``plain()`` (a bfloat16 output
        within ``BF16_MAX`` and a mean within ``limit``) and two calls give
        the same bits, and unless ``control()``, where given, the plain
        version without its rounding steps, exceeds the mean limit;
        returns max |kernel - plain|."""
        got, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err_max, err_mean = bf16_errors(got, ref)
        ctl_mean = None if control is None else bf16_errors(control(), ref)[1]
        print(f"[kernels] {name}: max |kernel - plain| / max|out| "
              f"{err_max:.3e}, mean {err_mean:.3e}" + (
                  "" if got.dtype != bf else f" (limit {limit:.0e})") + (
                  "" if ctl_mean is None else
                  f"; the plain version without its rounding steps "
                  f"{ctl_mean:.3e}") + f"; bit-equal on a repeat call: {same}")
        if got.dtype != bf:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        else:
            assert ref.dtype == bf, ref.dtype
            assert err_max <= BF16_MAX and err_mean <= limit, (
                f"{name}: {err_max:.3e}, {err_mean:.3e}")
        if ctl_mean is not None:
            assert ctl_mean > limit, (
                f"{name}: the mean limit does not see the rounding steps")
        assert same, f"{name} is not bit-equal on repeat"
        return (got.float() - ref.float()).abs().max().item()

    # K1 at [4, 8000, F], ragged, x and out bfloat16
    b, t = 4, 8000
    lens = torch.tensor([8000, 7008, 6000, 5008], device=dev)
    for f, instance in ((128, "bf16"), (256, "F=256 bf16")):
        h = 6 * f
        x = randn(b, t, f).to(bf)
        params = [randn(f), randn(f), randn(f, h, scale=0.1),
                  randn(h, scale=0.1), randn(h, 3, scale=0.3),
                  randn(h, scale=0.1), randn(h // 2, f, scale=0.1),
                  randn(f, scale=0.1), randn(f, scale=0.5)]
        err = check(f"fused_gcfn {instance}",
                    lambda: K.fused_gcfn(x, params, 1e-5, lens),
                    lambda: K.gcfn_plain(x, params, 1e-5, lens),
                    lambda: K.gcfn_plain(x.float(), params, 1e-5,
                                         lens).to(bf))
        rest = 8 * f + 7 * h + 5 * (h // 2) + 3 * f     # LN, dw3, GLU
        valid = [min(n, t) for n in lens.tolist()]
        g_rows = sum(min(n + 1, t) + (n + 1 < t) for n in valid)
        record(K.fused_gcfn, lambda: K.fused_gcfn(x, params, 1e-5, lens),
               lambda: K.gcfn_plain(x, params, 1e-5, lens), None, err,
               2 * 2 * x.numel() + 4 * (sum(p.numel() for p in params) + b),
               b * t * rest, source="sepreformer_torch/csrc/gcfn.cu",
               replaces="sepreformer_tpu/ops/pallas/gcfn.py:394",
               shape=f"x [{b}, {t}, {f}] bfloat16, hidden {h}, lens "
                     f"{lens.tolist()}",
               tolerance=tolerance, exps=g_rows * (h // 2),
               bf16_flops=(sum(valid) * 2 * f * h
                           + g_rows * 2 * (h // 2) * f),
               timings=3, instance=instance,
               symbol=BF16_SYMBOLS["fused_gcfn"])
        del x, params
    torch.cuda.empty_cache()

    # K3 at [8, 8, 512, 512], length 500, ragged: V bfloat16 with float32
    # and bfloat16 scores at head width 16, float32 scores at 32; bfloat16
    # scores with a float32 V at 16
    b, heads, lp, length = 8, 8, 512, 500
    klens = torch.tensor([500, 500, 438, 438, 376, 376, 313, 313],
                         device=dev)
    keys = sum(klens.tolist())
    pairs = heads * lp * keys
    kmask = torch.arange(lp, device=dev)[None] < klens[:, None]
    for d, s_dtype, v_dtype in ((16, torch.float32, bf), (16, bf, bf),
                                (32, torch.float32, bf),
                                (16, bf, torch.float32)):
        f = heads * d
        scores = randn(b, heads, lp, lp, scale=3.0).to(s_dtype)
        v = randn(b, lp, f).to(v_dtype)
        instance = dtype_instance(s_dtype, v_dtype)
        instance = instance if d == 16 else f"d={d} {instance}"
        f32_out = v_dtype == torch.float32
        err = check(f"softmax_pv {instance}",
                    lambda: K.softmax_pv(scores, v, klens, length),
                    lambda: K.softmax_pv_plain(scores, v, klens, length),
                    limit=BF16_TILE_MEAN)
        if not f32_out:
            first = max_in_first_tiles(torch, scores, klens)
            check(f"softmax_pv {instance}, the row max in the first tiles",
                  lambda: K.softmax_pv(first, v, klens, length),
                  lambda: K.softmax_pv_plain(first, v, klens, length),
                  lambda: K.softmax_pv_plain(first.float(), v.float(), klens,
                                             length).to(bf))
            del first
        masked = torch.where(kmask[:, None, None, :], scores,
                             torch.tensor(-1e30, device=dev, dtype=s_dtype))
        vh = v.reshape(b, lp, heads, d).permute(0, 2, 1, 3).contiguous()
        ss, vs = scores.element_size(), v.element_size()
        products = 2 * d * pairs
        record(K.softmax_pv, lambda: K.softmax_pv(scores, v, klens, length),
               lambda: K.softmax_pv_plain(scores, v, klens, length),
               lambda: torch.matmul(
                   torch.softmax(masked, dim=-1).to(v_dtype), vh),
               err, ss * heads * lp * keys + vs * (keys * f + b * lp * f)
               + 4 * b, 3 * pairs,
               source="sepreformer_torch/csrc/softmax_pv.cu",
               replaces="sepreformer_tpu/ops/pallas/softmax_pv.py:342",
               shape=(f"scores [{b}, {heads}, {lp}, {lp}] {s_dtype}, v "
                      f"[{b}, {lp}, {f}] {v_dtype}, lens {klens.tolist()}, "
                      f"length {length}"),
               tolerance="rtol 1e-4, atol 1e-5 (float32 out)" if f32_out
               else tolerance, exps=pairs,
               tc_flops=products if f32_out else 0.0,
               bf16_flops=0.0 if f32_out else products, timings=5,
               instance=instance, symbol=BF16_SYMBOLS["softmax_pv"])
        del scores, v, masked, vh
    torch.cuda.empty_cache()

    # K12 at the decoder batch of a 70 s request, q, k, v and the table
    # bfloat16
    b, length, maxlen = 2, 8750, 2000
    klens = torch.tensor([8750, 7000], device=dev)
    keys = sum(klens.tolist())
    pos = torch.arange(length, device=dev)
    for d in (16, 32):
        f = heads * d
        q, k, v = (randn(b, length, f).to(bf) for _ in range(3))
        table = randn(2 * maxlen, d).to(bf)
        instance = "bf16" if d == 16 else f"d={d} bf16"
        err = check(f"flash_relpos_attention {instance}",
                    lambda: K.flash_relpos_attention(q, k, v, table, maxlen,
                                                     klens),
                    lambda: K.flash_relpos_attention_plain(
                        q, k, v, table, maxlen, klens),
                    limit=BF16_TILE_MEAN)
        first = max_at_key0(torch, torch.Generator().manual_seed(d), b,
                            length, heads, d, maxlen, dev)
        check(f"flash_relpos_attention {instance}, the row max at key 0",
              lambda: K.flash_relpos_attention(*first, maxlen, klens),
              lambda: K.flash_relpos_attention_plain(*first, maxlen, klens),
              lambda: K.flash_relpos_attention_plain(
                  *(a.float() for a in first), maxlen, klens).to(bf))
        del first

        def split(a):                                   # [B, H, L, d]
            return a.reshape(b, length, heads, d).transpose(1, 2).contiguous()

        qh, kh, vh = split(q), split(k), split(v)
        storage = torch.empty(b, heads, length, -(-length // 16) * 16,
                              device=dev, dtype=bf)
        bias = storage[..., :length]
        with torch.no_grad():
            for i0 in range(0, length, 1024):
                by_row = torch.matmul(qh[:, :, i0:i0 + 1024].float(),
                                      table.float().t())
                idx = torch.clamp(pos[i0:i0 + 1024, None] - pos[None],
                                  -maxlen, maxlen - 1) + maxlen
                bias[:, :, i0:i0 + 1024] = (torch.gather(
                    by_row, 3, idx.expand(b, heads, *idx.shape))
                    / math.sqrt(d)).to(bf)
            bias.masked_fill_(~(pos[None] < klens[:, None])[:, None, None, :],
                              float("-inf"))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias)

        pairs = heads * relpos_pairs(length, klens.tolist(), maxlen)[0]
        record(K.flash_relpos_attention,
               lambda: K.flash_relpos_attention(q, k, v, table, maxlen,
                                                klens),
               lambda: K.flash_relpos_attention_plain(q, k, v, table, maxlen,
                                                      klens),
               library, err,
               2 * (2 * q.numel() + 2 * keys * f + table.numel()) + 4 * b,
               3 * pairs, source="sepreformer_torch/csrc/flash_relpos.cu",
               replaces="sepreformer_tpu/ops/pallas/attention.py:237",
               shape=(f"q, k, v [{b}, {length}, {f}] bfloat16, table "
                      f"[{2 * maxlen}, {d}], lens {klens.tolist()}"),
               tolerance=tolerance, exps=pairs,
               bf16_flops=flash_relpos_ops(length, klens.tolist(), maxlen,
                                           heads, d),
               timings=3, instance=instance,
               symbol=BF16_SYMBOLS["flash_relpos_attention"])
        del q, k, v, qh, kh, vh, storage, bias
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

    def forward(aux=False):
        with torch.inference_mode():
            return sep.model(x, lengths=lens, aux=aux)

    # the serving forward (audio alone, as Separator.separate runs it),
    # then the forward with the aux heads, which training and validation
    # run, in turns
    for aux in (False, True):
        forward(aux)
    torch.cuda.synchronize()
    walls = {False: [], True: []}
    for _ in range(iters):
        for aux in (False, True):
            t0 = time.perf_counter()
            forward(aux)
            torch.cuda.synchronize()
            walls[aux].append((time.perf_counter() - t0) * 1e3)
    for aux, what in ((False, "audio alone"), (True, "with the aux heads")):
        median = statistics.median(walls[aux])
        print(f"[profile] batch B=4 x 4 s over {iters} forwards, {what}, "
              f"ms: {[round(t, 2) for t in walls[aux]]}; "
              f"{sum(lengths) / SAMPLE_RATE / (median / 1e3):.2f} audio-s/s "
              f"at the median")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for aux, what in ((False, "forward"), (True, "forward with aux heads")):
        K.reset_launches()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            forward(aux)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        kernels = kernel_events(prof)
        print_trace("profile", kernels, busy_us(kernels), window_us,
                    K.launch_counts(), what)


def layer_scales_at(torch, model, value=0.5):
    """Every LayerScale of ``model`` at ``value`` (at the init's 1e-5 the
    branches are too small to show an error)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(value)
    return model


def card_against_cpu(torch, np, sep_torch, variant, model, wav, tag):
    """``Separator(variant, model)(wav)`` on the card against the same
    weights on the CPU's plain path, within ``CPU_REL_LIMIT`` of max|out|;
    a control run on the card with TF32 allowed must exceed the limit, so
    that the check can see a product that lost float32 accuracy."""
    cpu = np.stack(sep_torch.Separator(
        variant, copy.deepcopy(model).to("cpu"))(wav))
    scale = float(np.abs(cpu).max())
    errs = {}
    for label, tf32 in (("float32", False), ("control, TF32 allowed", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            gpu = np.stack(sep_torch.Separator(variant, model)(wav))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        assert np.isfinite(gpu).all(), label
        errs[label] = float(np.abs(gpu - cpu).max()) / scale
        print(f"[{tag}] {label}: max |card - cpu| / max|out| "
              f"{errs[label]:.3e} (max|out| {scale:.3f}), limit "
              f"{CPU_REL_LIMIT:.1e}")
    assert errs["float32"] <= CPU_REL_LIMIT, "card disagrees with the CPU"
    assert errs["control, TF32 allowed"] > CPU_REL_LIMIT, (
        "the limit does not catch TF32 products")


def cpu_phase(torch, np, sep_torch, sep):
    """Base's output on the card against the CPU's plain path on the same
    weights, every LayerScale at 0.5, on a 1 s utterance, with a TF32
    control (``card_against_cpu``)."""
    rng = np.random.default_rng(1)
    wav = (rng.normal(size=SAMPLE_RATE) * 0.1).astype(np.float32)
    model = layer_scales_at(torch, copy.deepcopy(sep.model))
    card_against_cpu(torch, np, sep_torch, sep.variant, model, wav, "cpu")


def eval_grad_phase(torch, np, sep_torch, K):
    """Gradients through the eval forward: K1, K2 and K3 launch in the
    card's forward and their gradients recompute the plain versions (K2's
    is its own adjoint).  A fixed scalar of the output (the separated
    audio and the aux heads, each weighted by seeded noise) is
    differentiated with respect to the mixture and every parameter, on
    the card and on the CPU from the same weights; the largest |card -
    cpu| over every gradient, over the largest CPU gradient, must stay
    within phase 7's limit, and a control with TF32 allowed must exceed
    it.  Then K12 alone: the gradients of q, k, v and the table at [1,
    2000, 128] with lengths, card against CPU."""
    variant = sep_torch.get_variant("SepReformer_Base_WSJ0")
    model = seeded_model(torch, sep_torch, variant, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    n = SAMPLE_RATE
    mix = torch.from_numpy((rng.normal(size=(1, n)) * 0.1).astype(
        np.float32))
    lengths = torch.tensor([n])
    spks, stages = variant.model.num_spks, variant.model.num_stages
    w_audio = torch.from_numpy(rng.normal(size=(spks, 1, n)).astype(
        np.float32))
    w_aux = torch.from_numpy(rng.normal(size=(stages, spks, 1, n)).astype(
        np.float32))

    def grads(device):
        m = copy.deepcopy(model).to(device)
        x = mix.detach().to(device, copy=True).requires_grad_()
        audio, aux = m(x, lengths=lengths.to(device))
        value = ((audio * w_audio.to(device)).sum()
                 + (aux * w_aux.to(device)).sum())
        names = ["mixture"] + [name for name, _ in m.named_parameters()]
        got = torch.autograd.grad(value, [x] + list(m.parameters()),
                                  allow_unused=True)
        return float(value.detach()), {
            name: g.detach().cpu() for name, g in zip(names, got)
            if g is not None}

    t0 = time.perf_counter()
    cpu_value, cpu_grads = grads("cpu")
    print(f"[eval_grad] CPU forward and backward "
          f"{time.perf_counter() - t0:.2f} s; {len(cpu_grads)} gradients "
          f"(the mixture and parameters)")
    scale = max(g.abs().max().item() for g in cpu_grads.values())
    errs = {}
    for label, context in (("float32", contextlib.nullcontext),
                           ("control, TF32 allowed",
                            lambda: tf32_allowed(torch))):
        K.reset_launches()
        t0 = time.perf_counter()
        with context():
            value, card_grads = grads("cuda")
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        missing = [n for n in EVAL_KERNELS if counts[n] == 0]
        assert not missing, f"eval kernels never launched: {missing}"
        assert card_grads.keys() == cpu_grads.keys(), label
        assert all(torch.isfinite(g).all() for g in card_grads.values())
        worst = max(card_grads, key=lambda n: (card_grads[n]
                                               - cpu_grads[n]).abs().max())
        errs[label] = (card_grads[worst] - cpu_grads[worst]).abs().max(
        ).item() / scale
        value_err = abs(value - cpu_value) / abs(cpu_value)
        print(f"[eval_grad] {label}: {dt:.2f} s, launches "
              f"{ {n: counts[n] for n in EVAL_KERNELS} }; value {value:.6f}"
              f" (|card - cpu| / |cpu| {value_err:.3e}); max |card - cpu| "
              f"over every gradient / max |cpu gradient| {errs[label]:.3e} "
              f"(max {scale:.3e}, worst {worst}), limit "
              f"{TRAIN_CPU_REL_LIMIT:.1e}")
        if label == "float32":
            assert value_err <= TRAIN_CPU_REL_LIMIT, "value disagrees"
    assert errs["float32"] <= TRAIN_CPU_REL_LIMIT, (
        "eval-forward gradients disagree with the CPU")
    assert errs["control, TF32 allowed"] > TRAIN_CPU_REL_LIMIT, (
        "the limit does not catch TF32 products")

    gen = torch.Generator().manual_seed(12)
    length, maxlen = 2000, variant.model.pos_maxlen
    q, k, v, w = (torch.randn(1, length, 128, generator=gen)
                  for _ in range(4))
    table = torch.randn(2 * maxlen, 16, generator=gen)
    lens = torch.tensor([1700])

    def k12_grads(device):
        leaves = [a.to(device, copy=True).requires_grad_()
                  for a in (q, k, v, table)]
        out = K.flash_relpos_attention(*leaves, maxlen, lens.to(device))
        got = torch.autograd.grad((out * w.to(device)).sum(), leaves)
        return [g.cpu() for g in got]

    K.reset_launches()
    card = k12_grads("cuda")
    assert K.flash_relpos_attention.launches == 1
    cpu = k12_grads("cpu")
    scale = max(g.abs().max().item() for g in cpu)
    err = max((a - b).abs().max().item() for a, b in zip(card, cpu)) / scale
    print(f"[eval_grad] K12 [1, {length}, 128], maxlen {maxlen}, lens "
          f"{lens.tolist()}: max |card - cpu| over dq, dk, dv, dtable / max "
          f"|cpu gradient| {err:.3e} (max {scale:.3e}), limit "
          f"{TRAIN_CPU_REL_LIMIT:.1e}")
    assert err <= TRAIN_CPU_REL_LIMIT, "K12's gradients disagree"


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


def traced_kernels(prof):
    """``kernel_events(prof)`` (a trace is exported once), and K13's
    launches in it by (B*H, row tiles of 64, head width, split): its grid
    is (row tiles, B*H), its head width and split the kernel's template
    arguments."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh).get("traceEvents", [])
                      if e.get("cat") == "kernel" and "dur" in e]
    shapes = defaultdict(int)
    for e in events:
        if "attn_train_fwd" in e["name"]:
            grid = e.get("args", {}).get("grid") or [None, None]
            args = re.search(r"attn_train_fwd_kernel<(\d+), (\d+)>",
                             e["name"])
            shapes[(grid[1], grid[0]) + (tuple(map(int, args.groups()))
                                         if args else (None, None))] += 1
    return [(e["name"], e["ts"], e["dur"]) for e in events], dict(shapes)


def print_k13_grids(tag, shapes, what):
    print(f"[{tag}] K13 launches in the {what} by (B*H, row tiles of 64, "
          f"head width, split): " + ", ".join(f"{key} x{n}" for key, n in
                                   sorted(shapes.items(), key=str)))


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
    stray = [n for n in EVAL_ONLY_KERNELS if counts[n]]
    assert not stray, f"eval-only kernels on the train path: {stray}"
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


@contextlib.contextmanager
def tf32_allowed(torch):
    """TF32 in cuBLAS's and cuDNN's float32 products, for a control run."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def train_against_cpu(torch, np, sep_torch, tag, cfg, controls,
                      witnesses=None):
    """One train step of ``cfg`` on the card and on the CPU from the same
    weights: dropout 0, every LayerScale at 0.5, a 1 s crop.  The loss and
    every gradient (read after the step's clip) must agree within
    ``TRAIN_CPU_REL_LIMIT``; each of ``controls`` (label -> a context in
    which the card's step runs) must exceed it.  Each of ``witnesses``
    (the same) is run and printed, to show where the reading comes from."""
    from sepreformer_torch.engine import create_train_state, train_step
    from sepreformer_torch.models import build_model

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
    print(f"[{tag}] CPU step {time.perf_counter() - t0:.2f} s, "
          f"loss {cpu_loss:.6f}")
    scale = max(g.abs().max().item() for g in cpu_grads.values())
    errs = {}
    for label, context in {"float32": contextlib.nullcontext, **controls,
                           **(witnesses or {})}.items():
        with context():
            loss, grads = step("cuda")
        assert all(torch.isfinite(g).all() for g in grads.values()), label
        worst = max(grads, key=lambda n: (grads[n] - cpu_grads[n]).abs().max())
        errs[label] = (grads[worst] - cpu_grads[worst]).abs().max().item()
        errs[label] /= scale
        loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
        print(f"[{tag}] {label}: loss {loss:.6f} (|card - cpu| / |cpu| "
              f"{loss_err:.3e}); max |card - cpu| over every gradient / max "
              f"|cpu gradient| {errs[label]:.3e} (max {scale:.3e}, worst "
              f"{worst}), limit {TRAIN_CPU_REL_LIMIT:.1e}")
        if label == "float32":
            assert loss_err <= TRAIN_CPU_REL_LIMIT, "loss disagrees"
    assert errs["float32"] <= TRAIN_CPU_REL_LIMIT, (
        "card gradients disagree with the CPU")
    for label in controls:
        assert errs[label] > TRAIN_CPU_REL_LIMIT, (
            f"the limit does not catch the {label}")


@contextlib.contextmanager
def k7_plain():
    """K7's plain version in place of the kernel (K8 stays), for a
    witness run."""
    from sepreformer_torch.ops.kernels import gcfn_train

    kernel = gcfn_train.gcfn_train_fwd
    gcfn_train.gcfn_train_fwd = gcfn_train.gcfn_train_plain
    try:
        yield
    finally:
        gcfn_train.gcfn_train_fwd = kernel


def train_cpu_phase(torch, np, sep_torch):
    """One train step on the card and on the CPU from the same weights,
    with a TF32 control and a witness with K7's plain version; then one
    train-mode GCFN at dropout 0.05."""
    import dataclasses

    base = sep_torch.get_variant("SepReformer_Base_WSJ0")
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, dropout=0.0))
    train_against_cpu(torch, np, sep_torch, "train_cpu", cfg, {
        "control, TF32 allowed": lambda: tf32_allowed(torch)},
        {"witness, K7 as its plain version": k7_plain})
    gcfn_train_cpu(torch, np)


def gcfn_train_cpu(torch, np, f=128, p=0.05, tag="train_cpu"):
    """One GCFN of width ``f`` in train mode at dropout ``p`` on the card
    (K7, K8) and on the CPU (plain, the same hash masks): the output and
    the ten gradients (x and nine parameters) within phase 7's limit, each
    over its largest CPU value."""
    from sepreformer_torch.models.blocks import GCFN, TrainMode

    gen = torch.Generator().manual_seed(7)
    gcfn = GCFN(f)
    with torch.no_grad():
        for prm in gcfn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.2)
        gcfn.Layer_scale.layer_scale.fill_(0.5)
    x = torch.randn(2, 2000, f, generator=gen)
    w = torch.randn(2, 2000, f, generator=gen)

    def run(device):
        module = copy.deepcopy(gcfn).to(device)
        xd = x.to(device).detach().requires_grad_()
        train = TrainMode(p, torch.Generator(device=device),
                          torch.Generator().manual_seed(8))
        out = module(xd, None, train)
        (out * w.to(device)).sum().backward()
        grads = [xd.grad] + [prm.grad for prm in module.parameters()]
        return [a.detach().cpu() for a in [out] + grads]

    cpu, card = run("cpu"), run("cuda")
    names = ["out", "dx"] + [n for n, _ in gcfn.named_parameters()]
    worst = max(((c - g).abs().max().item() / g.abs().max().item(), n)
                for n, c, g in zip(names, card, cpu))
    print(f"[{tag}] GCFN [2, 2000, {f}], p {p}: max |card - cpu| / "
          f"max|cpu| over the output and ten gradients {worst[0]:.3e} "
          f"(worst {worst[1]}), limit {TRAIN_CPU_REL_LIMIT:.1e}")
    assert worst[0] <= TRAIN_CPU_REL_LIMIT, "the train GCFN disagrees"


@contextlib.contextmanager
def engine_log():
    """The messages of the port's logger while the context runs, in a
    list."""
    import logging

    lines = []

    class Collect(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("sepreformer_torch")
    logger.setLevel(logging.INFO)
    handler = Collect()
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)


def epoch_losses(line):
    """(train, valid) loss of the engine's "epoch ..." log line."""
    return [float(v) for v in line.split()[3:6:2]]


def engine_phase(torch, np, K, model="SepReformer_Base_WSJ0", tag="engine"):
    """Train ``model`` from ``sepreformer_torch.cli.main`` on a seeded
    synthetic corpus: 2 epochs, a resumed third, then test."""
    import csv
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.data.synth import generate_corpus

    with engine_log() as lines:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            generate_corpus(os.path.join(tmp, "corpus"), n_train=16,
                            n_valid=4, n_test=4, seed=0)
            print(f"[{tag}] corpus 16/4/4 utterances of 3-6 s in "
                  f"{time.perf_counter() - t0:.2f} s")
            work = os.path.join(tmp, "work")
            args = ["--model", model, "--scp-root",
                    os.path.join(tmp, "corpus"), "--scp-dir", "scp",
                    "--workdir", work, "--batch-size", "2",
                    "--set", "engine.test_epochs="]
            K.reset_launches()
            for mode, extra in (("train", ["--max-epoch", "3"]),
                                ("resume", ["--max-epoch", "4"]),
                                ("test", ["--engine-mode", "test"])):
                t0 = time.perf_counter()
                assert cli.main(args + extra) == 0, mode
                print(f"[{tag}] {mode}: {time.perf_counter() - t0:.2f} s")
            counts = K.launch_counts()
            for line in lines:
                print(f"[{tag}] log: {line}")
            epochs = [ln for ln in lines if ln.startswith("epoch ")]
            assert len(epochs) == 3, epochs
            assert any(ln.startswith("resumed from epoch") for ln in lines)
            for ln in epochs:
                assert all(np.isfinite(epoch_losses(ln))), ln
            ckpt = os.path.join(work, "log", "scratch_weights",
                                "epoch.0003.pth")
            assert os.path.exists(ckpt), "no checkpoint of the resumed epoch"
            means = {}
            for name in ("SISNRi", "SDRi"):
                with open(os.path.join(work, f"test_{name}_value.csv")) as f:
                    rows = list(csv.reader(f))
                assert len(rows) == 4, rows
                means[name] = float(np.mean([float(r[1]) for r in rows]))
            print(f"[{tag}] test over 4 utterances: SI-SNRi "
                  f"{means['SISNRi']:.4f} dB, SDRi {means['SDRi']:.4f} dB")
            assert all(np.isfinite(v) for v in means.values()), means
    print(f"[{tag}] launches over the three runs: {counts}")
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
    # TF32 reaches only the cuBLAS and cuDNN products (K12 takes its
    # products as 3xTF32 whatever the flag), so two controls change the
    # K12 route itself: K12 on inputs rounded to
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
    # the model's forward at 300 s with lengths, audio alone (what
    # Separator runs) and with the aux heads (what training and validation
    # run): the same audio bits, and each one's wall and peak
    x300 = torch.from_numpy(wav300[None]).to("cuda")
    lens300 = torch.tensor([n300], device="cuda")

    def forward300(aux):
        with torch.inference_mode():
            out = model(x300, lengths=lens300, aux=aux)
        return out[0] if aux else out

    alone, _ = run("300 s full context, the forward, audio alone",
                   lambda: forward300(False), LONGEST_SECONDS,
                   main_path=False)
    with_aux, _ = run("300 s full context, the forward with the aux heads",
                      lambda: forward300(True), LONGEST_SECONDS,
                      main_path=False)
    same = torch.equal(alone, with_aux)
    print(f"[long] 300 s: audio of the forward alone bit-identical to the "
          f"aux-on forward's: {same}")
    assert same, "the audio-only forward changed the audio"
    del alone, with_aux, x300
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


@contextlib.contextmanager
def depthwise_conv_mode():
    """The depthwise module's ``BWD_MODE = "conv"`` (dx by the library
    convolution, dw and db by K6), as the JAX module's constant is set."""
    from sepreformer_torch.ops.kernels import depthwise

    saved = depthwise.BWD_MODE
    depthwise.BWD_MODE = "conv"
    try:
        yield
    finally:
        depthwise.BWD_MODE = saved


@contextlib.contextmanager
def k13_without_bias(torch):
    """A control of the K13/K14 route: the rel-pos table zeroed inside the
    graph (its gradient still flows, as zeros)."""
    from sepreformer_torch.models import blocks

    route = blocks.flash_relpos_attention_train
    blocks.flash_relpos_attention_train = (
        lambda q, k, v, table, *args: route(q, k, v, table * 0.0, *args))
    try:
        yield
    finally:
        blocks.flash_relpos_attention_train = route


def routes_phase(torch, np, sep_torch, K, busy_us, steps=6):
    """The JAX package's other routes at Base width: training on
    ``attention_train_impl="pallas"`` and ``BWD_MODE = "conv"`` (K13, K14,
    K6), ``steps`` pairs of steps in turns with the default route, card
    against CPU on them, serving on ``attention_impl="single"`` (K13),
    and one epoch through ``cli.main`` with ``--set``.  Returns the
    kernels' launches over the main-path runs."""
    import dataclasses

    from sepreformer_torch.config import apply_override
    from sepreformer_torch.engine import (
        LRController,
        create_train_state,
        train_step,
    )

    total = defaultdict(int)
    base = sep_torch.get_variant("SepReformer_Base_WSJ0")
    cfg = apply_override(base, "model.attention_train_impl", "pallas")
    states = {label: create_train_state(
        variant, device="cuda", generator=torch.Generator().manual_seed(0))
        for label, variant in (("pallas/conv", cfg), ("default", base))}
    model = states["pallas/conv"].model
    attentions = sum(type(m).__name__ == "EGA" for m in model.modules())
    clas = sum(type(m).__name__ == "CLA" for m in model.modules())
    assert attentions == clas == 22
    o = cfg.optim
    lrc = LRController(o.lr, o.warmup_steps, o.plateau_factor,
                       o.plateau_patience, o.plateau_min_lr)
    rng = np.random.default_rng(13)
    batch = tuple(a.cuda() for a in synthetic_batch(
        torch, np, rng, cfg.dataset.batch_size, cfg.dataset.max_len))
    gens = {label: torch.Generator().manual_seed(14) for label in states}
    route_kernels = ("attention_train_fwd", "attention_train_bwd",
                     "depthwise_bwd_w")
    absent = ("materialize_pos_kt", "depthwise_bwd", "softmax_pv_train_fwd",
              "softmax_pv_train_bwd", "softmax_pv", "flash_relpos_attention")

    def step(label):
        """One train step of ``label``'s state on the host clock, the
        counts at 0 just before and read just after, and its peak."""
        mode = (depthwise_conv_mode() if label == "pallas/conv"
                else contextlib.nullcontext())
        with mode:
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(states[label], *batch, lrc.lr, 0.4,
                                 gens[label])
            values = {k: float(v) for k, v in metrics.items()}  # waits
            dt = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        assert all(np.isfinite(v) for v in values.values()), (label, values)
        if label == "pallas/conv":
            for name, n in counts.items():
                total[name] += n
            for name in route_kernels:
                assert counts[name] == 22, (name, counts[name])
            stray = [n for n in absent if counts[n]]
            assert not stray, f"kernels off these routes launched: {stray}"
        return dt, torch.cuda.max_memory_allocated(), values

    # a. train steps of the "pallas" attention and the "conv" backward
    # (K13, K14, K6), in turns with the default route's on the same batch
    lrc.warmup_step()
    times = defaultdict(list)
    for label in ("pallas/conv", "default"):
        dt, _, values = step(label)
        print(f"[routes] {label} first train step: {dt:.2f} ms, "
              + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    for i in range(steps):
        for label in (("pallas/conv", "default") if i % 2 == 0
                      else ("default", "pallas/conv")):
            dt, peak, values = step(label)
            times[label].append(dt)
    print(f"[routes] {attentions} global attentions, {clas} CLAs; each "
          f"pallas/conv step launched K13, K14 and K6 22 times and no K2, "
          f"K5, K9 or K10")
    batch_s = cfg.dataset.batch_size * TRAIN_SECONDS
    for label, ts in times.items():
        median = statistics.median(ts)
        print(f"[routes] {label} train steps in turns, ms: "
              f"{[round(t, 2) for t in ts]}; median {median:.2f} ms, "
              f"{batch_s / (median / 1e3):.2f} training audio-s/s")
    for label in states:
        dt, peak, _ = step(label)
        print(f"[routes] {label} step: max_memory_allocated "
              f"{peak / 2**30:.3f} GiB")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with depthwise_conv_mode():
        K.reset_launches()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            train_step(states["pallas/conv"], *batch, lrc.lr, 0.4,
                       gens["pallas/conv"])
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels, shapes = traced_kernels(prof)
    print_trace("routes", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "pallas/conv train step")
    print_k13_grids("routes", shapes, "pallas/conv train step")
    del states, model, batch
    torch.cuda.empty_cache()

    # b. one such step card against CPU, with two controls
    with depthwise_conv_mode():
        train_against_cpu(
            torch, np, sep_torch, "routes",
            dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, dropout=0.0)),
            {"control, TF32 allowed": lambda: tf32_allowed(torch),
             "control, K13/K14 without the rel-pos bias":
                 lambda: k13_without_bias(torch)})

    # c. a ragged batch served on "single" against the default route
    single_against_default(torch, np, sep_torch, K, busy_us, base, rng,
                           "routes", attentions, total)

    # d. one epoch through the CLI with --set, on phase 8's corpus
    for name, n in cli_pallas_epoch(torch, np, K, "SepReformer_Base_WSJ0",
                                    "routes").items():
        total[name] += n
    print(f"[routes] launches over the phase's main-path runs: {dict(total)}")
    return total


def single_against_default(torch, np, sep_torch, K, busy_us, base, rng, tag,
                           attentions, total):
    """A ragged B=4 x 4 s batch served on ``attention_impl="single"`` (K13
    in all ``attentions`` global attentions, no K2 or K3) and on ``base``'s
    default route, from the same seeded weights (every LayerScale at
    0.5): they must agree within phase 5's limit.  Then one such batch
    traced, with K13's launches by grid, head width and split.  The
    single route's launches are added to ``total``."""
    from sepreformer_torch.config import apply_override

    single = apply_override(base, "model.attention_impl", "single")
    seps = {}
    for label, variant in (("single", single), ("default", base)):
        m = sep_torch.build_model(variant.model, device="cuda",
                                  generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, prm in m.named_parameters():
                if name.endswith("layer_scale"):
                    prm.fill_(0.5)
        seps[label] = sep_torch.Separator(variant, m)
    lengths = [32000, 28000, 24000, 20000]
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.normal(size=n) * 0.1
    outs = {}
    for label in ("single", "default", "single"):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[label] = seps[label].separate(batch, lengths).cpu().numpy()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        print(f"[{tag}] batch B=4 x 4 s on the {label} route: "
              f"{dt * 1e3:.2f} ms; launches "
              f"{ {n: c for n, c in counts.items() if c} }")
        if label == "single":
            assert counts["attention_train_fwd"] == attentions
            assert counts["materialize_pos_kt"] == counts["softmax_pv"] == 0
    for name, n in counts.items():
        total[name] += n
    assert np.isfinite(outs["single"]).all()
    scale = max(float(np.abs(outs["default"][:, i, :n]).max())
                for i, n in enumerate(lengths))
    err = max(float(np.abs(outs["single"][:, i, :n]
                           - outs["default"][:, i, :n]).max())
              for i, n in enumerate(lengths)) / scale
    print(f"[{tag}] single against the default route: max |d| / max|out| "
          f"{err:.3e} (max|out| {scale:.3f}), limit {CPU_REL_LIMIT:.1e}")
    assert err <= CPU_REL_LIMIT, "the single route disagrees"
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    K.reset_launches()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        seps["single"].separate(batch, lengths)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels, shapes = traced_kernels(prof)
    print_trace(tag, kernels, busy_us(kernels), window_us,
                K.launch_counts(), "single served batch")
    print_k13_grids(tag, shapes, "single served batch")
    del seps
    torch.cuda.empty_cache()


def cli_pallas_epoch(torch, np, K, model, tag):
    """One epoch of ``model`` through ``cli.main`` with ``--set
    model.attention_train_impl=pallas`` on phase 8's synthetic corpus:
    the train and valid losses finite, K13 and K14 launched and K9 not.
    Returns the launches."""
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.data.synth import generate_corpus

    with tempfile.TemporaryDirectory() as tmp, engine_log() as lines:
        generate_corpus(os.path.join(tmp, "corpus"), n_train=16, n_valid=4,
                        n_test=4, seed=0)
        args = ["--model", model, "--scp-root",
                os.path.join(tmp, "corpus"), "--scp-dir", "scp",
                "--workdir", os.path.join(tmp, "work"), "--batch-size", "2",
                "--max-epoch", "2", "--set", "engine.test_epochs=",
                "--set", "model.attention_train_impl=pallas"]
        K.reset_launches()
        t0 = time.perf_counter()
        assert cli.main(args) == 0
        counts = K.launch_counts()
        print(f"[{tag}] cli.main --model {model}, one epoch on the pallas "
              f"route: {time.perf_counter() - t0:.2f} s; launches {counts}")
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(epochs) == 1, epochs
    print(f"[{tag}] log: {epochs[0]}")
    assert all(np.isfinite(epoch_losses(epochs[0]))), epochs[0]
    assert counts["attention_train_fwd"] == counts["attention_train_bwd"] > 0
    assert counts["softmax_pv_train_fwd"] == 0
    return counts


def seeded_model(torch, sep_torch, variant, seed=0, device="cuda"):
    """``variant``'s model at full width from ``seed``, every LayerScale
    at 0.5 and every BatchNorm's running statistics drawn from a second
    seed (so that the branches carry signal and K15's folded BatchNorm is
    not near the identity), on ``device``."""
    from sepreformer_torch.models.blocks import BatchNorm

    model = sep_torch.build_model(
        variant.model, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 15)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.running_mean.copy_(
                    torch.randn(mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.to(device)


@contextlib.contextmanager
def relu_masks(torch, masks, replay=False):
    """``torch.relu`` recording each call's mask (t > 0) into ``masks``,
    in call order; with ``replay``, each call takes the recorded mask in
    place of its own (t * mask: the value of relu(t) wherever the masks
    agree, and its gradient)."""
    real = torch.relu
    recorded = iter(list(masks))

    def relu(t):
        if replay:
            return t * next(recorded).to(t.dtype)
        masks.append(t > 0)
        return real(t)

    torch.relu = relu
    try:
        yield
    finally:
        torch.relu = real


def fused_expected(variant, frames, gcfns, train_p=None):
    """Launches of K15, K16 and K1 per forward of ``frames`` padded frames
    without lengths on the fused routes, by ``blocks.fused_route``: five
    blocks of each kind at every scale (two in the encoder stage, three
    in the decoder stage) and two at the bottleneck."""
    from sepreformer_torch.models import blocks

    r = variant.model.num_stages
    local = pair = 0
    for scale, n in [(s, 5) for s in range(r)] + [(r, 2)]:
        l_ok, p_ok = (blocks.fused_route("on", frames >> scale, train_p,
                                         False, train_ok)
                      for train_ok in (False, True))
        local, pair = local + n * l_ok, pair + n * p_ok
    return {"fused_cla": local, "fused_ega_tail_gcfn": pair,
            "fused_gcfn": gcfns - pair}


def fused_phase(torch, np, sep_torch, K, busy_us, kernel_events, iters=10,
                model_name="SepReformer_Base_WSJ0", tag="fused",
                base_only=True):
    """The fused eval blocks of ``model_name`` at full width against the
    default route: requests and a batch without lengths (agreement,
    launches against the rule, a TF32 control), a ragged batch with
    lengths, wall times in turns and one traced forward per route, 300 s
    in 8 s chunks (``base_only``) and 70 s in full context, a train step
    at dropout 0 (then steps of both routes in turns, ``base_only``) and
    one at the preset's dropout, and ``infer_sample`` through ``cli.main``
    with ``--set``.  Prints under ``[tag]``.  Returns the kernels'
    launches over the fused route's main-path runs."""
    import dataclasses
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.config import apply_override
    from sepreformer_torch.data.audio import read_wav, write_wav
    from sepreformer_torch.engine import create_train_state, train_step

    base = sep_torch.get_variant(model_name)
    fused = apply_override(apply_override(base, "model.fused_local", "on"),
                           "model.fused_pair", "on")
    seps = {"fused": sep_torch.Separator(fused, seeded_model(
                torch, sep_torch, fused)),
            "default": sep_torch.Separator(base, seeded_model(
                torch, sep_torch, base))}
    model = seps["fused"].model
    gcfns = sum(type(m).__name__ == "GCFN" for m in model.modules())
    attentions = sum(type(m).__name__ == "EGA" for m in model.modules())
    mc = base.model
    rng = np.random.default_rng(16)
    total = defaultdict(int)

    def frames_of(samples):
        return mc.padded_frames((samples - mc.enc_kernel) // mc.enc_stride
                                + 1)

    def run(label, fn, seconds=None, main_path=True):
        """``fn()`` with every count at 0 just before and read just after;
        host-clock wall, peak memory."""
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
        rate = "" if seconds is None else f", {seconds / dt:.2f} audio-s/s"
        print(f"[{tag}] {label}: {dt * 1e3:.2f} ms wall{rate}, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
              f"{ {n: c for n, c in counts.items() if c} }")
        return out, counts, dt

    def check_counts(counts, frames, label):
        want = fused_expected(base, frames, gcfns)
        got = {n: counts[n] for n in want}
        assert got == want, (label, got, want)

    def agreement(label, a, b, scale=None):
        scale = float(np.abs(b).max()) if scale is None else scale
        err = float(np.abs(a - b).max()) / scale
        print(f"[{tag}] {label}: max |fused - default| / max|out| "
              f"{err:.3e} (max|out| {scale:.3f}), limit {CPU_REL_LIMIT:.1e}")
        return err

    # a, b. requests and a batch without lengths, against the default route
    batch = (rng.normal(size=(4, int(TRAIN_SECONDS * SAMPLE_RATE)))
             * 0.1).astype(np.float32)
    for label in seps:                                     # warm both
        seps[label].separate(batch)
    cases = [(f"request {sec:.1f} s", (rng.normal(size=(
        1, int(sec * SAMPLE_RATE))) * 0.1).astype(np.float32))
        for sec in (2.0, 3.3, 4.0)] + [("batch B=4 x 4 s", batch)]
    for label, wav in cases:
        seconds = wav.size / SAMPLE_RATE
        outs = {}
        for route in ("fused", "default"):
            out, counts, _ = run(f"{label}, {route} route",
                                 lambda: seps[route].separate(wav),
                                 seconds, main_path=route == "fused")
            outs[route] = out.cpu().numpy()
            assert np.isfinite(outs[route]).all(), (label, route)
            if route == "fused":
                frames = frames_of(wav.shape[1])
                check_counts(counts, frames, label)
                print(f"[{tag}] {label}: {frames} frames, stage lengths "
                      f"{[frames >> s for s in range(mc.num_stages + 1)]}; "
                      f"launches match the rule")
        err = agreement(label, outs["fused"], outs["default"])
        assert err <= CPU_REL_LIMIT, f"the fused route disagrees: {label}"
    with tf32_allowed(torch):
        control = seps["fused"].separate(batch).cpu().numpy()
    err = agreement("batch, control: fused route with TF32 allowed", control,
                    outs["default"])
    assert err > CPU_REL_LIMIT, "the limit does not catch TF32 products"

    lengths = [32000, 28000, 24000, 20000]
    ragged = np.zeros_like(batch)
    for i, n in enumerate(lengths):
        ragged[i, :n] = batch[i, :n]
    outs = {}
    for route in ("fused", "default"):
        out, counts, _ = run(f"ragged batch with lengths {lengths}, {route} "
                             f"route", lambda: seps[route].separate(
                                 ragged, lengths), main_path=False)
        outs[route] = out.cpu().numpy()
        if route == "fused":
            assert counts["fused_cla"] == 0, counts
            assert counts["fused_ega_tail_gcfn"] == 0, counts
    assert agreement("ragged batch", outs["fused"],
                     outs["default"]) <= CPU_REL_LIMIT

    # c. the batch's wall times in turns, then one traced forward per route
    x = torch.from_numpy(batch).cuda()

    def forward(route):
        with torch.inference_mode():
            return seps[route].model(x)

    walls = defaultdict(list)
    for i in range(iters):
        for route in (("fused", "default") if i % 2 == 0
                      else ("default", "fused")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(route)
            torch.cuda.synchronize()
            walls[route].append((time.perf_counter() - t0) * 1e3)
    for route, ts in walls.items():
        median = statistics.median(ts)
        print(f"[{tag}] batch B=4 x 4 s, no lengths, {route} route, in "
              f"turns, ms: {[round(t, 2) for t in ts]}; median "
              f"{median:.2f} ms, {16.0 / (median / 1e3):.2f} audio-s/s")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for route in ("fused", "default"):
        K.reset_launches()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            forward(route)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        if route == "fused":
            for name, n in K.launch_counts().items():
                total[name] += n
        kernels = kernel_events(prof)
        print_trace(tag, kernels, busy_us(kernels), window_us,
                    K.launch_counts(), f"B=4 x 4 s forward, {route} route")

    # d. 300 s in 8 s chunks (Base), and 70 s in full context without
    # lengths
    if base_only:
        n300 = int(LONGEST_SECONDS * SAMPLE_RATE)
        wav300 = (rng.normal(size=n300) * 0.1).astype(np.float32)
        chunked = {route: sep_torch.Separator(sep.variant, sep.model,
                                              chunk_seconds=CHUNK_SECONDS)
                   for route, sep in seps.items()}
        outs = {}
        for route in ("fused", "default", "fused", "default"):
            out, counts, _ = run(f"300 s in {CHUNK_SECONDS:.0f} s chunks, "
                                 f"{route} route",
                                 lambda: np.stack(chunked[route](wav300)),
                                 LONGEST_SECONDS, main_path=route == "fused")
            outs[route] = out
            if route == "fused":
                assert counts["fused_cla"] > 0
                assert counts["fused_ega_tail_gcfn"] > 0
        assert agreement("300 s in chunks", outs["fused"],
                         outs["default"]) <= CPU_REL_LIMIT
        del chunked, outs, wav300
    n70 = int(LONG_SECONDS * SAMPLE_RATE)
    wav70 = (np.random.default_rng(9).normal(size=n70) * 0.1).astype(
        np.float32)
    outs = {}
    for route in ("fused", "default", "fused", "default"):
        out, counts, _ = run(f"70 s full context, no lengths, {route} route",
                             lambda: seps[route].separate(wav70[None]),
                             LONG_SECONDS, main_path=route == "fused")
        outs[route] = out.cpu().numpy()
        assert counts["flash_relpos_attention"] == attentions
        if route == "fused":
            check_counts(counts, frames_of(n70), "70 s")
    assert agreement("70 s full context", outs["fused"],
                     outs["default"]) <= CPU_REL_LIMIT
    del outs, seps, model
    torch.cuda.empty_cache()

    # e. a train step at dropout 0 on the pair route against the default,
    # then (Base) steps of both in turns
    train_cfgs = {label: dataclasses.replace(v, model=dataclasses.replace(
        v.model, dropout=0.0)) for label, v in (("fused", fused),
                                               ("default", base))}
    mix, src = (a.cuda() for a in synthetic_batch(
        torch, np, np.random.default_rng(17), base.dataset.batch_size,
        base.dataset.max_len))
    step_frames = frames_of(base.dataset.max_len)
    pair_steps = fused_expected(base, step_frames, gcfns, train_p=0.0)
    # the same seeded weights; the model's blocks read the route
    states = {label: create_train_state(cfg, model=seeded_model(
        torch, sep_torch, cfg)) for label, cfg in train_cfgs.items()}
    # and the fused route again, taking the default route's ReLU masks
    states["pinned"] = create_train_state(
        train_cfgs["fused"], model=seeded_model(torch, sep_torch,
                                                train_cfgs["fused"]))
    names = {"fused": "fused route", "default": "default route",
             "pinned": "fused route with the default route's ReLU masks"}
    results, masks = {}, defaultdict(list)
    for label, state in states.items():
        replay = label == "pinned"
        with relu_masks(torch, masks["default" if replay else label],
                        replay):
            metrics, counts, _ = run(
                f"train step at dropout 0, {names[label]} (its first)",
                lambda: train_step(state, mix, src, 1e-3, 0.4,
                                   torch.Generator().manual_seed(18)),
                main_path=label == "fused")
        results[label] = (float(metrics["total_loss"]), {
            n: p.grad.detach().clone()
            for n, p in state.model.named_parameters()})
        if label != "default":
            assert (counts["fused_ega_tail_gcfn"]
                    == pair_steps["fused_ega_tail_gcfn"] == attentions), (
                counts, pair_steps)
            assert counts["fused_cla"] == 0, counts
    del states["pinned"]
    flips = [int((a != b).sum()) for a, b in zip(masks["fused"],
                                                 masks["default"])]
    ref_loss, ref_grads = results["default"]
    scale = max(g.abs().max().item() for g in ref_grads.values())
    errs = {}
    for label in ("fused", "pinned"):
        loss, grads = results[label]
        worst = max(grads,
                    key=lambda n: (grads[n] - ref_grads[n]).abs().max())
        errs[label] = (grads[worst] - ref_grads[worst]).abs().max().item()
        errs[label] /= scale
        print(f"[{tag}] train step at dropout 0, {names[label]}: loss "
              f"{loss:.6f} against {ref_loss:.6f}; max |fused - default| "
              f"over every "
              f"gradient / max |gradient| {errs[label]:.3e} (max "
              f"{scale:.3e}, worst {worst}), limit "
              f"{TRAIN_CPU_REL_LIMIT:.1e}")
        assert abs(loss - ref_loss) <= TRAIN_CPU_REL_LIMIT * abs(ref_loss)
    # The aux heads' ReLU masks (relu(y) * enc) are where the two routes'
    # rounding can take different pieces of the piecewise-linear loss: an
    # element whose pre-activation lies within rounding of 0 flips, and
    # its whole term enters or leaves a bias gradient's sum (relu_flips.py
    # measures it).  The fused route with the default's masks takes the
    # same piece, so its reading is the routes' own difference; it must
    # pass at every width, and Base's phase 11 also holds the unpinned
    # step to the limit.
    print(f"[{tag}] train step at dropout 0: ReLU sign flips, fused "
          f"against default route, per relu call {flips}")
    assert errs["pinned"] <= TRAIN_CPU_REL_LIMIT, (
        "the pair route's gradients disagree")
    if base_only:
        assert errs["fused"] <= TRAIN_CPU_REL_LIMIT, (
            "the pair route's gradients disagree")
    del results, grads, ref_grads, masks
    steps = defaultdict(list)
    for i in range(4 if base_only else 0):
        for label in (("fused", "default") if i % 2 == 0
                      else ("default", "fused")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(states[label], mix, src, 1e-3, 0.4,
                                 torch.Generator().manual_seed(18))
            assert np.isfinite(float(metrics["total_loss"]))   # waits
            steps[label].append((time.perf_counter() - t0) * 1e3)
    for label, ts in steps.items():
        print(f"[{tag}] train steps at dropout 0 in turns, {label} route, "
              f"ms: {[round(t, 2) for t in ts]}; median "
              f"{statistics.median(ts):.2f} ms")
    del states
    torch.cuda.empty_cache()
    state = create_train_state(fused, model=seeded_model(torch, sep_torch,
                                                         fused))
    _, counts, _ = run(f"train step at dropout {mc.dropout}, fused settings",
                       lambda: train_step(state, mix, src, 1e-3, 0.4,
                                          torch.Generator().manual_seed(19)),
                       main_path=False)
    assert counts["fused_ega_tail_gcfn"] == counts["fused_cla"] == 0, counts
    del state
    torch.cuda.empty_cache()

    # f. infer_sample of phase 9's 70 s wav through the CLI, with --set
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "long70.wav")
        write_wav(path, wav70, SAMPLE_RATE)
        out_dir = os.path.join(tmp, "out")
        args = ["--model", model_name, "--engine-mode",
                "infer_sample", "--sample-file", path, "--workdir",
                os.path.join(tmp, "work"), "--out-wav-dir", out_dir,
                "--set", "model.fused_local=on",
                "--set", "model.fused_pair=on"]
        status, counts, _ = run("cli infer_sample, 70 s wav, --set "
                                "model.fused_local=on model.fused_pair=on "
                                "(with the model's set-up)",
                                lambda: cli.main(args), LONG_SECONDS)
        assert status == 0
        check_counts(counts, frames_of(n70), "infer_sample")
        for i in range(2):
            y, rate = read_wav(os.path.join(out_dir, f"long70_out_{i}.wav"))
            assert rate == SAMPLE_RATE and y.shape == (n70,), y.shape
            assert np.isfinite(y).all() and np.abs(y).max() > 0.5
    print(f"[{tag}] launches over the phase's main-path runs: {dict(total)}")
    return total


LARGE = "SepReformer_Large_DM_WSJ0"


def large_phase(torch, np, sep_torch, K, busy_us, kernel_events):
    """Phase 12: the Large family served at full width (F 256, 8 heads of
    32, 4 stages, enc_dim 256), seeded weights, every LayerScale at 0.5,
    through the entry points: card against CPU on 1 s; a ragged B=4 x 4 s
    batch through ``Separator.separate`` (wall times, one traced forward,
    launches, peak memory); 70 s in full context (K12 at head width 32)
    against the dense K2/K3 route with two controls; 300 s in 8 s chunks;
    one ``Large_DM_WHAM`` request (a speaker-split block per stage) card
    against CPU; ``infer_sample`` of the 70 s wav through ``cli.main
    --model SepReformer_Large_DM_WSJ0``; then Large trained
    (``large_train``); then Large on the fused block routes
    (``fused_phase``: K15 and K16 at F 256).  Returns the kernels'
    launches over the runs of the main path."""
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.data.audio import read_wav, write_wav
    from sepreformer_torch.models import blocks

    t0 = time.perf_counter()
    sep = sep_torch.load_separator(LARGE, device="cuda", seed=0)
    model, variant = layer_scales_at(torch, sep.model), sep.variant
    cfg = variant.model
    assert (cfg.feat_dim, cfg.num_heads, cfg.head_dim, cfg.num_stages,
            cfg.enc_dim) == (256, 8, 32, 4, 256)
    print(f"[large] {LARGE} built in {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters: F "
          f"{cfg.feat_dim}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{cfg.num_stages} stages, enc_dim {cfg.enc_dim}")
    gcfns = sum(type(m).__name__ == "GCFN" for m in model.modules())
    attentions = sum(type(m).__name__ == "EGA" for m in model.modules())
    rng = np.random.default_rng(12)
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
        print(f"[large] {label}: {dt:.3f} s wall, {seconds / dt:.2f} "
              f"audio-s/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {ours}")
        return out, counts

    def separated(separator, wav):
        out = np.stack(separator(wav))
        assert out.shape == (2, len(wav)), out.shape
        assert np.isfinite(out).all(), "non-finite audio"
        return out

    # a. a 1 s request on the card against the CPU, with a TF32 control
    wav1 = (rng.normal(size=SAMPLE_RATE) * 0.1).astype(np.float32)
    card_against_cpu(torch, np, sep_torch, variant, model, wav1, "large")

    # b. a ragged B=4 x 4 s batch through Separator.separate: K1 in every
    #    GCFN, K2 once, K3 in every global attention
    lengths = [32000, 28000, 24000, 20000]
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.normal(size=n) * 0.1
    seconds = sum(lengths) / SAMPLE_RATE
    sep.separate(batch, lengths)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sep.separate(batch, lengths)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[large] batch B=4 x 4 s (lengths {lengths}) over 5 forwards, ms: "
          f"{[round(t, 2) for t in walls]}; "
          f"{seconds / (statistics.median(walls) / 1e3):.2f} audio-s/s at "
          f"the median")
    audio, counts = run("batch B=4 x 4 s", lambda: sep.separate(batch,
                                                                  lengths),
                        seconds)
    assert tuple(audio.shape) == (2, 4, 32000), tuple(audio.shape)
    assert torch.isfinite(audio).all().item(), "non-finite batched audio"
    assert counts["fused_gcfn"] == gcfns == 56, (counts, gcfns)
    assert counts["materialize_pos_kt"] == 1
    assert counts["softmax_pv"] == attentions == 22
    assert counts["flash_relpos_attention"] == 0
    del audio
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    K.reset_launches()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sep.separate(batch, lengths)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels = kernel_events(prof)
    print_trace("large", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "B=4 x 4 s forward")

    # c. 70 s in full context: K12 at head width 32 in every global
    #    attention, no pos_kt; against the dense K2/K3 route (switch
    #    raised), with controls that the limit must catch: TF32 allowed
    #    (the cuBLAS and cuDNN products), and K12 without the rel-pos bias
    n70 = int(LONG_SECONDS * SAMPLE_RATE)
    wav70 = (rng.normal(size=n70) * 0.1).astype(np.float32)
    for label in ("70 s full context, K12 route (first call)",
                  "70 s full context, K12 route"):
        flash, counts = run(label, lambda: separated(sep, wav70),
                            LONG_SECONDS)
        assert counts["flash_relpos_attention"] == attentions
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
    assert counts["softmax_pv"] == attentions
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
    k12_route = blocks.flash_relpos_attention
    blocks.flash_relpos_attention = (
        lambda q, k, v, table, maxlen, lens: K.flash_relpos_attention(
            q, k, v, torch.zeros_like(table), maxlen, lens))
    try:
        control, counts = run("70 s full context, control, K12 without the "
                              "bias", lambda: separated(sep, wav70),
                              LONG_SECONDS, main_path=False)
    finally:
        blocks.flash_relpos_attention = k12_route
    assert counts["flash_relpos_attention"] == attentions
    errs["control, K12 without the bias"] = float(
        np.abs(control - dense).max()) / scale
    for label, e in errs.items():
        print(f"[large] K12 route against the dense route, {label}: max |d| "
              f"/ max|out| {e:.3e} (max|out| {scale:.3f}), limit "
              f"{CPU_REL_LIMIT:.1e}")
    assert errs["float32"] <= CPU_REL_LIMIT, "K12 route disagrees"
    for label, e in errs.items():
        assert label == "float32" or e > CPU_REL_LIMIT, (
            f"the limit does not catch the {label}")
    del flash, dense, control

    # d. 300 s in 8 s chunks: K1, K2 and K3, no K12
    n300 = int(LONGEST_SECONDS * SAMPLE_RATE)
    wav300 = (rng.normal(size=n300) * 0.1).astype(np.float32)
    chunked = sep_torch.Separator(variant, model, chunk_seconds=CHUNK_SECONDS)
    _, counts = run(f"300 s in {CHUNK_SECONDS:.0f} s chunks",
                    lambda: separated(chunked, wav300), LONGEST_SECONDS)
    assert counts["flash_relpos_attention"] == 0
    assert min(counts["fused_gcfn"], counts["materialize_pos_kt"],
               counts["softmax_pv"]) > 0
    del sep, chunked, model
    torch.cuda.empty_cache()

    # e. Large_DM_WHAM: one speaker-split block per stage, card against CPU
    wham = sep_torch.load_separator("SepReformer_Large_DM_WHAM",
                                    device="cuda", seed=1)
    splits = wham.model.separator.spk_split_block
    assert wham.variant.model.per_stage_spk_split
    assert len(splits) == wham.variant.model.num_stages + 1
    print(f"[large] SepReformer_Large_DM_WHAM: {len(splits)} speaker-split "
          f"blocks, {sum(p.numel() for p in wham.model.parameters())} "
          f"parameters")
    _, counts = run("SepReformer_Large_DM_WHAM, one 1 s request",
                    lambda: separated(wham, wav1), 1.0)
    assert min(counts["fused_gcfn"], counts["materialize_pos_kt"],
               counts["softmax_pv"]) > 0
    card_against_cpu(torch, np, sep_torch, wham.variant,
                     layer_scales_at(torch, wham.model), wav1, "large WHAM")
    del wham
    torch.cuda.empty_cache()

    # f. the 70 s request as a wav through the CLI, in full context
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "long70.wav")
        write_wav(path, wav70, SAMPLE_RATE)
        out_dir = os.path.join(tmp, "out")
        args = ["--model", LARGE, "--engine-mode", "infer_sample",
                "--sample-file", path, "--workdir",
                os.path.join(tmp, "work"), "--out-wav-dir", out_dir]
        status, counts = run("cli infer_sample, 70 s wav (with the model's "
                             "set-up)", lambda: cli.main(args), LONG_SECONDS)
        assert status == 0
        assert counts["flash_relpos_attention"] == attentions
        for i in range(2):
            x, rate = read_wav(os.path.join(out_dir, f"long70_out_{i}.wav"))
            assert rate == SAMPLE_RATE and x.shape == (n70,), x.shape
            assert np.isfinite(x).all() and np.abs(x).max() > 0.5

    # g. Large training on the default route, through the entry points
    large_train(torch, np, sep_torch, K, variant, busy_us, kernel_events,
                run, total, gcfns, attentions)
    torch.cuda.empty_cache()
    # h. Large served on the fused block routes (K15, K16 at F 256), and
    # a dropout-0 step on the pair route
    for name, n in fused_phase(torch, np, sep_torch, K, busy_us,
                               kernel_events, model_name=LARGE,
                               tag="large fused", base_only=False).items():
        total[name] += n
    torch.cuda.empty_cache()
    print(f"[large] launches over the phase's main-path runs: {dict(total)}")
    return total


def large_train(torch, np, sep_torch, K, variant, busy_us, kernel_events,
                run, total, gcfns, attentions, steps=6):
    """Phase 12's training: ``steps`` Large train steps on seeded B=2 x 4 s
    batches (the launches of every step: one K7 and one K8 a GCFN, one K9
    and one K10 a global attention, one K5 a CLA, K2 and K11 once, no eval
    kernel; the losses finite, the parameters and the BatchNorm statistics
    moving), one traced step, one step card against CPU (phase 7's limit,
    a TF32 control), one train-mode GCFN of F 256 at dropout 0.1 card
    against CPU, one ``SepReformer_Large_DM_WHAM`` step (a speaker-split
    block per stage), two CLI epochs of ``LARGE`` on phase 8's corpus with
    a resumed third and a test, and then the "pallas" and "single" routes
    (``large_pallas``).  ``run`` and ``total`` are the phase's: counts at
    0 before each run, main-path launches summed."""
    import dataclasses

    from sepreformer_torch.engine import (
        LRController,
        create_train_state,
        train_step,
    )

    t0 = time.perf_counter()
    state = create_train_state(variant, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    model, o = state.model, variant.optim
    clas = sum(type(m).__name__ == "CLA" for m in model.modules())
    print(f"[large] train state built in {time.perf_counter() - t0:.2f} s; "
          f"batch {variant.dataset.batch_size} x {variant.dataset.max_len} "
          f"samples, dropout {variant.model.dropout}, lr {o.lr}, dynamic "
          f"mixing {variant.dataset.dynamic_mixing}; {gcfns} GCFNs, "
          f"{attentions} global attentions, {clas} CLAs")
    lrc = LRController(o.lr, o.warmup_steps, o.plateau_factor,
                       o.plateau_patience, o.plateau_min_lr)
    rng = np.random.default_rng(20)
    batches = [tuple(a.cuda() for a in synthetic_batch(
        torch, np, rng, variant.dataset.batch_size, variant.dataset.max_len))
        for _ in range(steps + 1)]
    watched = {name: p.detach().clone() for name, p in
               model.named_parameters() if name.endswith(
                   ("pe_k.weight", "dw_conv_1d.weight", "linear_q.weight",
                    "net1.1.weight"))}
    watched.update({name: b.clone() for name, b in model.named_buffers()
                    if name.endswith(("running_mean", "running_var"))})
    gen = torch.Generator().manual_seed(1)
    expected = {"gcfn_train_fwd": gcfns, "gcfn_train_bwd": gcfns,
                "softmax_pv_train_fwd": attentions,
                "softmax_pv_train_bwd": attentions, "depthwise_bwd": clas,
                "materialize_pos_kt": 1, "sisnr_pairwise_neg_fused": 1}
    torch.cuda.reset_peak_memory_stats()
    times = timed_train_steps(torch, np, K, state, lrc, batches[:steps], gen,
                              expected, total, "large")
    now = dict(model.named_parameters())
    now.update(model.named_buffers())
    frozen = [n for n, before in watched.items()
              if torch.equal(before, now[n].detach())]
    assert not frozen, f"unchanged by training: {frozen}"
    median = statistics.median(times[1:])
    batch_s = variant.dataset.batch_size * TRAIN_SECONDS
    print(f"[large] train step ms after the first: "
          f"{[round(t, 2) for t in times[1:]]}; median {median:.2f} ms, "
          f"{batch_s / (median / 1e3):.2f} training audio-s/s; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"per step {expected}")

    mix, src = batches[steps]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_step(state, mix, src, lrc.lr, 0.4, gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels = kernel_events(prof)
    print_trace("large", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "Large train step")
    by_group = group_kernels(kernels)[0]
    print(f"[large] traced train step: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; K8's share "
          f"of busy time {by_group['K8 gcfn_train_bwd'] / busy_us(kernels):.3f}")
    del state, model, batches, watched, now, prof
    torch.cuda.empty_cache()

    # the step card against CPU at dropout 0, and a GCFN of F 256 at 0.1
    cfg = dataclasses.replace(variant, model=dataclasses.replace(
        variant.model, dropout=0.0))
    train_against_cpu(torch, np, sep_torch, "large", cfg, {
        "control, TF32 allowed": lambda: tf32_allowed(torch)})
    gcfn_train_cpu(torch, np, f=256, p=variant.model.dropout, tag="large")

    # one Large_DM_WHAM step: a speaker-split block per stage
    wham = sep_torch.get_variant("SepReformer_Large_DM_WHAM")
    state = create_train_state(wham, device="cuda",
                               generator=torch.Generator().manual_seed(2))
    splits = len(state.model.separator.spk_split_block)
    mix, src = (a.cuda() for a in synthetic_batch(
        torch, np, rng, wham.dataset.batch_size, wham.dataset.max_len))
    metrics, counts = run(
        "SepReformer_Large_DM_WHAM train step", lambda: {
            k: float(v) for k, v in train_step(
                state, mix, src, wham.optim.lr, 0.4, gen).items()},
        TRAIN_SECONDS * wham.dataset.batch_size)
    print(f"[large] SepReformer_Large_DM_WHAM step ({splits} speaker-split "
          f"blocks): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   metrics.items()))
    assert splits == wham.model.num_stages + 1
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    got = {n: counts[n] for n in expected}
    assert got == expected, (got, expected)
    split_grads = [p.grad for n, p in state.model.named_parameters()
                   if n.startswith("separator.spk_split_block.")]
    assert all(g is not None and torch.isfinite(g).all() for g in
               split_grads), "a split block without a finite gradient"
    del state
    torch.cuda.empty_cache()

    # the CLI: two epochs, a resumed third, a test, on phase 8's corpus
    counts = engine_phase(torch, np, K, model=LARGE, tag="large cli")
    for name, n in counts.items():
        total[name] += n

    # the "pallas" and "single" routes at head width 32
    large_pallas(torch, np, sep_torch, K, variant, busy_us, total, gcfns,
                 attentions, clas)


def timed_train_steps(torch, np, K, state, lrc, batches, gen, expected,
                      total, tag):
    """A train step on each of ``batches`` (the lr from ``lrc``'s warmup,
    alpha 0.4) on the host clock, the counts at 0 just before each and
    read just after and added to ``total``: the losses finite, each
    step's launches of the kernels in ``expected`` as it says, no eval
    kernel.  Returns the step times in ms."""
    from sepreformer_torch.engine import train_step

    times = []
    torch.cuda.synchronize()
    for step, (mix, src) in enumerate(batches):
        lrc.warmup_step()
        K.reset_launches()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in train_step(     # waits
            state, mix, src, lrc.lr, 0.4, gen).items()}
        times.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        for name, n in counts.items():
            total[name] += n
        print(f"[{tag}] step {step}: {times[-1]:.2f} ms, lr {lrc.lr:.2e}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        got = {n: counts[n] for n in expected}
        assert got == expected, (got, expected)
        stray = [n for n in EVAL_ONLY_KERNELS if counts[n]]
        assert not stray, f"eval-only kernels on the train path: {stray}"
    return times


def large_pallas(torch, np, sep_torch, K, variant, busy_us, total, gcfns,
                 attentions, clas, steps=4):
    """Phase 12's "pallas" and "single" routes at Large's head width 32:
    ``steps`` Large train steps on seeded B=2 x 4 s batches at dropout 0.1
    on ``attention_train_impl="pallas"`` (each step one K13 and one K14 a
    global attention (22), one K7 and one K8 a GCFN, one K5 a CLA, one
    K11, and no K2, K9, K10 or eval kernel; host-clock step times, peak
    memory), one traced step (idle share, kernel time by group, K13's
    launches by grid, head width and split), one step card against CPU at
    dropout 0 (phase 7's limit; controls: TF32 allowed, K13/K14 without
    the rel-pos bias), one epoch of ``cli.main --model LARGE --set
    model.attention_train_impl=pallas`` on phase 8's corpus, and a ragged
    B=4 x 4 s batch served on ``attention_impl="single"`` against the
    default route (phase 5's limit).  The launches of the main-path runs
    are added to ``total``."""
    import dataclasses

    from sepreformer_torch.config import apply_override
    from sepreformer_torch.engine import (
        LRController,
        create_train_state,
        train_step,
    )

    cfg = apply_override(variant, "model.attention_train_impl", "pallas")
    state = create_train_state(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    o = cfg.optim
    lrc = LRController(o.lr, o.warmup_steps, o.plateau_factor,
                       o.plateau_patience, o.plateau_min_lr)
    rng = np.random.default_rng(21)
    batches = [tuple(a.cuda() for a in synthetic_batch(
        torch, np, rng, cfg.dataset.batch_size, cfg.dataset.max_len))
        for _ in range(steps + 1)]
    gen = torch.Generator().manual_seed(3)
    expected = {"attention_train_fwd": attentions,
                "attention_train_bwd": attentions, "gcfn_train_fwd": gcfns,
                "gcfn_train_bwd": gcfns, "depthwise_bwd": clas,
                "sisnr_pairwise_neg_fused": 1, "materialize_pos_kt": 0,
                "softmax_pv_train_fwd": 0, "softmax_pv_train_bwd": 0}
    torch.cuda.reset_peak_memory_stats()
    times = timed_train_steps(torch, np, K, state, lrc, batches[:steps], gen,
                              expected, total, "large pallas")
    median = statistics.median(times[1:])
    print(f"[large pallas] train step ms after the first: "
          f"{[round(t, 2) for t in times[1:]]}; median {median:.2f} ms, "
          f"{cfg.dataset.batch_size * TRAIN_SECONDS / (median / 1e3):.2f} "
          f"training audio-s/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"per step {expected}")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    K.reset_launches()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_step(state, *batches[steps], lrc.lr, 0.4, gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for name, n in K.launch_counts().items():
        total[name] += n
    kernels, shapes = traced_kernels(prof)
    print_trace("large pallas", kernels, busy_us(kernels), window_us,
                K.launch_counts(), "Large pallas train step")
    print_k13_grids("large pallas", shapes, "Large pallas train step")
    del state, batches, prof
    torch.cuda.empty_cache()

    train_against_cpu(
        torch, np, sep_torch, "large pallas",
        dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                           dropout=0.0)),
        {"control, TF32 allowed": lambda: tf32_allowed(torch),
         "control, K13/K14 without the rel-pos bias":
             lambda: k13_without_bias(torch)})
    for name, n in cli_pallas_epoch(torch, np, K, LARGE,
                                    "large pallas cli").items():
        total[name] += n
    single_against_default(torch, np, sep_torch, K, busy_us, variant, rng,
                           "large single", attentions, total)


BASE = "SepReformer_Base_WSJ0"
# the bfloat16 rows of phase 2, by the model that launches them
BF16_ROWS = {BASE: {"fused_gcfn": "fused_gcfn", "softmax_pv": "softmax_pv",
                    "flash_relpos_attention": "flash_relpos_attention"},
             LARGE: {"fused_gcfn": "fused_gcfn F=256",
                     "softmax_pv": "softmax_pv d=32",
                     "flash_relpos_attention": "flash_relpos_attention d=32"}}


def bf16_phase(torch, np, sep_torch, K, busy_us, kernel_events):
    """Phase 13: serving in bfloat16 (``model.compute_dtype="bfloat16"``),
    seeded weights, every LayerScale at 0.5, through the entry points.
    Base: a ragged B=4 x 4 s batch through ``Separator.separate`` (K1's
    and K3's bfloat16 instances in every GCFN and global attention, no
    float32 instance of either; forward hooks find every module's output
    bfloat16 but the rel-pos table's), card against the port on the CPU in
    bfloat16 and against float32 on the card, one traced forward of each
    dtype (busy, launches, kernel groups, peak memory); the batch with
    ``scores_dtype="bfloat16"``, and with bfloat16 scores under float32
    compute; 70 s in full context (K12's bfloat16 instance) against
    float32; 300 s in 8 s chunks; 300 s in full context, traced, with its
    peak memory; ``cli.main``'s ``infer_sample`` with ``--set
    model.compute_dtype=bfloat16``.  Large: the ragged batch (F 256,
    heads of 32) against float32, its modules' dtypes, traced, and 70 s
    in full context.  Then
    the refusals: ``train_step`` in bfloat16, and a bfloat16 tensor into
    K13, K15 and K16.  Returns the bfloat16 instances' launches over the
    main-path runs, by their phase-2 row names."""
    import tempfile

    from sepreformer_torch import cli
    from sepreformer_torch.config import apply_override
    from sepreformer_torch.data.audio import read_wav, write_wav
    from sepreformer_torch.engine import create_train_state, train_step

    rows = defaultdict(int)
    rng = np.random.default_rng(13)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]

    def variant_of(name, **fields):
        variant = sep_torch.get_variant(name)
        for key, value in fields.items():
            variant = apply_override(variant, f"model.{key}", value)
        return variant

    def seeded(variant):
        return layer_scales_at(torch, sep_torch.build_model(
            variant.model, device="cuda",
            generator=torch.Generator().manual_seed(0)))

    def run(label, fn, seconds, model_name=None):
        """``fn()`` with every count at 0 just before and read just after,
        on the host clock, with the peak memory of the call; with
        ``model_name`` a main-path run, whose bfloat16 launches count for
        that model's rows."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        if model_name:
            for name, n in counts.items():
                wrapper, _, instance = name.partition(" ")
                if instance:
                    rows[f"{BF16_ROWS[model_name][wrapper]} {instance}"] += n
        ours = {n: c for n, c in counts.items() if c}
        print(f"[bf16] {label}: {dt:.3f} s wall, {seconds / dt:.2f} "
              f"audio-s/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"launches {ours}")
        return out, counts

    def traced(label, fn, model_name=None):
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        counts = K.launch_counts()
        if model_name:
            for name, n in counts.items():
                wrapper, _, instance = name.partition(" ")
                if instance:
                    rows[f"{BF16_ROWS[model_name][wrapper]} {instance}"] += n
        kernels = kernel_events(prof)
        print_trace("bf16", kernels, busy_us(kernels), window_us,
                    {n: c for n, c in counts.items() if c}, label)
        print(f"[bf16] traced {label}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    def rel(a, b):
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        return ((a - b).abs().max() / b.abs().max()).item()

    def agree(label, a, b, limit):
        err = rel(a, b)
        print(f"[bf16] {label}: max |d| / max|out| {err:.3e}, limit "
              f"{limit:.1e}")
        assert 0 < err <= limit, f"{label}: {err:.3e}"

    def separated(separator, wav):
        out = np.stack(separator(wav))
        assert out.shape == (2, len(wav)), out.shape
        assert np.isfinite(out).all(), "non-finite audio"
        return out

    lengths = [32000, 28000, 24000, 20000]
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.normal(size=n) * 0.1
    seconds = sum(lengths) / SAMPLE_RATE

    def check_batch(counts, dtypes, attentions=22, gcfns=56):
        """The batch's launches: K1 in every GCFN and K3 in every global
        attention in the instances ``dtypes`` names, no other instance of
        either, K2 once."""
        k1, k3 = dtypes
        for name, want in (("fused_gcfn", gcfns), ("softmax_pv", attentions)):
            inst = k1 if name == "fused_gcfn" else k3
            for key in [n for n in counts if n.partition(" ")[0] == name]:
                expect = want if key == f"{name} {inst}".strip() else 0
                assert counts[key] == expect, (key, counts[key], expect)
            assert counts.get(f"{name} {inst}".strip(), 0) == want, (
                name, inst, counts)
        assert counts["materialize_pos_kt"] == 1
        assert counts["flash_relpos_attention"] == 0

    def left_in_float32(model, fn):
        """The modules of ``model`` that return a floating tensor other
        than bfloat16 in ``fn()``, the model itself left out."""
        seen = set()

        def hook(name):
            def record(module, args, out):
                outs = out if isinstance(out, tuple) else (out,)
                if any(isinstance(o, torch.Tensor) and o.is_floating_point()
                       and o.dtype != torch.bfloat16 for o in outs):
                    seen.add(name)
            return record

        handles = [mod.register_forward_hook(hook(name))
                   for name, mod in model.named_modules() if name]
        try:
            fn()
        finally:
            for handle in handles:
                handle.remove()
        return seen

    def stream_is_bf16(label, model, fn):
        """Every module returns bfloat16 but the rel-pos encoding (its
        float32 table and pos_kt, as the JAX package keeps them)."""
        odd = left_in_float32(model, fn)
        print(f"[bf16] {label}: modules that return float32: {sorted(odd)}")
        assert odd == {"separator.pos_emb"}, odd

    # a. Base's ragged batch in bfloat16, against float32 and the CPU
    base16, base32 = variant_of(BASE, compute_dtype="bfloat16"), \
        variant_of(BASE)
    model16, model32 = seeded(base16), seeded(base32)
    sep16 = sep_torch.Separator(base16, model16)
    sep32 = sep_torch.Separator(base32, model32)
    sep16.separate(batch, lengths)
    sep32.separate(batch, lengths)
    walls = {"bfloat16": [], "float32": []}
    for _ in range(5):
        for label, sep in (("bfloat16", sep16), ("float32", sep32)):
            t0 = time.perf_counter()
            sep.separate(batch, lengths)
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    for label, ms in walls.items():
        print(f"[bf16] Base batch B=4 x 4 s, {label}, 5 forwards in turns, "
              f"ms: {[round(t, 2) for t in ms]}; median "
              f"{statistics.median(ms):.2f}")
    audio16, counts = run("Base batch B=4 x 4 s, bfloat16",
                          lambda: sep16.separate(batch, lengths), seconds,
                          BASE)
    assert audio16.dtype == torch.float32 and tuple(audio16.shape) == (
        2, 4, 32000)
    assert torch.isfinite(audio16).all().item(), "non-finite audio"
    check_batch(counts, ("bf16", "bf16"))
    stream_is_bf16("Base batch, bfloat16", model16,
                   lambda: sep16.separate(batch, lengths))
    audio32, _ = run("Base batch B=4 x 4 s, float32",
                     lambda: sep32.separate(batch, lengths), seconds)
    agree("Base batch, bfloat16 against float32 on the card", audio16,
          audio32, BF16_F32_LIMIT)
    t0 = time.perf_counter()
    cpu16 = sep_torch.Separator(base16, copy.deepcopy(model16).to("cpu"))
    cpu = cpu16.separate(batch, lengths)
    print(f"[bf16] Base batch on the CPU in bfloat16 (plain versions): "
          f"{time.perf_counter() - t0:.2f} s")
    agree("Base batch, bfloat16, card against the CPU", audio16.cpu(), cpu,
          BF16_FORWARD_LIMIT)
    del cpu16, cpu
    traced("Base B=4 x 4 s forward, bfloat16",
           lambda: sep16.separate(batch, lengths), BASE)
    traced("Base B=4 x 4 s forward, float32",
           lambda: sep32.separate(batch, lengths))

    # b. the batch with its scores stored in bfloat16: under bfloat16
    #    compute, and under float32 compute
    for label, fields, dtypes, ref in (
            ("bfloat16, scores bfloat16",
             dict(compute_dtype="bfloat16", scores_dtype="bfloat16"),
             ("bf16", "bf16 scores"), audio16),
            ("float32, scores bfloat16", dict(scores_dtype="bfloat16"),
             ("", "bf16 scores f32 v"), audio32)):
        sep = sep_torch.Separator(variant_of(BASE, **fields),
                                  seeded(variant_of(BASE, **fields)))
        sep.separate(batch, lengths)
        audio, counts = run(f"Base batch B=4 x 4 s, {label}",
                            lambda: sep.separate(batch, lengths), seconds,
                            BASE)
        check_batch(counts, dtypes)
        agree(f"Base batch, {label}, against the scores in float32", audio,
              ref, BF16_FORWARD_LIMIT)
        del sep, audio
    del audio16, audio32

    # c. 70 s in full context: K12's bfloat16 instance in every global
    #    attention, against float32
    n70 = int(LONG_SECONDS * SAMPLE_RATE)
    wav70 = (rng.normal(size=n70) * 0.1).astype(np.float32)
    for label in ("Base 70 s full context, bfloat16 (first call)",
                  "Base 70 s full context, bfloat16"):
        long16, counts = run(label, lambda: separated(sep16, wav70),
                             LONG_SECONDS, BASE)
        assert counts["flash_relpos_attention bf16"] == 22, counts
        assert counts["flash_relpos_attention"] == counts["softmax_pv"] == 0
    long32, _ = run("Base 70 s full context, float32",
                    lambda: separated(sep32, wav70), LONG_SECONDS)
    agree("Base 70 s, bfloat16 against float32", long16, long32,
          BF16_F32_LIMIT)
    del long16, long32, sep32, model32

    # d. 300 s in 8 s chunks, then in full context, traced
    n300 = int(LONGEST_SECONDS * SAMPLE_RATE)
    wav300 = (rng.normal(size=n300) * 0.1).astype(np.float32)
    chunked = sep_torch.Separator(base16, model16,
                                  chunk_seconds=CHUNK_SECONDS)
    _, counts = run(f"Base 300 s in {CHUNK_SECONDS:.0f} s chunks, bfloat16",
                    lambda: separated(chunked, wav300), LONGEST_SECONDS,
                    BASE)
    assert counts["fused_gcfn bf16"] > 0 and counts["softmax_pv bf16"] > 0
    assert counts.get("flash_relpos_attention bf16", 0) == 0
    _, counts = run("Base 300 s full context, bfloat16",
                    lambda: separated(sep16, wav300), LONGEST_SECONDS, BASE)
    assert counts["flash_relpos_attention bf16"] == 22
    traced("Base 300 s forward, bfloat16",
           lambda: sep16.separate(wav300[None], [n300]), BASE)
    del chunked

    # e. infer_sample through the CLI with --set model.compute_dtype
    with tempfile.TemporaryDirectory() as tmp:
        n10 = 10 * SAMPLE_RATE
        path = os.path.join(tmp, "mix10.wav")
        write_wav(path, (rng.normal(size=n10) * 0.1).astype(np.float32),
                  SAMPLE_RATE)
        out_dir = os.path.join(tmp, "out")
        args = ["--model", BASE, "--engine-mode", "infer_sample",
                "--sample-file", path, "--workdir", os.path.join(tmp, "w"),
                "--out-wav-dir", out_dir, "--set",
                "model.compute_dtype=bfloat16"]
        status, counts = run("cli infer_sample, 10 s wav, --set "
                             "model.compute_dtype=bfloat16 (with the model's "
                             "set-up)", lambda: cli.main(args), 10.0, BASE)
        assert status == 0 and counts["fused_gcfn bf16"] == 56, counts
        assert counts["fused_gcfn"] == 0
        for i in range(2):
            x, rate = read_wav(os.path.join(out_dir, f"mix10_out_{i}.wav"))
            assert rate == SAMPLE_RATE and x.shape == (n10,), x.shape
            assert np.isfinite(x).all() and np.abs(x).max() > 0.5
    del sep16, model16
    torch.cuda.empty_cache()

    # f. Large: the ragged batch against float32, traced; 70 s
    large16 = variant_of(LARGE, compute_dtype="bfloat16")
    model16 = seeded(large16)
    sep16 = sep_torch.Separator(large16, model16)
    sep32 = sep_torch.Separator(variant_of(LARGE),
                                seeded(variant_of(LARGE)))
    sep16.separate(batch, lengths)
    audio16, counts = run("Large batch B=4 x 4 s, bfloat16",
                          lambda: sep16.separate(batch, lengths), seconds,
                          LARGE)
    check_batch(counts, ("bf16", "bf16"))
    stream_is_bf16("Large batch, bfloat16", model16,
                   lambda: sep16.separate(batch, lengths))
    audio32, _ = run("Large batch B=4 x 4 s, float32",
                     lambda: sep32.separate(batch, lengths), seconds)
    agree("Large batch, bfloat16 against float32 on the card", audio16,
          audio32, BF16_F32_LIMIT)
    traced("Large B=4 x 4 s forward, bfloat16",
           lambda: sep16.separate(batch, lengths), LARGE)
    traced("Large B=4 x 4 s forward, float32",
           lambda: sep32.separate(batch, lengths))
    del sep32, audio16, audio32
    torch.cuda.empty_cache()
    for label in ("Large 70 s full context, bfloat16 (first call)",
                  "Large 70 s full context, bfloat16"):
        _, counts = run(label, lambda: separated(sep16, wav70),
                        LONG_SECONDS, LARGE)
        assert counts["flash_relpos_attention bf16"] == 22, counts
    del sep16, model16
    torch.cuda.empty_cache()

    # g. the refusals: nothing trains in bfloat16, nothing falls back
    state = create_train_state(base16, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    mix, src = synthetic_batch(torch, np, rng, 2, SAMPLE_RATE)
    try:
        train_step(state, mix, src, 1e-3, 0.4, torch.Generator())
    except NotImplementedError as exc:
        assert "queue A, bf16 training" in str(exc), exc
        print(f"[bf16] train_step in bfloat16 refused: {exc}")
    else:
        raise AssertionError("train_step trained in bfloat16")
    del state
    x = torch.zeros(1, 64, 128, device="cuda", dtype=torch.bfloat16)
    q = torch.zeros(1, 2, 64, 16, device="cuda", dtype=torch.bfloat16)
    K.reset_launches()
    for name, call in (
            ("K15", lambda: K.fused_cla(x, [], 1e-5)),
            ("K16", lambda: K.fused_ega_tail_gcfn(
                x, x[:, :8].contiguous(), [], [], 1e-5)),
            ("K13", lambda: K.flash_relpos_attention_train(
                q, q, q, q[0, 0], 1, 64, 0.0))):
        try:
            call()
        except ValueError as exc:
            assert "queue B, bfloat16 streams" in str(exc), exc
            print(f"[bf16] {name} refused a bfloat16 tensor: {exc}")
        else:
            raise AssertionError(f"{name} took a bfloat16 tensor")
    assert not any(K.launch_counts().values()), "a refusal launched"
    missing = [name for name in (
        "fused_gcfn bf16", "fused_gcfn F=256 bf16", "softmax_pv bf16",
        "softmax_pv bf16 scores", "softmax_pv bf16 scores f32 v",
        "softmax_pv d=32 bf16", "flash_relpos_attention bf16",
        "flash_relpos_attention d=32 bf16") if not rows[name]]
    assert not missing, f"bfloat16 instances never launched: {missing}"
    print(f"[bf16] launches of the bfloat16 instances over the phase's "
          f"main-path runs: {dict(rows)}")
    return dict(rows)


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
    for name, lines in ptxas_report().items():
        for line in lines:
            print(f"[build] {name}: {line}")
    kernels = run("kernels", kernel_phase, torch, K, device_ms) or []
    served = run("serve", serve_phase, torch, np, sep_torch, K)
    counts = served[1] if served else {}
    if served:
        run("profile", profile_phase, torch, np, served[0], K, busy_us,
            kernel_events)
        run("cpu", cpu_phase, torch, np, sep_torch, served[0])
        del served
    run("eval_grad", eval_grad_phase, torch, np, sep_torch, K)
    train_counts = run("train", train_phase, torch, np, sep_torch, K,
                       busy_us, kernel_events) or {}
    run("train_cpu", train_cpu_phase, torch, np, sep_torch)
    run("engine", engine_phase, torch, np, K)
    long_counts = run("long", long_phase, torch, np, sep_torch, K, busy_us,
                      kernel_events) or {}
    route_counts = run("routes", routes_phase, torch, np, sep_torch, K,
                       busy_us) or {}
    fused_counts = run("fused", fused_phase, torch, np, sep_torch, K,
                       busy_us, kernel_events) or {}
    large_counts = run("large", large_phase, torch, np, sep_torch, K,
                       busy_us, kernel_events) or {}
    bf16_counts = run("bf16", bf16_phase, torch, np, sep_torch, K, busy_us,
                      kernel_events) or {}

    # each kernel's launches on the main path of its slice: the eval
    # kernels' in serving, the train kernels' in training, K12's in
    # long-form serving, K6's, K13's and K14's on the routes, K15's and
    # K16's on the fused routes, the instances at Large's widths in Large's
    # serving and training, the bfloat16 instances in bfloat16 serving;
    # K4, on no path, its launches summed over every phase's main-path
    # runs, which must be 0
    main_paths = (counts, train_counts, long_counts, route_counts,
                  fused_counts, large_counts)
    for row in kernels:
        name, _, instance = row["name"].partition(" ")
        row["launches"] = (bf16_counts.get(row["name"], 0)
                           if "bf16" in instance
                           else large_counts.get(name, 0) if instance
                           else counts.get(name, 0) if name in EVAL_KERNELS
                           else long_counts.get(name, 0)
                           if name in LONG_KERNELS
                           else route_counts.get(name, 0)
                           if name in ROUTE_KERNELS
                           else fused_counts.get(name, 0)
                           if name in FUSED_KERNELS
                           else sum(c.get(name, 0) for c in main_paths)
                           if name in OFF_PATH_KERNELS
                           else train_counts.get(name, 0))
        if name in OFF_PATH_KERNELS and row["launches"]:
            print(f"[kernels] FAILED: {name} is on no route, yet the main "
                  f"paths launched it {row['launches']} times")
            ok = False
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
