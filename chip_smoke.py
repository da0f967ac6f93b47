#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sepreformer_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build   - compile the CUDA kernel library with plain nvcc (sm_90a).
2. kernels - each kernel of the eval path (K1 GCFN, K2 rel-pos, K3 masked
             softmax·V) against its plain PyTorch version on the card, at
             the shapes SepReformer_Base_WSJ0 gives it for a B=4 x 4 s
             batch; times of the kernel, the plain version, a library
             call where one exists, and the least time the card could take.
3. serve   - Base at full width, seeded weights: three requests through
             ``Separator.__call__`` and one batched B=4 x 4 s forward with
             ragged lengths; every kernel's launch count must rise.
4. profile - the same model: repeated requests and batched forwards on
             the host clock, then one batched forward traced with
             ``torch.profiler``: the card's idle share, kernel time by
             group, and each kernel's launches per forward.
5. cpu     - the same weights on the CPU (plain versions) against the card
             on a 1 s utterance, with the branches' LayerScale at 0.5 so
             they carry signal; a control run on the card with TF32
             allowed must exceed the limit, so the check can see a
             product that lost float32 accuracy.

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
# wrapper -> the CUDA kernel it launches, as named in a profiler trace
KERNEL_SYMBOLS = {"fused_gcfn": "gcfn_kernel",
                  "materialize_pos_kt": "relpos_kernel",
                  "softmax_pv": "softmax_pv_kernel"}
# |card - cpu| over max|out| allowed in phase 5; see PERF.md for the
# readings it sits between (float32 on the card, and TF32 allowed)
CPU_REL_LIMIT = 3e-5
KERNEL_GROUPS = (  # profile groups of the card's kernels, first match wins
    ("K1 gcfn", ("gcfn_kernel",)),
    ("K2 relpos", ("relpos_kernel",)),
    ("K3 softmax_pv", ("softmax_pv_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas", "xmma", "sm90_")),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "dgrad", "wgrad")),
    ("copy / layout", ("copy", "cat", "transpose", "index", "gather",
                       "pad", "repeat")),
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
    missing = [name for name, n in counts.items() if n == 0]
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
    per_forward = K.launch_counts()
    kernels = kernel_events(prof)
    busy = busy_us(kernels)
    by_group, by_name = defaultdict(float), defaultdict(float)
    count = defaultdict(int)
    for name, _, dur in kernels:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "elementwise / other")
        by_group[group] += dur
        by_name[name[:80]] += dur
        count[name[:80]] += 1
    print(f"[profile] traced forward: window {window_us / 1e3:.2f} ms, card "
          f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / window_us:.3f}, "
          f"{len(kernels)} kernel launches; ours per forward {per_forward}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {group}: {us / 1e3:.3f} ms")
    for name in sorted(by_name, key=lambda n: -by_name[n])[:10]:
        print(f"[profile] kernel {by_name[name] / 1e3:.3f} ms "
              f"x{count[name]}: {name}")


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

    for row in kernels:
        row["launches"] = counts.get(row["name"], 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    print("[phases] " + ", ".join(f"{k} {v:.2f} s" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
