#!/usr/bin/env python3
"""Where two float32 train steps' gradients part: one dropout-0 step of a
model on its fused block routes and on the default route, from the same
seeded weights (``chip_smoke.seeded_model``) and batch, on the card; with
``--cpu`` also on the CPU (the plain versions).  Prints each pair's
largest gradient difference over the largest gradient, the worst
parameters, the same without the aux heads (``out_layer_bn.*``), and
how many elements of each ``torch.relu`` call (the aux heads' masks)
changed sign between the two runs.

    python3 relu_flips.py [MODEL] [SECONDS] [--cpu]

MODEL defaults to SepReformer_Large_DM_WSJ0, SECONDS (the crop of the
batch of the preset's size) to 4.  Needs a CUDA card.
"""

import contextlib
import copy
import dataclasses
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
import sepreformer_torch as sep_torch
from sepreformer_torch.config import apply_override
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.ops.kernels import ega_gcfn


@contextlib.contextmanager
def k16_plain():
    """K16's plain version in place of the kernel (its forward)."""
    real = ega_gcfn.pair_kernel
    ega_gcfn.pair_kernel = ega_gcfn.ega_tail_gcfn_plain
    try:
        yield
    finally:
        ega_gcfn.pair_kernel = real


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    name = args[0] if args else cs.LARGE
    seconds = float(args[1]) if len(args) > 1 else 4.0
    if not torch.cuda.is_available():
        print("relu_flips: no CUDA device", file=sys.stderr)
        return 1
    base = sep_torch.get_variant(name)
    fused = apply_override(apply_override(base, "model.fused_local", "on"),
                           "model.fused_pair", "on")
    cfgs = {label: dataclasses.replace(v, model=dataclasses.replace(
        v.model, dropout=0.0)) for label, v in (("pair", fused),
                                               ("default", base))}
    models = {label: cs.seeded_model(torch, sep_torch, cfg, device="cpu")
              for label, cfg in cfgs.items()}
    mix, src = cs.synthetic_batch(torch, np, np.random.default_rng(17),
                                  base.dataset.batch_size,
                                  int(seconds * cs.SAMPLE_RATE))

    def step(label, device, context=contextlib.nullcontext):
        state = create_train_state(cfgs[label], model=copy.deepcopy(
            models[label]).to(device))
        masks = []
        t0 = time.perf_counter()
        with context(), cs.relu_masks(torch, masks):
            metrics = train_step(state, mix.to(device), src.to(device),
                                 1e-3, 0.4, torch.Generator().manual_seed(18))
        loss = float(metrics["total_loss"])
        print(f"{label} route, {device}, {context.__name__}: loss "
              f"{loss:.7f}, {time.perf_counter() - t0:.1f} s", flush=True)
        return {n: p.grad.detach().double().cpu()
                for n, p in state.model.named_parameters()}, \
            [m.cpu() for m in masks]

    def compare(tag, a, b):
        scale = max(g.abs().max().item() for g in b[0].values())
        per = sorted(((a[0][n] - b[0][n]).abs().max().item() / scale, n)
                     for n in a[0])[::-1]
        heads = max(e for e, n in per if not n.startswith("out_layer_bn"))
        flips = [int((x != y).sum()) for x, y in zip(a[1], b[1])]
        print(f"{tag}: {per[0][0]:.3e} ({per[0][1]}); without "
              f"out_layer_bn.* {heads:.3e}; next "
              f"{[(n, float(f'{e:.3e}')) for e, n in per[1:4]]}; ReLU sign "
              f"flips per call {flips}", flush=True)

    runs = {"default": step("default", "cuda"), "pair": step("pair", "cuda"),
            "pair, K16 plain": step("pair", "cuda", k16_plain)}
    compare("pair against default", runs["pair"], runs["default"])
    compare("pair with K16's plain version against default",
            runs["pair, K16 plain"], runs["default"])
    if "--cpu" in sys.argv:
        torch.set_num_threads(8)
        runs["cpu"] = step("default", "cpu")
        for label in ("default", "pair", "pair, K16 plain"):
            compare(f"{label} against the CPU", runs[label], runs["cpu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
