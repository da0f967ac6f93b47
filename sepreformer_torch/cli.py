"""Command-line entry point of the port, with the JAX package's flags
(``sepreformer_tpu/cli.py``, itself the reference ``run.py``'s):

    python -m sepreformer_torch.cli --engine-mode train --scp-root DATA
    python -m sepreformer_torch.cli --engine-mode test --device cpu ...
    python -m sepreformer_torch.cli --engine-mode infer_sample \
        --sample-file mix.wav [--chunk-seconds 8] [--checkpoint ...]

Runs on the CUDA card unless ``--device cpu`` asks for the plain versions
on the CPU.  The mesh flags (``--data-parallel``, ``--model-parallel``)
are not ported yet and exit with an error naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from dataclasses import replace
from typing import Optional

NOT_PORTED = {
    "--data-parallel": "ROADMAP.md queue A, parallel/",
    "--model-parallel": "ROADMAP.md queue A, parallel/",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sepreformer-torch",
        description="SepReformer speech separation in PyTorch/CUDA")
    p.add_argument("--model", default="SepReformer_Base_WSJ0",
                   help="variant preset name (see --list-models)")
    p.add_argument("--engine-mode", default="train",
                   choices=["train", "test", "test_save", "test_wav",
                            "infer_sample"])
    p.add_argument("--sample-file", default=None,
                   help="infer_sample: the wav file to separate")
    p.add_argument("--out-wav-dir", "--out_wav_dir", dest="out_wav_dir",
                   default=None)
    p.add_argument("--workdir", default=None,
                   help="checkpoint/log dir (default: models/<name>)")
    p.add_argument("--scp-root", default=".",
                   help="directory containing the scp_dir from the config")
    p.add_argument("--scp-dir", default=None,
                   help="override the config's scp manifest directory")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="override any config field by dotted path, e.g. "
                        "--set optim.warmup_steps=100 (repeatable)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override the config's train batch size")
    p.add_argument("--max-epoch", type=int, default=None,
                   help="override the config's training epoch count")
    p.add_argument("--config", default=None,
                   help="optional reference-format configs.yaml to load "
                        "instead of the named preset")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth checkpoint (or state_dict) to load")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="not ported: " + NOT_PORTED["--data-parallel"])
    p.add_argument("--model-parallel", type=int, default=None,
                   help="not ported: " + NOT_PORTED["--model-parallel"])
    p.add_argument("--list-models", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--chunk-seconds", type=float, default=None,
                   help="infer_sample: chunked overlap-add long-form "
                        "processing with this chunk length (linear cost)")
    return p


def main(argv: Optional[list] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag in ("--data-parallel", "--model-parallel"):
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported yet: {NOT_PORTED[flag]}")
    if args.engine_mode == "infer_sample" and not args.sample_file:
        parser.error("--sample-file is required for infer_sample")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from sepreformer_torch.config import (
        apply_override,
        available_variants,
        from_reference_yaml,
        get_variant,
    )

    if args.list_models:
        print("\n".join(available_variants()))
        return 0
    cfg = (from_reference_yaml(args.config, name=args.model) if args.config
           else get_variant(args.model))
    if args.scp_dir is not None:
        cfg = replace(cfg, dataset=replace(cfg.dataset, scp_dir=args.scp_dir))
    if args.batch_size is not None:
        cfg = replace(cfg, dataset=replace(cfg.dataset,
                                           batch_size=args.batch_size))
    if args.max_epoch is not None:
        cfg = replace(cfg, engine=replace(cfg.engine,
                                          max_epoch=args.max_epoch))
    for ov in args.overrides:
        if "=" not in ov:
            print(f"--set expects SECTION.KEY=VALUE, got {ov!r}",
                  file=sys.stderr)
            return 2
        dotted, _, raw = ov.partition("=")
        cfg = apply_override(cfg, dotted.strip(), raw.strip())
    if args.engine_mode == "test_wav":  # README spelling (README.md:109)
        args.engine_mode = "test_save"
    workdir = args.workdir or os.path.join("models", cfg.name)

    from sepreformer_torch.data.dataset import build_dataloaders
    from sepreformer_torch.engine.engine import Engine

    loaders = {}
    if args.engine_mode != "infer_sample":
        loaders = build_dataloaders(cfg.dataset, args.engine_mode,
                                    scp_root=args.scp_root, seed=args.seed)
    engine = Engine(cfg, workdir, loaders, seed=args.seed,
                    device=args.device)
    if args.checkpoint:
        import torch

        sd = torch.load(args.checkpoint, map_location=engine.device,
                        weights_only=True)
        engine.state.model.load_state_dict(sd.get("model_state_dict", sd))
    if args.engine_mode == "infer_sample":
        outs = engine.infer_sample(args.sample_file, args.out_wav_dir,
                                   chunk_seconds=args.chunk_seconds)
        print("\n".join(outs))
        return 0
    result = engine.run(args.engine_mode, out_wav_dir=args.out_wav_dir)
    if "sisnri" in result:
        print(f"SI-SNRi: {result['sisnri']:.2f} dB")
        if "sdri" in result:
            print(f"SDRi:    {result['sdri']:.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
