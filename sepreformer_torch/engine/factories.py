"""Name-driven optimizer, criterion and scheduler factories.

The reference picks components by class name from its YAML config
(utils/util_implement.py:9-64); the JAX package's ``engine/factories.py``
maps those names onto optax and its losses.  Here they map onto the
port's optimizers and losses.  Every optimizer runs after the train
step's global-norm clip (``engine.train.apply_gradients``), and every
step sets its learning rate.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Sequence

import torch

from sepreformer_torch.config import VariantConfig
from sepreformer_torch.engine.lr_control import LRController
from sepreformer_torch.engine.train import AdamW


def _adamw(cfg: VariantConfig, params, kw: Dict[str, Any]):
    return AdamW(params, lr=cfg.optim.lr, betas=kw.get("betas", (0.9, 0.999)),
                 eps=kw.get("eps", 1e-8),
                 weight_decay=kw.get("weight_decay", 1e-2))


def _adam(cfg: VariantConfig, params, kw: Dict[str, Any]):
    return AdamW(params, lr=cfg.optim.lr, betas=kw.get("betas", (0.9, 0.999)),
                 eps=kw.get("eps", 1e-8), weight_decay=0.0)


def _sgd(cfg: VariantConfig, params, kw: Dict[str, Any]):
    # optax.trace(decay=momentum): t = g + momentum * t, as torch's SGD
    # with dampening 0
    return torch.optim.SGD(params, lr=cfg.optim.lr,
                           momentum=kw.get("momentum", 0.0),
                           nesterov=kw.get("nesterov", False))


_OPTIMIZERS: Dict[str, Callable] = {"AdamW": _adamw, "Adam": _adam,
                                    "SGD": _sgd}


def make_optimizer_by_name(cfg: VariantConfig,
                           params: Iterable[torch.nn.Parameter],
                           name: str = "AdamW",
                           **kwargs) -> torch.optim.Optimizer:
    """An optimizer by its torch class name (util_implement.py:13-22)."""
    if name not in _OPTIMIZERS:
        raise KeyError(
            f"unknown optimizer {name!r}; available: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](cfg, params, kwargs)


def make_criterions(cfg: VariantConfig, device="cuda"
                    ) -> Dict[str, Callable]:
    """The reference's four criterions in its fixed order (engine.py:26):
    PIT_SISNR_mag, PIT_SISNR_time, PIT_SISNRi, PIT_SDRi."""
    from sepreformer_torch.losses import (
        pit_sisnr_improvement,
        pit_sisnr_mag,
        pit_sisnr_time,
    )
    from sepreformer_torch.metrics import sdri_np
    from sepreformer_torch.ops.stft import make_stft_kernel

    stft = cfg.criterion.stft
    kernel = torch.from_numpy(make_stft_kernel(
        stft.frame_length, stft.frame_shift, stft.window)).to(device)
    return {
        "PIT_SISNR_mag": functools.partial(
            pit_sisnr_mag, stft_kernel=kernel, frame_shift=stft.frame_shift,
            scale_inv=cfg.criterion.scale_inv),
        "PIT_SISNR_time": functools.partial(
            pit_sisnr_time, scale_inv=cfg.criterion.scale_inv),
        "PIT_SISNRi": pit_sisnr_improvement,
        "PIT_SDRi": sdri_np,
    }


def make_lr_controller(cfg: VariantConfig, names: Sequence[str] = (
        "ReduceLROnPlateau", "WarmupConstantSchedule")) -> LRController:
    """The reference composes ReduceLROnPlateau and WarmupConstantSchedule
    (configs.yaml:120-128); both live in one host-side LRController."""
    known = {"ReduceLROnPlateau", "WarmupConstantSchedule"}
    unknown = set(names) - known
    if unknown:
        raise KeyError(f"unknown schedulers {sorted(unknown)}")
    return LRController(
        base_lr=cfg.optim.lr,
        warmup_steps=(cfg.optim.warmup_steps
                      if "WarmupConstantSchedule" in names else 0),
        plateau_factor=(cfg.optim.plateau_factor
                        if "ReduceLROnPlateau" in names else 1.0),
        plateau_patience=cfg.optim.plateau_patience,
        min_lr=cfg.optim.plateau_min_lr,
    )
