"""Train and eval steps of the port (the JAX package's
``engine/train.py``).

One train step is the reference's per-batch loop (engine.py:55-77):
forward in train mode -> uPIT time loss and the per-stage STFT-magnitude
losses -> progressive weighting by alpha -> backward -> global-norm clip
-> AdamW with decoupled weight decay.  The learning rate is an input of
every step, as the JAX package's host-driven schedule hands it in.  The
eval step computes the same losses with running BatchNorm statistics and
no dropout, through the eval kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from sepreformer_torch.config import OptimConfig, VariantConfig
from sepreformer_torch.losses import pit_sisnr_mag, pit_sisnr_time
from sepreformer_torch.models.blocks import TrainMode
from sepreformer_torch.models.sepreformer import SepReformer, build_model
from sepreformer_torch.ops.stft import make_mel_filterbank, make_stft_kernel


@dataclass
class TrainState:
    """The model (parameters and BatchNorm buffers), its optimizer, the
    step count and the loss's constant STFT (and mel) matrices."""

    cfg: VariantConfig
    model: SepReformer
    optimizer: AdamW
    stft_kernel: torch.Tensor
    mel_fb: Optional[torch.Tensor] = None
    step: int = 0


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax's bias correction computes it
    (XLA's float32 pow and the C library's agree to within 1 ulp)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW(torch.optim.Optimizer):
    """AdamW as the JAX package's optax chain computes it (after the clip):
    ``scale_by_adam``, ``add_decayed_weights``, then the step at -lr:
    p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p).
    ``torch.optim.AdamW`` takes the same step with its bias corrections in
    float64; optax's are float32, which moves early steps by up to 1e-5 of
    themselves, so this one takes them as optax does."""

    def __init__(self, params, lr: float, betas: Tuple[float, float],
                 eps: float, weight_decay: float):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            mus = [s["mu"] for s in states]
            nus = [s["nu"] for s in states]
            b1, b2 = group["betas"]
            count = states[0]["step"] + 1
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, _bias_correction(b2, count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mus, _bias_correction(b1, count))
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])
            for s in states:
                s["step"] = count


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: OptimConfig) -> AdamW:
    """AdamW (configs.yaml:114-118) with decoupled decay.  Every step sets
    its learning rate."""
    return AdamW(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                 weight_decay=cfg.weight_decay)


def create_train_state(cfg: VariantConfig,
                       model: Optional[SepReformer] = None, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """A train state around ``model``, or around a model built on
    ``device`` with weights drawn from ``generator`` (CUDA unless the
    caller asks for the CPU)."""
    if model is None:
        model = build_model(cfg.model, device=device, generator=generator)
    device = next(model.parameters()).device
    stft = cfg.criterion.stft
    kernel = torch.from_numpy(make_stft_kernel(
        stft.frame_length, stft.frame_shift, stft.window)).to(device)
    mel_fb = None
    if cfg.criterion.mel_opt:
        # reference criterions.py:133: MelScale(80, 16000, N/2 + 1)
        mel_fb = torch.from_numpy(make_mel_filterbank(
            stft.frame_length // 2 + 1)).to(device)
    return TrainState(cfg, model, make_optimizer(model.parameters(),
                                                 cfg.optim), kernel, mel_fb)


def compute_losses(cfg: VariantConfig, audio: torch.Tensor,
                   aux: torch.Tensor, sources: torch.Tensor,
                   stft_kernel: torch.Tensor,
                   mel_fb: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The time loss and the progressive multi-loss metrics (engine.py:
    67-74): audio [S, B, T], aux [stages, S, B, T], sources [S, B, T]."""
    crit = cfg.criterion
    time_loss = pit_sisnr_time(audio, sources, scale_inv=crit.scale_inv)
    mag_losses = [pit_sisnr_mag(aux[i], sources, stft_kernel,
                                crit.stft.frame_shift,
                                scale_inv=crit.scale_inv, mel_fb=mel_fb)
                  for i in range(aux.shape[0])]
    metrics = {"time_loss": time_loss}
    for i, ml in enumerate(mag_losses):
        metrics[f"mag_loss_{i}"] = ml
    metrics["mag_loss_mean"] = torch.stack(mag_losses).mean()
    return time_loss, metrics


def apply_gradients(state: TrainState, lr: float) -> torch.Tensor:
    """Clip the parameters' gradients to a global norm of ``clip_norm``,
    take one AdamW step at ``lr``; returns the norm before the clip.

    The clip is ``optax.clip_by_global_norm``'s: a gradient whose global
    norm reaches the clip becomes g / norm * clip, in place, and one
    under it is left alone (``torch.nn.utils.clip_grad_norm_`` scales by
    clip / (norm + 1e-6) instead, which is far off at a small clip).  The
    choice is made on the device, with no host sync."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    clip = state.cfg.optim.clip_norm
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < clip
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, clip))
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    state.optimizer.step()
    return norm.detach()


# The ROADMAP item that ports training in bfloat16 (K5, K7/K8 and K9/K10
# in bfloat16, the train step, the CLI).
BF16_TRAINING = "ROADMAP.md queue A, bf16 training"


def check_trainable(cfg) -> None:
    """Raise where the port cannot train ``cfg``: a bfloat16
    ``model.compute_dtype`` serves but does not train yet (nothing falls
    back to float32)."""
    if cfg.model.compute_dtype != "float32":
        raise NotImplementedError(
            f"training with model.compute_dtype={cfg.model.compute_dtype!r} "
            f"is not ported (not built yet: {BF16_TRAINING}); serve in it, "
            f"or train in float32")


def train_step(state: TrainState, mixture: torch.Tensor,
               sources: torch.Tensor, lr: float, alpha: float,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One optimizer step on mixture [B, T] and sources [S, B, T]:
    ``accum_steps`` sequential micro-batches (BatchNorm's running
    statistics update after each), then the update on their mean
    gradient.  ``generator``, a CPU generator, drives the dropout: one
    draw seeds the device generator of the masks, and the kernel sites
    draw their hash seeds from it directly.  Returns the JAX package's
    metrics as 0-d tensors on the device: ``total_loss``, ``time_loss``,
    ``mag_loss_i``, ``mag_loss_mean``, ``grad_norm`` (before the clip)."""
    cfg = state.cfg
    check_trainable(cfg)
    model = state.model
    device = next(model.parameters()).device
    if generator.device.type != "cpu":
        raise ValueError("train_step: pass a CPU generator")
    accum = max(1, cfg.optim.accum_steps)
    if mixture.shape[0] % accum:
        raise ValueError(f"batch {mixture.shape[0]} not divisible by "
                         f"accum_steps {accum}")
    masks = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2 ** 62, (1,), generator=generator)))
    train = TrainMode(cfg.model.dropout, masks, generator)
    mixture = mixture.to(device=device, dtype=torch.float32)
    sources = sources.to(device=device, dtype=torch.float32)
    state.optimizer.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for mix, src in zip(mixture.chunk(accum), sources.chunk(accum, dim=1)):
        audio, aux = model(mix, train=train)
        time_loss, metrics = compute_losses(cfg, audio, aux, src,
                                            state.stft_kernel, state.mel_fb)
        total = ((1.0 - alpha) * time_loss
                 + alpha * metrics["mag_loss_mean"]) / cfg.model.num_spks
        metrics["total_loss"] = total
        (total / accum).backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    out = {k: v / accum for k, v in sums.items()}
    out["grad_norm"] = apply_gradients(state, lr)
    state.step += 1
    return out


def eval_step(state: TrainState, mixture: torch.Tensor,
              sources: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Validation losses (engine.py:86-110): running BatchNorm statistics,
    no dropout, the eval kernels."""
    device = next(state.model.parameters()).device
    with torch.inference_mode():
        audio, aux = state.model(mixture.to(device=device,
                                            dtype=torch.float32))
        _, metrics = compute_losses(state.cfg, audio, aux,
                                    sources.to(device=device,
                                               dtype=torch.float32),
                                    state.stft_kernel, state.mel_fb)
    return metrics

