"""Library entry point of the port:

    from sepreformer_torch import load_separator
    sep = load_separator("SepReformer_Base_WSJ0")          # on the GPU
    sources = sep(waveform)                # list of per-speaker [T] arrays

``checkpoint`` is a reference-format ``.pth`` (a dict with
``model_state_dict``, or a bare state_dict): the port's modules carry the
reference names, so it loads strictly as it is.  Without a checkpoint the
weights come from a seeded init (smoke tests, benchmarks).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from sepreformer_torch.config import VariantConfig, get_variant
from sepreformer_torch.models.sepreformer import (
    SepReformer,
    build_model,
    resolve_device,
)


# single utterances are zero-padded to a multiple of this many samples
LENGTH_BUCKET = 4000


class Separator:
    """Callable separation front end around an eval-mode SepReformer."""

    def __init__(self, variant: VariantConfig, model: SepReformer):
        self.variant = variant
        self.model = model

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def separate(self, batch: Union[np.ndarray, torch.Tensor],
                 lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Batched masked forward: ``batch`` [B, T] (T a multiple of the
        encoder stride), ``lengths`` the true samples per row.  Returns
        the separated waveforms [spks, B, T] on the model's device."""
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device)
        lens = (None if lengths is None else
                torch.as_tensor(lengths, dtype=torch.int64).to(self.device))
        audio, _ = self.model(x, lengths=lens)
        return audio

    def __call__(self, mixture: np.ndarray) -> List[np.ndarray]:
        """Separate one utterance (samples at the model rate) -> list of
        per-speaker [T] arrays.  The input is zero-padded to the length
        bucket and the encoder stride, and the true length masks the
        padding out."""
        wav = np.asarray(mixture, np.float32)
        if wav.ndim != 1:
            raise ValueError(f"expected [T] samples, got {wav.shape}")
        t = len(wav)
        padded = -(-t // LENGTH_BUCKET) * LENGTH_BUCKET
        padded += (-padded) % self.variant.model.enc_stride
        x = np.zeros((1, padded), np.float32)
        x[0, :t] = wav
        audio = self.separate(x, [t])[:, 0, :t].cpu().numpy()
        return list(audio)


def load_separator(variant: Union[str, VariantConfig] = "SepReformer_Base_WSJ0",
                   checkpoint: Optional[str] = None, device="cuda",
                   seed: int = 0) -> Separator:
    """A ready-to-call :class:`Separator` on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    cfg = get_variant(variant) if isinstance(variant, str) else variant
    device = resolve_device(device)
    if checkpoint is None:
        model = build_model(cfg.model, device=device,
                            generator=torch.Generator().manual_seed(seed))
    else:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model = SepReformer(cfg.model)
        model.load_state_dict(ckpt.get("model_state_dict", ckpt), strict=True)
        model = model.to(device).eval()
    return Separator(cfg, model)
