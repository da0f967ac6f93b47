"""Library entry point of the port:

    from sepreformer_torch import load_separator
    sep = load_separator("SepReformer_Base_WSJ0")          # on the GPU
    sources = sep("mixture.wav")           # list of per-speaker [T] arrays
    sources = sep(waveform)                # or raw samples at the model rate

``checkpoint`` is a reference-format ``.pth`` (a dict with
``model_state_dict``, or a bare state_dict), which loads strictly since
the port's modules carry the reference names, or a directory of the
port's ``epoch.NNNN.pth`` checkpoints (the latest epoch).  Without a
checkpoint the weights come from a seeded init (smoke tests, benchmarks).

Long recordings: by default a call runs the whole input in one forward
(full context; past 65.5 s at 8 kHz its global attentions take the K12
kernel).  ``chunk_seconds`` serves inputs longer than that in
overlapping chunks instead (``serving.separate_chunked``), at linear
cost.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from sepreformer_torch.config import VariantConfig, get_variant
from sepreformer_torch.data.audio import read_wav
from sepreformer_torch.engine.engine import apply_cmvn
from sepreformer_torch.models.sepreformer import (
    SepReformer,
    build_model,
    resolve_device,
)
from sepreformer_torch.serving import separate_long

# single utterances are zero-padded to a multiple of this many samples
LENGTH_BUCKET = 4000


class Separator:
    """Callable separation front end around an eval-mode SepReformer."""

    def __init__(self, variant: VariantConfig, model: SepReformer,
                 chunk_seconds: Optional[float] = None):
        self.variant = variant
        self.model = model
        self.chunk_seconds = chunk_seconds

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def sampling_rate(self) -> int:
        return self.variant.dataset.sampling_rate

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

    def __call__(self, mixture: Union[str, os.PathLike, np.ndarray]
                 ) -> List[np.ndarray]:
        """Separate one utterance -> list of per-speaker [T] arrays.  A
        path is read (and resampled) at the model rate; an array is taken
        as samples at the model rate.  With ``engine.mvn`` the samples are
        normalised first.  Past ``chunk_seconds`` the input is served in
        chunks, eight to a forward, with no lengths; otherwise it is
        zero-padded to the length bucket and the encoder stride, and the
        true length masks the padding out."""
        if isinstance(mixture, (str, os.PathLike)):
            wav, _ = read_wav(str(mixture), sr=self.sampling_rate)
        else:
            wav = np.asarray(mixture, np.float32)
            if wav.ndim != 1:
                raise ValueError(f"expected [T] samples, got {wav.shape}")
        if self.variant.engine.mvn:
            # before any padding, so the statistics see only real samples
            wav = apply_cmvn(wav[None])[0]
        stride = self.variant.model.enc_stride

        def forward_batch(batch):
            return self.separate(batch).cpu().numpy().transpose(1, 0, 2)

        def full_context(wav):
            t = len(wav)
            padded = -(-t // LENGTH_BUCKET) * LENGTH_BUCKET
            padded += (-padded) % stride
            x = np.zeros((1, padded), np.float32)
            x[0, :t] = wav
            return self.separate(x, [t])[:, 0, :t].cpu().numpy()

        return list(separate_long(forward_batch, full_context, wav,
                                  self.chunk_seconds, self.sampling_rate,
                                  stride))


def load_separator(variant: Union[str, VariantConfig] = "SepReformer_Base_WSJ0",
                   checkpoint: Optional[str] = None, device="cuda",
                   seed: int = 0,
                   chunk_seconds: Optional[float] = None) -> Separator:
    """A ready-to-call :class:`Separator` on ``device`` (CUDA unless the
    caller asks for the CPU).  ``checkpoint``: a ``.pth`` file, a
    directory of ``epoch.NNNN.pth`` files (the latest is loaded), or None
    for the seeded init."""
    cfg = get_variant(variant) if isinstance(variant, str) else variant
    device = resolve_device(device)
    if checkpoint is None:
        model = build_model(cfg.model, device=device,
                            generator=torch.Generator().manual_seed(seed))
    else:
        if os.path.isdir(checkpoint):
            from sepreformer_torch.engine.checkpoint import (
                checkpoint_path,
                latest_epoch,
            )

            epoch = latest_epoch(checkpoint)
            if epoch is None:
                raise FileNotFoundError(
                    f"no epoch.NNNN.pth checkpoints under {checkpoint!r}")
            checkpoint = checkpoint_path(checkpoint, epoch)
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model = SepReformer(cfg.model)
        model.load_state_dict(ckpt.get("model_state_dict", ckpt), strict=True)
        model = model.to(device).eval()
    return Separator(cfg, model, chunk_seconds=chunk_seconds)
