"""uPIT training losses, the port's copy of the JAX package's
``losses.py``.

Every permutation is scored from one [B, S, S] table of pairwise scores
(reference criterions.py:154-176, 196-217 loops over permutations
instead).  Conventions, as in the reference:

- SI-SNR time loss: eps 1e-8, per-utterance clamp at -30 dB; the table
  is K11 on the card (``ops/kernels/pit.py``);
- magnitude loss: eps 1e-12, scale clamped at >= 1e-2, Frobenius norms
  of the window-scaled STFT magnitudes;
- batch reduction: the mean over utterances of the best permutation's
  summed loss; the train step divides by the number of speakers.

``pit_sisnr_improvement`` and ``sisnr_db`` (metrics) are not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from sepreformer_torch.ops.kernels.pit import (
    _zero_mean,
    sisnr_pairwise_neg,
    sisnr_pairwise_neg_fused,
)
from sepreformer_torch.ops.stft import stft_magnitude

__all__ = [
    "pit_sisnr_mag", "pit_sisnr_time", "progressive_alpha",
    "sisnr_pairwise_neg", "stft_mag_pairwise_neg",
]


def _perm_matrix(num_spks: int) -> np.ndarray:
    """All permutations as an index array [P, spks]."""
    return np.asarray(list(itertools.permutations(range(num_spks))),
                      np.int64)


def _gather_perm_totals(pair_scores: torch.Tensor) -> torch.Tensor:
    """[B, est_spk, src_spk] pairwise scores -> [P, B] permutation
    totals: totals[p, b] = sum_s pair_scores[b, s, perms[p, s]]."""
    num_spks = pair_scores.shape[1]
    perms = _perm_matrix(num_spks)
    return torch.stack([
        sum(pair_scores[:, s, perms[p, s]] for s in range(num_spks))
        for p in range(len(perms))])


def pit_sisnr_time(est: torch.Tensor, src: torch.Tensor,
                   scale_inv: bool = True) -> torch.Tensor:
    """uPIT time-domain SI-SNR loss (criterions.py:178-217): est, src
    [S, B, T] -> the mean over utterances of the best permutation's
    summed negative SI-SNR."""
    pair = sisnr_pairwise_neg_fused(est, src, scale_inv)
    return _gather_perm_totals(pair).min(dim=0).values.mean()


def stft_mag_pairwise_neg(est: torch.Tensor, src: torch.Tensor,
                          stft_kernel: torch.Tensor, frame_shift: int,
                          scale_inv: bool = True, eps: float = 1.0e-12,
                          mel_fb: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Negative spectral SDR of every speaker pair (criterions.py:154-171):
    est, src [S, B, T] -> [B, S, S].  The scale-invariant projection
    rescales the source per pair, so each pair gets its own source
    spectrogram; the estimate's is shared.  ``mel_fb`` [n_freqs, n_mels]
    projects the magnitudes on the mel scale (the ``mel_opt`` branch)."""
    spks, b, t = est.shape
    e = _zero_mean(est)
    s = _zero_mean(src)

    def mag(x):
        m = stft_magnitude(x, stft_kernel, frame_shift)
        return m if mel_fb is None else torch.matmul(m, mel_fb)

    mag_e = mag(e.reshape(spks * b, t))
    mag_e = mag_e.reshape(spks, 1, b, *mag_e.shape[1:])
    ee = e[:, None]                                   # [S_e, 1, B, T]
    ss = s[None, :].expand(spks, spks, b, t)
    if scale_inv:
        scale = (ee * ss).sum(dim=-1, keepdim=True) / (
            (ss * ss).sum(dim=-1, keepdim=True) + eps)
        ss = torch.clamp(scale, min=1.0e-2) * ss      # criterions.py:163
    nb = mag_e.shape[-1]
    mag_s = mag(ss.reshape(spks * spks * b, t)).reshape(spks, spks, b, -1,
                                                        nb)
    num = torch.sqrt((mag_s * mag_s).sum(dim=(-2, -1)))
    den = torch.sqrt(((mag_e - mag_s) ** 2).sum(dim=(-2, -1)))
    loss = -20.0 * torch.log10(eps + num / (den + eps))
    return loss.permute(2, 0, 1)


def pit_sisnr_mag(est: torch.Tensor, src: torch.Tensor,
                  stft_kernel: torch.Tensor, frame_shift: int,
                  scale_inv: bool = True,
                  mel_fb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uPIT spectral-magnitude aux loss (criterions.py:115-176), a
    scalar."""
    pair = stft_mag_pairwise_neg(est, src, stft_kernel, frame_shift,
                                 scale_inv=scale_inv, mel_fb=mel_fb)
    return _gather_perm_totals(pair).min(dim=0).values.mean()


def progressive_alpha(epoch: int, alpha: float = 0.4,
                      decay_start: int = 100, decay_factor: float = 0.8,
                      decay_every: int = 5) -> float:
    """Aux-loss weight schedule (engine.py:72): ``alpha`` until epoch
    ``decay_start``, then alpha * 0.8**(1 + (epoch - 101) // 5)."""
    if epoch <= decay_start:
        return alpha
    return alpha * decay_factor ** (
        1 + (epoch - (decay_start + 1)) // decay_every)
