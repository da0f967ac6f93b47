"""STFT magnitude as framing plus one matrix product.

The reference builds its STFT as a fixed Conv1d whose kernel is a
window-scaled DFT matrix (utils/implements/criterions.py:43-61); here, as
in the JAX package's ``ops/stft.py``, it is one [B*T, N] x [N, 2*(N/2+1)]
product over the frames, with the reference's scaling:

- periodic hann window
- window *= sqrt(2/3) when shift == N/4 (perfect-OLA scaling)
- kernel /= S with S = 0.5*sqrt(N^2/shift)
- magnitude = sqrt(re^2 + im^2 + 1e-10)  (criterions.py:111)

The two builders return numpy arrays; the port's own copy of the JAX
package's functions of the same names.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def make_stft_kernel(frame_length: int, frame_shift: int,
                     window: str = "hann") -> np.ndarray:
    """The [frame_length, 2*(frame_length//2+1)] analysis matrix: real
    (cos) filters, then imaginary (-sin) filters, as rfft of a unit
    impulse (criterions.py:57-60)."""
    n = frame_length
    if window != "hann":
        raise ValueError(f"unsupported window {window!r}")
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))  # periodic hann
    if n // 4 == frame_shift:
        w = np.sqrt(2.0 / 3.0) * w
    elif n // 2 == frame_shift:
        w = np.sqrt(w)
    s = 0.5 * np.sqrt(n * n / frame_shift)
    nbins = n // 2 + 1
    grid = np.outer(np.arange(n), np.arange(nbins)) * (2.0 * np.pi / n)
    real = np.cos(grid) / s
    imag = -np.sin(grid) / s
    return (np.concatenate([real, imag], axis=1)
            * w[:, None]).astype(np.float32)


def make_mel_filterbank(n_freqs: int, n_mels: int = 80,
                        sample_rate: int = 16000, f_min: float = 0.0,
                        f_max: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] (HTK mel scale, no
    norm), as ``torchaudio.transforms.MelScale`` builds it: the
    reference's ``mel_opt`` loss front end (criterions.py:133), which
    hardcodes 16 kHz even for the 8 kHz variants."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    m_pts = np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def stft_magnitude(x: torch.Tensor, kernel: torch.Tensor,
                   frame_shift: int) -> torch.Tensor:
    """Magnitude spectrogram of [B, T] -> [B, n_frames, nbins]: right-pad
    to a whole number of hops (criterions.py:89-97), then frames of
    ``frame_length`` every ``frame_shift`` samples."""
    frame_length, twobins = kernel.shape
    nbins = twobins // 2
    t = x.shape[-1]
    padded = -(-t // frame_shift) * frame_shift
    if padded > t:
        x = F.pad(x, (0, padded - t))
    frames = x.unfold(-1, frame_length, frame_shift)   # [B, T', N]
    spec = torch.matmul(frames, kernel.to(x.dtype))
    re, im = spec[..., :nbins], spec[..., nbins:]
    return torch.sqrt(re * re + im * im + 1.0e-10)
