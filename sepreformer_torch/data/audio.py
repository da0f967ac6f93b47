"""Host-side audio I/O, the port's copy of the JAX package's
``data/audio.py`` (scipy; the optional native reader is not ported,
ROADMAP A.1).

Matches the conventions the reference gets from ``librosa.load(sr=fs)`` /
``sf.write`` (dataset.py:141-147, engine.py:155,169-172): float32 waveforms
in [-1, 1] (int16 / 32768), polyphase resampling when the file rate differs
from the requested rate.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate).

    Multi-channel audio is averaged to mono (librosa.load default).
    If ``sr`` is given and differs from the file rate, resamples.
    """
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if sr is not None and sr != rate:
        x = resample(x, rate, sr)
        rate = sr
    return x, rate


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), matching librosa's default quality class."""
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] waveform as 16-bit PCM."""
    from scipy.io import wavfile

    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (x * 32767.0).astype(np.int16))


def peak_normalize(x: np.ndarray, level: float) -> np.ndarray:
    """x / max|x| * level — the reference's output scaling
    (engine.py:140-143 uses 0.5, engine.py:169-172 uses 0.9)."""
    peak = np.abs(x).max()
    if peak == 0:
        return x
    return x / peak * level
