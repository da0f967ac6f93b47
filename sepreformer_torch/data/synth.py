"""Synthetic speech-like corpus generator (source-filter model), the
port's copy of the JAX package's ``data/synth.py`` (same arithmetic, same
draws; ``active_level_rms`` is copied from its ``create_mixtures.py``).

The reference assumes the licensed WSJ0 corpus exists on disk and ships
only MATLAB mixing scripts (data/create_mixture_data/*.m) — there is no
way to exercise its full train/eval loop without the real data.  This
module closes that gap for the framework: it synthesizes a corpus of
2-speaker mixtures with WSJ0-2mix-compatible layout (wav trees + Kaldi
scp manifests + WSJ-style mixture keys, see dataset._wsj_speakers) so the
complete pipeline — scp parsing, loaders, dynamic mixing, Engine training,
eval metrics — runs end-to-end and measurably *learns* without licensed
audio.

Each synthetic "speaker" is a source-filter voice: a glottal pulse train
with a per-speaker pitch range and per-utterance F0 contour, filtered by a
cascade of second-order formant resonators, organized into syllables with
silences — enough spectro-temporal structure that separating two speakers
requires learning actual cues (pitch + formant envelope), unlike white
noise.  Audio quality is irrelevant; learnability and pipeline fidelity
are the point.

Separation difficulty is controlled by the speaker pool: disjoint
train/test speaker sets measure generalization to unseen "voices" exactly
like WSJ0-2mix does (si_tr_s vs si_et_05 speakers).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from sepreformer_torch.data.audio import write_wav


def active_level_rms(x: np.ndarray, sr: int, frame_ms: float = 20.0,
                     margin_db: float = 15.9) -> float:
    """Approximate P.56 active speech level: RMS over frames within
    ``margin_db`` of the loudest frame."""
    frame = max(1, int(sr * frame_ms / 1000.0))
    n = (len(x) // frame) * frame
    if n == 0:
        return float(np.sqrt(np.mean(np.square(x)))) or 1.0
    frames = x[:n].reshape(-1, frame)
    energy = np.mean(np.square(frames), axis=1)
    peak = energy.max()
    if peak <= 0:
        return 1.0
    active = energy >= peak * 10.0 ** (-margin_db / 10.0)
    level = np.sqrt(np.mean(energy[active]))
    return float(level) or 1.0


@dataclass(frozen=True)
class SynthSpeaker:
    """Source-filter voice parameters."""

    f0: float                                   # base pitch, Hz
    formants: Tuple[Tuple[float, float], ...]   # (center Hz, bandwidth Hz)
    breathiness: float                          # aspiration noise level
    rate: float                                 # syllables per second


def random_speaker(rng: np.random.Generator) -> SynthSpeaker:
    """Sample a voice. Pitch spans male-to-female range; formants stay
    below the 4 kHz Nyquist of 8 kHz audio."""
    f0 = float(rng.uniform(85.0, 260.0))
    f1 = float(rng.uniform(280.0, 850.0))
    f2 = float(rng.uniform(max(f1 + 250.0, 950.0), 2100.0))
    f3 = float(rng.uniform(max(f2 + 300.0, 2300.0), 3400.0))
    bws = rng.uniform(60.0, 160.0, size=3)
    return SynthSpeaker(
        f0=f0,
        formants=tuple((f, float(b)) for f, b in zip((f1, f2, f3), bws)),
        breathiness=float(rng.uniform(0.02, 0.08)),
        rate=float(rng.uniform(2.5, 5.0)),
    )


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """Second-order all-pole resonator H(z)=g/(1-2r cosθ z⁻¹ + r² z⁻²)."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2.0 * np.pi * freq / sr
    a1, a2 = 2.0 * r * np.cos(theta), -(r * r)
    try:
        from scipy.signal import lfilter

        y = lfilter([1.0 - r], [1.0, -a1, -a2], x)
    except ImportError:  # pragma: no cover - scipy is in the image
        y = np.empty_like(x)
        y1 = y2 = 0.0
        g = 1.0 - r
        for i in range(len(x)):
            y0 = g * x[i] + a1 * y1 + a2 * y2
            y[i] = y0
            y2, y1 = y1, y0
    return y.astype(np.float32)


def _syllable(
    rng: np.random.Generator, spk: SynthSpeaker, n: int, sr: int
) -> np.ndarray:
    """One voiced segment: pitch-contoured pulse train -> formant cascade
    -> attack/decay envelope, plus aspiration noise."""
    # F0 contour: smooth random walk within ±4 semitones of the speaker base
    contour = np.cumsum(rng.normal(0.0, 0.01, size=n))
    contour -= np.linspace(0.0, contour[-1], n)  # pin endpoints
    f0 = spk.f0 * 2.0 ** np.clip(contour, -1.0 / 3.0, 1.0 / 3.0)
    phase = np.cumsum(f0) / sr
    # impulse-ish glottal source: narrow raised-cosine pulses carry a full
    # harmonic series for the formant filters to shape
    frac = phase - np.floor(phase)
    pulse = np.clip(1.0 - (frac / 0.12), 0.0, 1.0) ** 2.0
    src = pulse - pulse.mean()
    src += spk.breathiness * rng.normal(0.0, 1.0, size=n)
    # per-syllable "vowel": jitter each formant up to ±18%
    y = src.astype(np.float32)
    for freq, bw in spk.formants:
        y = _resonator(y, freq * float(rng.uniform(0.82, 1.18)), bw, sr)
    # envelope: ~25 ms attack, ~60 ms decay
    att, dec = min(n // 3, int(0.025 * sr)), min(n // 3, int(0.06 * sr))
    env = np.ones(n, np.float32)
    if att:
        env[:att] = np.linspace(0.0, 1.0, att)
    if dec:
        env[-dec:] = np.linspace(1.0, 0.0, dec)
    y *= env
    peak = np.abs(y).max()
    return y / peak if peak > 0 else y


def synth_utterance(
    rng: np.random.Generator, spk: SynthSpeaker, n_samples: int, sr: int
) -> np.ndarray:
    """Speech-like utterance: syllables separated by short gaps with
    occasional longer pauses, peak-normalized to 0.5."""
    out = np.zeros(n_samples, np.float32)
    t = 0
    mean_syl = sr / spk.rate * 0.7
    while t < n_samples:
        syl = int(np.clip(rng.normal(mean_syl, mean_syl * 0.35), 0.06 * sr,
                          0.4 * sr))
        syl = min(syl, n_samples - t)
        if syl > int(0.03 * sr):
            loud = float(rng.uniform(0.5, 1.0))
            out[t : t + syl] = _syllable(rng, spk, syl, sr) * loud
        t += syl
        gap = int(rng.uniform(0.02, 0.12) * sr)
        if rng.uniform() < 0.12:  # occasional pause
            gap += int(rng.uniform(0.15, 0.4) * sr)
        t += gap
    peak = np.abs(out).max()
    return out * (0.5 / peak) if peak > 0 else out


def _colored_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    """Pink-ish ambient noise: white noise through a one-pole lowpass,
    plus a little broadband floor (stands in for WHAM's cafe noise)."""
    from scipy.signal import lfilter

    w = rng.normal(size=n).astype(np.float32)
    a = 0.92  # one-pole lowpass: y[t] = a*y[t-1] + (1-a)*w[t]
    y = lfilter([1.0 - a], [1.0, -a], w).astype(np.float32)
    y = y + 0.15 * w
    return y / (np.sqrt(np.mean(np.square(y))) + 1e-8)


def _synth_rir(rng: np.random.Generator, sr: int) -> np.ndarray:
    """Synthetic room impulse response: direct path + exponentially
    decaying random echo train (T60 ~ 0.15-0.4 s)."""
    t60 = float(rng.uniform(0.15, 0.4))
    n = int(t60 * sr)
    rir = np.zeros(n, np.float32)
    rir[0] = 1.0
    n_taps = int(rng.integers(40, 120))
    taps = rng.integers(int(0.003 * sr), n, size=n_taps)
    decay = np.exp(-6.9 * taps / (t60 * sr))  # -60 dB at t60
    signs = rng.choice([-1.0, 1.0], size=n_taps)
    amps = rng.uniform(0.2, 0.8, size=n_taps) * decay * signs
    np.add.at(rir, taps, amps.astype(np.float32))
    return rir


def _reverberate(x: np.ndarray, rir: np.ndarray) -> np.ndarray:
    y = np.convolve(x, rir)[: len(x)].astype(np.float32)
    return y


def generate_corpus(
    out_dir: str,
    n_train: int = 1200,
    n_valid: int = 120,
    n_test: int = 120,
    sr: int = 8000,
    utt_seconds: Tuple[float, float] = (3.0, 6.0),
    n_train_speakers: int = 20,
    n_test_speakers: int = 8,
    snr_range: float = 2.5,
    seed: int = 0,
    flavor: str = "wsj0",
) -> str:
    """Write a wsj0-2mix-style corpus under ``out_dir``.

    Layout: ``wav/{tr,cv,tt}/{mix,s1,s2}/<key>.wav`` plus scp manifests in
    ``scp/``.  Train/valid share a speaker pool; test speakers are
    disjoint (unseen voices).  Mixture keys are WSJ-style
    ``<spk1>a<idx>_<snr>_<spk2>a<idx>_<-snr>`` so dynamic mixing's
    speaker-id parsing (dataset._wsj_speakers, ref dataset.py:96-100)
    works on this corpus too.  Returns the scp directory path.

    ``flavor``:
    - "wsj0": clean 2-speaker mixtures (default);
    - "wham": + colored ambient noise in the mixture at 3..12 dB input
      SNR, noise wavs + ``{tr,cv,tt}_n.scp`` manifests (WHAM layout —
      targets stay the clean sources);
    - "whamr": + synthetic-RIR reverberant source copies build the
      mixture while the anechoic sources remain the targets, with
      ``*_s{1,2}_reverb.scp`` manifests (WHAMR layout,
      ref SepReformer_Large_DM_WHAMR/dataset.py:89-154).
    """
    if flavor not in ("wsj0", "wham", "whamr"):
        raise ValueError(f"unknown corpus flavor {flavor!r}")
    rng = np.random.default_rng(seed)
    pool_tr = [random_speaker(rng) for _ in range(n_train_speakers)]
    pool_tt = [random_speaker(rng) for _ in range(n_test_speakers)]
    scp_dir = os.path.join(out_dir, "scp")
    os.makedirs(scp_dir, exist_ok=True)

    parts = (
        ("tr", n_train, pool_tr),
        ("cv", n_valid, pool_tr),
        ("tt", n_test, pool_tt),
    )
    subs = ["mix", "s1", "s2"]
    if flavor in ("wham", "whamr"):
        subs.append("n")
    if flavor == "whamr":
        subs += ["s1_reverb", "s2_reverb"]
    for part, count, pool in parts:
        dirs = {}
        for sub in subs:
            d = os.path.join(out_dir, "wav", part, sub)
            os.makedirs(d, exist_ok=True)
            dirs[sub] = d
        lines = {sub: [] for sub in dirs}
        for idx in range(count):
            i1, i2 = rng.choice(len(pool), size=2, replace=False)
            n = int(rng.uniform(*utt_seconds) * sr)
            u1 = synth_utterance(rng, pool[i1], n, sr)
            u2 = synth_utterance(rng, pool[i2], n, sr)
            snr = float(rng.uniform(0.0, snr_range))
            # active-level SNR scaling, as create_wav_2speakers.m does
            s1 = u1 / active_level_rms(u1, sr) * 10.0 ** (snr / 20.0)
            s2 = u2 / active_level_rms(u2, sr) * 10.0 ** (-snr / 20.0)
            extra = {}
            if flavor == "whamr":
                r1 = _reverberate(s1, _synth_rir(rng, sr))
                r2 = _reverberate(s2, _synth_rir(rng, sr))
                mix = r1 + r2
                extra["s1_reverb"], extra["s2_reverb"] = r1, r2
            else:
                mix = s1 + s2
            if flavor in ("wham", "whamr"):
                noise_snr = float(rng.uniform(3.0, 12.0))
                noise = _colored_noise(rng, n)
                sig_rms = np.sqrt(np.mean(np.square(mix))) + 1e-8
                noise = noise * sig_rms * 10.0 ** (-noise_snr / 20.0)
                mix = mix + noise
                extra["n"] = noise
            # the peak must span EVERY written signal: the reverberant
            # copies (and noise) can exceed the dry/mix peaks when the
            # mixture partially cancels, and write_wav clips at 1.0 —
            # a clipped s?_reverb would break mix == r1 + r2 + n for the
            # WHAMR dynamic-mixing consumer
            peak = max(np.abs(mix).max(), np.abs(s1).max(), np.abs(s2).max(),
                       *[np.abs(v).max() for v in extra.values()])
            scale = 0.9 / max(peak, 1e-8)
            s1, s2, mix = s1 * scale, s2 * scale, mix * scale
            extra = {k: v * scale for k, v in extra.items()}
            key = (f"s{i1:02d}a{idx:04d}_{snr:.4f}_"
                   f"s{i2:02d}a{idx:04d}_{-snr:.4f}")
            for sub, wav in [("mix", mix), ("s1", s1), ("s2", s2),
                             *extra.items()]:
                path = os.path.join(dirs[sub], key + ".wav")
                write_wav(path, wav.astype(np.float32), sr)
                lines[sub].append(f"{key} {os.path.abspath(path)}")
        for sub in subs:
            with open(os.path.join(scp_dir, f"{part}_{sub}.scp"), "w") as f:
                f.write("\n".join(lines[sub]) + "\n")
    return scp_dir


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-train", type=int, default=1200)
    p.add_argument("--n-valid", type=int, default=120)
    p.add_argument("--n-test", type=int, default=120)
    p.add_argument("--sr", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flavor", default="wsj0",
                   choices=["wsj0", "wham", "whamr"],
                   help="wsj0: clean 2-spk; wham: +noise; whamr: "
                        "+noise+reverb (anechoic targets)")
    args = p.parse_args(argv)
    scp = generate_corpus(
        args.out_dir, args.n_train, args.n_valid, args.n_test,
        sr=args.sr, seed=args.seed, flavor=args.flavor,
    )
    print(scp)


if __name__ == "__main__":
    main()
