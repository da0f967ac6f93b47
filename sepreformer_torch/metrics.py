"""Host-side (numpy) evaluation metrics: SI-SNRi and BSS-eval SDRi, the
port's copy of the JAX package's ``metrics.py``.

The reference uses ``mir_eval.separation.bss_eval_sources`` on CPU for SDRi
(criterions.py:285-289).  mir_eval is not a dependency, so the
BSS-eval v3 'sources' decomposition is implemented here from the published
algorithm (Vincent et al., 2006): 512-tap least-squares projections of each
estimate onto the span of delayed references, with the permutation chosen
by maximum SIR, exactly as mir_eval does.

Metrics are computed at true utterance length in float64 (eval is not the
hot path; the separator forward is).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np


def sisnr_np(est: np.ndarray, src: np.ndarray, eps: float = 1e-15) -> float:
    """Scale-invariant SNR in dB for 1-D signals (zero-mean projection)."""
    e = est.astype(np.float64) - est.mean()
    s = src.astype(np.float64) - src.mean()
    scale = np.dot(e, s) / (np.dot(s, s) + eps)
    t = scale * s
    return float(
        20.0 * np.log10(eps + np.linalg.norm(t) / (np.linalg.norm(e - t) + eps))
    )


def pit_sisnri_np(
    est: np.ndarray, src: np.ndarray, mixture: np.ndarray, eps: float = 1e-15
) -> Tuple[float, np.ndarray]:
    """PIT-max SI-SNR improvement for one utterance.

    est, src: [spks, T]; mixture: [T].  Returns (mean improvement over
    speakers, per-speaker improvements for the best permutation).
    """
    spks = est.shape[0]
    imp = np.zeros((spks, spks))
    for i in range(spks):
        for j in range(spks):
            imp[i, j] = sisnr_np(est[i], src[j], eps) - sisnr_np(
                mixture, src[j], eps
            )
    best_total, best_vals = -np.inf, None
    for perm in itertools.permutations(range(spks)):
        total = sum(imp[i, perm[i]] for i in range(spks))
        if total > best_total:
            best_total = total
            best_vals = np.array([imp[i, perm[i]] for i in range(spks)])
    return best_total / spks, best_vals


# --------------------------------------------------------------------------
# BSS-eval v3 "sources" (Vincent et al. 2006), framewise=False
# --------------------------------------------------------------------------


def _compute_projections(ref: np.ndarray, est: np.ndarray, flen: int):
    """Least-squares projection of ``est`` onto delayed versions of each
    reference row.  ref: [S, T], est: [T].  Returns (s_target per ref row,
    projection onto the union span)."""
    s, t = ref.shape
    n_fft = int(2 ** np.ceil(np.log2(t + flen - 1)))
    rf = np.fft.rfft(ref, n=n_fft, axis=1)
    ef = np.fft.rfft(est, n=n_fft)

    # d[i, tau] = <est, ref_i(. - tau)> = r_{ref_i, est}[tau], lags 0..flen-1
    g_re = np.fft.irfft(np.conj(rf) * ef[None, :], n=n_fft, axis=1)[:, :flen]
    # G blocks: G_ij[a, b] = <ref_i(.-a), ref_j(.-b)> = r_{ref_i, ref_j}[a-b]
    from scipy.linalg import toeplitz

    big_g = np.zeros((s * flen, s * flen))
    for i in range(s):
        for j in range(i, s):
            cc = np.fft.irfft(np.conj(rf[i]) * rf[j], n=n_fft)
            col = cc[:flen]                                     # a - b >= 0
            row = np.concatenate([cc[:1], cc[-(flen - 1):][::-1]])  # a-b <= 0
            block = toeplitz(col, row)
            big_g[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = block
            if i != j:
                big_g[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = block.T

    d = g_re.reshape(s * flen)
    try:
        c = np.linalg.solve(big_g, d)
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(big_g, d, rcond=None)[0]
    c = c.reshape(s, flen)

    # filtered references
    cf = np.fft.rfft(c, n=n_fft, axis=1)
    proj_each = np.fft.irfft(cf * rf, n=n_fft, axis=1)[:, : t + flen - 1]
    return proj_each


def _bss_decomp(ref: np.ndarray, est: np.ndarray, j_true: int, flen: int):
    """Decompose est into s_target + e_interf + e_artif w.r.t. ref[j_true]."""
    t = ref.shape[1]
    # projection onto delayed versions of the true source only
    s_target = _compute_projections(ref[j_true: j_true + 1], est, flen).sum(axis=0)
    # projection onto all sources
    proj_all = _compute_projections(ref, est, flen).sum(axis=0)
    e_interf = proj_all - s_target
    est_pad = np.zeros(t + flen - 1)
    est_pad[:t] = est
    e_artif = est_pad - proj_all
    return s_target, e_interf, e_artif


def _ratios(s_target, e_interf, e_artif, eps=np.finfo(np.float64).eps):
    sdr = 10 * np.log10(
        (np.sum(s_target**2) + eps) / (np.sum((e_interf + e_artif) ** 2) + eps)
    )
    sir = 10 * np.log10(
        (np.sum(s_target**2) + eps) / (np.sum(e_interf**2) + eps)
    )
    sar = 10 * np.log10(
        (np.sum((s_target + e_interf) ** 2) + eps) / (np.sum(e_artif**2) + eps)
    )
    return sdr, sir, sar


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    filter_length: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BSS-eval 'sources' metrics with PIT over permutations.

    reference_sources, estimated_sources: [S, T].  Returns (sdr, sir, sar,
    perm) for the permutation maximizing mean SIR (mir_eval convention).
    """
    ref = np.asarray(reference_sources, np.float64)
    est = np.asarray(estimated_sources, np.float64)
    if ref.ndim == 1:
        ref = ref[None]
    if est.ndim == 1:
        est = est[None]
    s = ref.shape[0]

    sdr = np.empty((s, s))
    sir = np.empty((s, s))
    sar = np.empty((s, s))
    for j_est in range(s):
        for j_true in range(s):
            parts = _bss_decomp(ref, est[j_est], j_true, filter_length)
            sdr[j_est, j_true], sir[j_est, j_true], sar[j_est, j_true] = _ratios(
                *parts
            )

    best_perm, best_sir = None, -np.inf
    for perm in itertools.permutations(range(s)):
        mean_sir = np.mean([sir[i, perm[i]] for i in range(s)])
        if mean_sir > best_sir:
            best_sir = mean_sir
            best_perm = perm
    idx = np.arange(s)
    perm = np.asarray(best_perm)
    return sdr[idx, perm], sir[idx, perm], sar[idx, perm], perm


def sdri_np(
    est: np.ndarray, src: np.ndarray, mixture: np.ndarray
) -> Tuple[float, np.ndarray]:
    """SDR improvement (criterions.py:262-289): bss_eval(est) vs
    bss_eval(mixture replicated per speaker)."""
    spks = est.shape[0]
    sdr_out, _, _, _ = bss_eval_sources(src, est)
    mix_stack = np.stack([mixture] * spks)
    sdr_in, _, _, _ = bss_eval_sources(src, mix_stack)
    diff = sdr_out - sdr_in
    return float(diff.mean()), diff
