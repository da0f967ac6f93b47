"""Long-form serving: chunked overlap-add separation (numpy only).

The port's copy of the JAX package's ``serving.py``.  The global
attention runs at T/2^R frames, so a full-context forward grows
quadratically with duration; this module processes fixed-length
overlapping chunks instead, at linear cost and constant memory:

- every chunk has the same length, and the chunks go through the
  separator in batches of ``batch_size`` (the ragged last batch padded);
- separation is permutation-invariant per forward, so consecutive chunks
  may emit the speakers in another order: each chunk is re-aligned by
  correlating its overlap with the previous chunk's aligned estimate
  (the standard continuous-separation stitch, cf. asteroid's
  LambdaOverlapAdd);
- chunks are blended with a linear cross-fade over the overlap, which
  sums to exactly 1 at a uniform hop.

The reference always runs whole utterances (engine.py:152-172); this is
a serving-mode approximation whose accuracy against full context depends
on the chunk capturing enough context (8 s = twice the 4 s training
crop).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np

ForwardBatch = Callable[[np.ndarray], np.ndarray]
"""[N, C] float32 mixture chunks -> [N, spks, C] separated chunks."""
FullContext = Callable[[np.ndarray], np.ndarray]
"""[T] float32 mixture -> [spks, T], the whole input in one forward."""


def chunk_starts(total: int, chunk_len: int, hop: int) -> list[int]:
    """Start offsets covering [0, total) with a final chunk flush against
    the end (so no tail is processed with more padding than necessary)."""
    if total <= chunk_len:
        return [0]
    starts = list(range(0, total - chunk_len, hop))
    starts.append(total - chunk_len)
    return starts


def _crossfade_weights(chunk_len: int, overlap_in: int, overlap_out: int):
    w = np.ones(chunk_len, np.float64)
    if overlap_in > 0:
        w[:overlap_in] = np.linspace(0.0, 1.0, overlap_in, endpoint=False)
    if overlap_out > 0:
        w[chunk_len - overlap_out:] = np.linspace(
            1.0, 0.0, overlap_out, endpoint=False
        )
    return w


def align_permutation(prev_tail: np.ndarray, cur_head: np.ndarray):
    """Speaker order of ``cur_head`` [S, L] that best matches
    ``prev_tail`` [S, L] by total normalized correlation; returns the
    permutation tuple p with cur[p[k]] ~ prev[k]."""
    s = prev_tail.shape[0]

    def ncc(a, b):
        denom = np.linalg.norm(a) * np.linalg.norm(b) + 1e-12
        return float(np.dot(a, b) / denom)

    scores = np.array([[ncc(prev_tail[i], cur_head[j]) for j in range(s)]
                       for i in range(s)])
    best, best_score = None, -np.inf
    for perm in itertools.permutations(range(s)):
        sc = sum(scores[i, perm[i]] for i in range(s))
        if sc > best_score:
            best, best_score = perm, sc
    return best


def separate_chunked(
    forward_batch: ForwardBatch,
    wav: np.ndarray,
    chunk_len: int,
    hop: Optional[int] = None,
    batch_size: int = 8,
) -> np.ndarray:
    """Separate a long mono waveform in overlapping chunks.

    forward_batch: batched single-chunk separator (static chunk shape).
    wav: [T] float32.  chunk_len: samples per chunk.  hop: chunk stride
    (default chunk_len // 2, i.e. 50% overlap).  Returns [spks, T].
    """
    wav = np.asarray(wav, np.float32)
    t = wav.shape[0]
    hop = hop or chunk_len // 2
    if not 0 < hop <= chunk_len:
        raise ValueError(f"hop {hop} must be in (0, {chunk_len}]")
    starts = chunk_starts(t, chunk_len, hop)

    # batch all chunks through the device at one shape
    padded = np.pad(wav, (0, max(0, starts[-1] + chunk_len - t)))
    chunks = np.stack([padded[s:s + chunk_len] for s in starts])
    ests = []
    for i in range(0, len(starts), batch_size):
        batch = chunks[i:i + batch_size]
        if batch.shape[0] < batch_size and len(starts) > batch_size:
            # keep the batch shape: pad the ragged final batch
            pad_n = batch_size - batch.shape[0]
            out = np.asarray(forward_batch(
                np.concatenate([batch, np.zeros((pad_n, chunk_len),
                                                np.float32)])
            ))[:batch.shape[0]]
        else:
            out = np.asarray(forward_batch(batch))
        ests.append(out)
    est = np.concatenate(ests, axis=0)  # [N, S, C]
    n, s, _ = est.shape

    out = np.zeros((s, padded.shape[0]), np.float64)
    wsum = np.zeros(padded.shape[0], np.float64)
    prev_aligned = None
    prev_start = 0
    for i, start in enumerate(starts):
        cur = est[i]
        if prev_aligned is not None:
            ov = prev_start + chunk_len - start
            perm = align_permutation(
                prev_aligned[:, chunk_len - ov:], cur[:, :ov]
            )
            cur = cur[list(perm)]
        overlap_in = 0 if i == 0 else prev_start + chunk_len - start
        overlap_out = (0 if i == n - 1
                       else start + chunk_len - starts[i + 1])
        w = _crossfade_weights(chunk_len, overlap_in, overlap_out)
        out[:, start:start + chunk_len] += cur * w
        wsum[start:start + chunk_len] += w
        prev_aligned, prev_start = cur, start
    out = out / np.maximum(wsum, 1e-12)
    return out[:, :t].astype(np.float32)


def separate_long(forward_batch: ForwardBatch, full_context: FullContext,
                  wav: np.ndarray, chunk_seconds: Optional[float],
                  rate: int, stride: int) -> np.ndarray:
    """The long-form choice of both front ends (``Separator.__call__``
    and ``Engine.infer_sample``): an input longer than ``chunk_seconds``
    goes through :func:`separate_chunked` in chunks cut to the encoder
    ``stride``; any other input, or any input without ``chunk_seconds``,
    through ``full_context``, which pads it as its caller does.  Returns
    [spks, T]."""
    chunk_len = int(chunk_seconds * rate) if chunk_seconds else 0
    if chunk_len and len(wav) > chunk_len:
        return separate_chunked(forward_batch, wav,
                                chunk_len - chunk_len % stride)
    return full_context(wav)
