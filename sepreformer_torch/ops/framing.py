"""Strided-conv front-end and overlap-add back-end, channels-last.

The encoder Conv1d(1 -> N, kernel K, stride S, no bias) is framing plus
one [.., K] x [K, N] matrix product; the decoder ConvTranspose1d(N -> 1,
K, S, no bias) is its adjoint.  Weight layouts follow the JAX package's
public functions ([K, N] and [N, K]) so the two compare like with like.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def encoder_conv(x: torch.Tensor, weight: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """x [B, T] waveform, weight [K, N] -> [B, T', N] with
    T' = (T - K) // stride + 1."""
    kernel = weight.shape[0]
    if kernel % stride != 0:
        raise ValueError(
            f"kernel {kernel} must be a multiple of stride {stride}")
    if x.shape[-1] % stride != 0:
        raise ValueError(
            f"signal length {x.shape[-1]} must be a multiple of stride "
            f"{stride}")
    frames = x.unfold(-1, kernel, stride)              # [B, T', K]
    return torch.matmul(frames, weight)


def decoder_overlap_add(h: torch.Tensor, weight: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """h [B, T', N], weight [N, K] -> [B, (T'-1)*stride + K], identical to
    ConvTranspose1d(N, 1, K, stride, bias=False), as the JAX package's
    ``decoder_overlap_add`` computes it: one product to the frames, then
    their overlap-add (``F.fold``, which sums each output sample's K /
    stride frames in a fixed order).  On the card it gives the same bits
    on every call; cuDNN's transposed convolution did not (two calls of a
    Base forward differed in the last bit of the audio)."""
    kernel = weight.shape[1]
    if kernel % stride != 0:
        raise ValueError(
            f"kernel {kernel} must be a multiple of stride {stride}")
    b, t_frames, _ = h.shape
    frames = torch.matmul(h, weight)                    # [B, T', K]
    out = F.fold(frames.transpose(1, 2),
                 output_size=(1, (t_frames - 1) * stride + kernel),
                 kernel_size=(1, kernel), stride=(1, stride))
    return out[:, 0, 0]
