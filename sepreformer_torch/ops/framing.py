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
    ConvTranspose1d(N, 1, K, stride, bias=False)."""
    kernel = weight.shape[1]
    if kernel % stride != 0:
        raise ValueError(
            f"kernel {kernel} must be a multiple of stride {stride}")
    out = F.conv_transpose1d(h.transpose(1, 2), weight[:, None, :],
                             stride=stride)
    return out[:, 0]
