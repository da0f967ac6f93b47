"""Time-axis resampling of [B, T, F] tensors (EGA pooling, U-Net skips and
aux heads), with PyTorch's semantics: the adaptive pool averages
input[floor(i*T/o) : ceil((i+1)*T/o)), nearest upsampling picks
input[floor(i * T_in / T_out)] (index computed in float64, as the JAX
package does)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def adaptive_avg_pool_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    b, t, f = x.shape
    if t == out_len:
        return x
    if t % out_len == 0:
        return x.reshape(b, out_len, t // out_len, f).mean(dim=2)
    return F.adaptive_avg_pool1d(x.transpose(1, 2), out_len).transpose(1, 2)


def nearest_upsample_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    t = x.shape[1]
    if t == out_len:
        return x
    if out_len % t == 0:
        return torch.repeat_interleave(x, out_len // t, dim=1)
    idx = np.floor(np.arange(out_len) * t / out_len).astype(np.int64)
    return x.index_select(1, torch.from_numpy(idx).to(x.device))
