"""K2: the rel-pos table materializer.

Replaces ``sepreformer_tpu/ops/pallas/relpos.py::materialize_pos_kt``.
The CUDA kernel is ``sepreformer_torch/csrc/relpos.cu``;
``materialize_pos_kt_plain`` is the gather it computes (the JAX
package's ``blocks.gather_pos_kt``).
"""

from __future__ import annotations

import numpy as np
import torch

from sepreformer_torch.ops.kernels import _build


def relpos_index(t: int, maxlen: int) -> np.ndarray:
    """[t, t] table row of pos_kt[i, :, j]: clip(i - j) + maxlen."""
    pos = np.arange(t)
    return np.clip(pos[:, None] - pos[None, :], -maxlen, maxlen - 1) + maxlen


def materialize_pos_kt_plain(table: torch.Tensor, t: int,
                             maxlen: int) -> torch.Tensor:
    """[t, d, t] with out[i, :, j] = table[clip(i - j, -maxlen, maxlen-1)
    + maxlen]."""
    idx = torch.from_numpy(relpos_index(t, maxlen)).to(table.device)
    return table[idx].permute(0, 2, 1).contiguous()


def materialize_pos_kt(table: torch.Tensor, t: int,
                       maxlen: int) -> torch.Tensor:
    """table [2*maxlen, d] float32 -> pos_kt [t, d, t].  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if table.device.type == "cpu":
        return materialize_pos_kt_plain(table, t, maxlen)
    n, d = table.shape
    if n != 2 * maxlen:
        raise ValueError(f"materialize_pos_kt: table rows {n} != 2*{maxlen}")
    _build.check_tensor(table, "materialize_pos_kt table", (n, d),
                        table.device)
    out = torch.empty((t, d, t), dtype=torch.float32, device=table.device)
    err = _build.library().sep_relpos_f32(
        table.data_ptr(), out.data_ptr(), t, d, maxlen,
        _build.stream_handle(table.device))
    _build.check_launch("sep_relpos_f32", err)
    materialize_pos_kt.launches += 1
    return out


materialize_pos_kt.launches = 0
