"""The stateless dropout hash of the train kernels.

A keep mask that is a pure function of (seed, site, row, col): a uint32
avalanche hash, kept iff its top 24 bits reach ``int(p * 2**24)``.  The
kernels (``csrc/softmax_pv_train.cu``) compute it in ``uint32_t``; this
plain version is the same arithmetic, bit for bit, as the JAX package's
``ops/pallas/gcfn_train.py::keep_mask``.  PyTorch has no right shift for
uint32 on the CPU, so it runs in int64 and keeps the low 32 bits after
every multiply; each 32-bit product is taken in two 16-bit halves, so no
int64 product overflows.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SITE_MULT = 0x27D4EB2F
ROW_MULT = 0x9E3779B1
COL_MULT = 0x85EBCA77
MIX1 = 0x2C1B3C6D
MIX2 = 0x297A2D39


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and c < 2**32."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def threshold(p: float) -> int:
    """The kept hashes are those whose top 24 bits reach this."""
    return int(p * float(1 << 24))


def seed_word(seed: int, site: int) -> int:
    return (int(seed) + site * SITE_MULT) & MASK32


def keep_mask(seed: int, site: int, rows: torch.Tensor, cols: torch.Tensor,
              p: float) -> torch.Tensor:
    """float32 0/1 keep mask of the broadcast of ``rows`` and ``cols``
    (integer tensors of global indices)."""
    r = rows.to(torch.int64) & MASK32
    c = cols.to(torch.int64) & MASK32
    h = _mul32(r, ROW_MULT) ^ _mul32(c, COL_MULT) ^ seed_word(seed, site)
    h = h ^ (h >> 15)
    h = _mul32(h, MIX1)
    h = h ^ (h >> 12)
    h = _mul32(h, MIX2)
    h = h ^ (h >> 15)
    return ((h >> 8) >= threshold(p)).to(torch.float32)
