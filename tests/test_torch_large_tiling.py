"""K1's F = 256 instance (``sepreformer_torch/csrc/gcfn_tile_mma.cuh``),
emulated in numpy: what the card tests cannot reach here.

The tile is the one ``tests/test_torch_tf32x3.py`` emulates at Base's
F = 128 (62-row tiles with a halo row on each side, chunks of 32 GLU
pairs, both products as 3xTF32 m16n8k8 steps from zeroed fragments added
to float32 sums), at Large's F = 256: 24 chunks of the hidden width, a
256-deep u product, and o [64, 256] in float32.  Against float64 the
three products must err by under 1e-6 of max|out| and one TF32 product
by over 1e-4.  The plan: the tile's shared memory, from the header's
layout, holds two blocks per SM at F = 128 (113 KB) and one at F = 256
(199 KB, under the 227 KB a block may take), the o accumulators a
thread keeps (64 floats at F = 256), and the chunk and copy counts the
header's loops take.
"""

import pathlib
import re

import numpy as np
import pytest

from test_torch_tf32x3 import gcfn_f64, gcfn_tile

HEADER = (pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
          / "csrc" / "gcfn_tile_mma.cuh").read_text()


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


TT, CH, THREADS = constant("kTT"), constant("kCH"), constant("kThreads")
SM_BYTES, BLOCK_MAX = 228 * 1024, 227 * 1024


def plan(f):
    """The header's Shape<F>: shared-memory bytes, blocks per SM, o's
    floats per thread, chunks, and 16-byte copies per thread of a win and
    a wout chunk."""
    r, nc = TT + 2, 2 * CH
    lx, lw, lo, lu, lg = f + 8, nc + 4, f + 4, nc + 8, CH + 8
    floats = r * lx + f * lw + CH * lo + r * lu + r * lg
    smem = 4 * floats
    blocks = 2 if smem <= 113 * 1024 else 1
    warps_m, warps_n = THREADS // 32 // 4, 4
    o_floats = (r // 16 // warps_m) * (f // 8 // warps_n) * 4
    return dict(smem=smem, blocks=blocks, o_floats=o_floats,
                chunks=3 * f // CH, win_copies=f * nc / 4 / THREADS,
                wout_copies=CH * f / 4 / THREADS)


def test_f256_plan():
    base, large = plan(128), plan(256)
    assert (base["smem"], base["blocks"], base["o_floats"]) == (115200, 2, 32)
    assert large["smem"] <= BLOCK_MAX and 2 * (large["smem"] + 1024) > SM_BYTES
    assert (large["smem"], large["blocks"], large["o_floats"]) == (199168, 1,
                                                                   64)
    assert large["chunks"] == 24
    assert large["win_copies"] == 16 and large["wout_copies"] == 8
    assert "blocks_per_sm = smem_bytes <= 113 * 1024 ? 2 : 1" in HEADER


# (T, lengths) at the tile's 62 rows: T one row into a second tile with a
# length mid-tile, T a multiple of the tile with a length on its edge, B*T
# under one tile
@pytest.mark.parametrize("t,lens", [(63, (63, 31)), (124, (124, 62)),
                                    (10, (10, 7))])
def test_f256_tile_holds_float32_accuracy(t, lens):
    rng = np.random.default_rng(t + 256)
    f = 256
    h = 6 * f
    b = len(lens)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.07), ((h,), 0.1),
                     ((h, 3), 0.3), ((h,), 0.1), ((h // 2, f), 0.07),
                     ((f,), 0.1), ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    ref = gcfn_f64(x, params, 1e-5, lens)
    scale = np.abs(ref).max()
    three = gcfn_tile(x, params, 1e-5, lens, TT, CH,
                      ("a_small", "b_small", "big"))
    one = gcfn_tile(x, params, 1e-5, lens, TT, CH, ("big",))
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1
