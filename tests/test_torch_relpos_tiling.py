"""The tiling of K2 (``sepreformer_torch/csrc/relpos.cu``), emulated in
numpy: what the card tests cannot reach here.

The emulation follows the kernel's index arithmetic step by step: the
tile plan (tiles of kR rows, kJ columns and up to kD table columns, a
grid of at most the card's block slots, each block walking tiles
blockIdx.x, blockIdx.x + gridDim.x, ...), the window of a tile's kR +
kJ - 1 offsets staged by each thread's kStage loads (table column
fastest) into the transposed layout win[dd][c], the two windows that
alternate from one tile to the next, and the stores: 16-byte stores
of 4 consecutive j from 4 shared reads where t % 4 == 0, 4-byte ones
otherwise.  The output is a copy, so it must equal the plain version
``materialize_pos_kt_plain`` bit for bit; every element is written
once, every warp's shared reads hit 32 distinct banks, and every
16-byte store is aligned.  The constants are read from the source, so
the emulation cannot drift from it.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.relpos import (
    materialize_pos_kt as jax_materialize_pos_kt,
)
from sepreformer_torch.ops.kernels import materialize_pos_kt_plain

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
          / "csrc" / "relpos.cu").read_text()


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, R, J, D = (constant(n) for n in ("kThreads", "kR", "kJ", "kD"))
W = R + J - 1
STAGE = -(-D * W // THREADS)
WARPS = THREADS // 32
# the card's block slots: six blocks of K2 on each of the H100's 132 SMs,
# as ``chip_smoke.py`` phase 2 reads them there (``relpos.occupancy``)
SLOTS = 6 * 132


def tiles_of(t, d):
    return -(-t // R), -(-t // J), -(-d // D)


def tile_origin(tile, n, d):
    """Tile: (i0, j0, d0, dn)."""
    ni, nj, nd = n
    db, rest = tile % nd, tile // nd
    d0 = db * D
    return (rest // nj) * R, (rest % nj) * J, d0, min(D, d - d0)


def load_window(table, origin, d, maxlen):
    """load_window: each thread's kStage floats (NaN where unused)."""
    i0, j0, d0, dn = origin
    e = np.arange(THREADS)[:, None] + np.arange(STAGE)[None, :] * THREADS
    used = e < dn * W
    c, dd = e // dn, e % dn
    r = np.clip(i0 - j0 + R - 1 - c, -maxlen, maxlen - 1) + maxlen
    flat = table.reshape(-1)
    v = np.full(e.shape, np.nan, np.float32)
    v[used] = flat[(r * d + d0 + dd)[used]]
    return v


def put_window(v, origin):
    """put_window: win[dd][c], kD rows of kW floats (NaN where unset)."""
    dn = origin[3]
    e = np.arange(THREADS)[:, None] + np.arange(STAGE)[None, :] * THREADS
    used = e < dn * W
    win = np.full(D * W, np.nan, np.float32)
    win[((e % dn) * W + e // dn)[used]] = v[used]
    return win


def write_tile(win, origin, out, written, t, d, vec):
    """write_tile<vec>: units (row set, dd, 32-column segment), each one
    warp-wide store; checks banks and alignment."""
    i0, j0, d0, dn = origin
    seg, row_sets = J // 32, (R // 4 if vec else R)
    u = np.arange(row_sets * dn * seg)[:, None]          # [units, 1]
    lane = np.arange(32)[None, :]
    a, b = (lane & 7, lane >> 3) if vec else (lane, 0 * lane)
    js, rest = u % seg, u // seg
    dd, rs = rest % dn, rest // dn
    di = 4 * rs + b if vec else rs + 0 * lane               # [units, 32]
    dj = 32 * js + (4 * a if vec else a)
    i, j = i0 + di, j0 + dj
    src = dd * W + dj - di + R - 1
    width = 4 if vec else 1
    for q in range(width):   # one warp's 32 reads, masked lanes too
        banks = np.sort((src + q) % 32, axis=1)
        assert (np.diff(banks, axis=1) > 0).all()
    ok = (i < t) & (j < t)
    dst = ((i * d + d0 + dd) * t + j)[ok]
    if vec:
        assert (dst % 4 == 0).all()
    flat, count = out.reshape(-1), written.reshape(-1)
    for q in range(width):
        assert np.isfinite(win[src[ok] + q]).all()
        flat[dst + q] = win[src[ok] + q]
        np.add.at(count, dst + q, 1)


def emulate(table, t, maxlen, slots=SLOTS):
    """K2 on a numpy float32 table [2*maxlen, d]: pos_kt [t, d, t]."""
    d = table.shape[1]
    n = tiles_of(t, d)
    tiles = n[0] * n[1] * n[2]
    blocks = min(tiles, slots)
    vec = t % 4 == 0
    out = np.full((t, d, t), np.nan, np.float32)
    written = np.zeros((t, d, t), np.int64)
    for block in range(blocks):
        tile = block
        origin = tile_origin(tile, n, d)
        win = [put_window(load_window(table, origin, d, maxlen), origin),
               None]
        k = 0
        while tile < tiles:
            nxt = tile + blocks
            if nxt < tiles:
                n_origin = tile_origin(nxt, n, d)
                v = load_window(table, n_origin, d, maxlen)
            write_tile(win[k & 1], origin, out, written, t, d, vec)
            if nxt < tiles:
                win[(k + 1) & 1] = put_window(v, n_origin)
                origin = n_origin
            tile, k = nxt, k + 1
    assert (written == 1).all()
    return out


def table_of(maxlen, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2 * maxlen, d)).astype(np.float32)


def test_constants_fit_the_kernel():
    """The window's staging covers it, the vector path's lane layout
    covers whole row quads and 32-column segments."""
    assert J % 32 == 0 and R % 4 == 0 and THREADS % 32 == 0
    assert STAGE * THREADS >= D * W > (STAGE - 1) * THREADS
    assert 2 * D * W * 4 <= 48 * 1024


# t % 4 in {0, 1, 3}; t under one tile; t > 2 * maxlen, where both clips
# act; t 512 and 1024 with maxlen 2000 (the route's shapes: at 1024 the
# card's slots hold fewer blocks than tiles, so some blocks walk two tiles
# through both windows); d past one table-column slice and d not a
# multiple of it; slots 3 makes every block walk several tiles
CASES = [(64, 40, 16, SLOTS), (65, 40, 16, SLOTS), (67, 20, 8, SLOTS),
         (5, 10, 16, SLOTS), (20, 3, 4, SLOTS), (100, 20, 16, 3),
         (99, 20, 20, 3), (512, 2000, 16, SLOTS), (1024, 2000, 16, SLOTS),
         (76, 8, 33, 5)]


@pytest.mark.parametrize("t,maxlen,d,slots", CASES)
def test_k2_tiling_is_bit_equal_to_plain(t, maxlen, d, slots):
    table = table_of(maxlen, d, 1000 * t + d)
    got = emulate(table, t, maxlen, slots)
    ref = materialize_pos_kt_plain(torch.from_numpy(table), t, maxlen)
    np.testing.assert_array_equal(got, ref.numpy())


def test_k2_tiling_matches_the_jax_kernel():
    t, maxlen, d = 40, 16, 8
    table = table_of(maxlen, d, 7)
    got = emulate(table, t, maxlen, 3)
    ref = jax_materialize_pos_kt(jnp.asarray(table), t, maxlen, True)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("per_sm", [6, 8])
def test_plan_at_the_route_shapes(per_sm):
    """pos_kt [512, 16, 512] and [1024, 16, 1024] (8 s chunks): 256 and
    1024 tiles.  At six blocks per SM (the card's count) t 512 takes one
    tile a block and t 1024 792 blocks, 232 of them walking two tiles; at
    eight, both take one tile a block."""
    slots = per_sm * 132
    for t, tiles in ((512, 256), (1024, 1024)):
        n = tiles_of(t, 16)
        assert n[0] * n[1] * n[2] == tiles
        blocks = min(tiles, slots)
        walks = [len(range(b, tiles, blocks)) for b in range(blocks)]
        assert sum(walks) == tiles and max(walks) == -(-tiles // blocks)
        if per_sm == 6 and t == 1024:
            assert blocks == 792 and walks.count(2) == 232
