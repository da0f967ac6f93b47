"""K15 and K16 at Large's F = 256 (``sepreformer_torch/csrc/cla.cu`` and
the ``kPair`` prologue of ``csrc/gcfn_tile_mma.cuh``), emulated in numpy:
what the card tests cannot reach here.

The plans, from the sources' layouts: K15's two launches take 202 KB
(the GLU launch: xn and two W_in buffers) and 196.5 KB (the tail: the
128-row window of v, then the weights) at F = 256, one block per SM each
where Base's take two; the conv gives each thread one channel over all
64 rows of a tile (R = 64: acc[64] and win[64]) and the o product 64
accumulators a thread.  K16 at F = 256 takes K1's 199 KB tile, one block
per SM; the gate's wg passes through wi in four parts of 64 columns (two
at F = 128), and y [64][264], larger than wo and u, lies over wi, each
part's y held in registers (64 floats a thread) until the last part is
read.  The emulations: K15's conv as the kernel's sliding register
window over R rows, bit-equal to the taps in order; the gate product
part by part, bit-equal to one product; and both tiles at F = 256 as
the tensor cores take their products, whose 3xTF32 result must err by
under 1e-6 of max|out| from float64 and one TF32 product by over 1e-4.
"""

import pathlib
import re

import numpy as np
import pytest

from test_torch_tf32x3 import (
    cla_f64,
    cla_tile,
    ega_tail_f64,
    ega_tail_tile,
    gcfn_f64,
    gcfn_tile,
    mma_product,
)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch" / \
    "csrc"
CLA, TILE, PAIR = ((CSRC / name).read_text() for name in (
    "cla.cu", "gcfn_tile_mma.cuh", "ega_gcfn.cu"))
SM_BYTES, BLOCK_MAX, TWO_BLOCKS = 228 * 1024, 227 * 1024, 113 * 1024


def constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CLA_TT, CLA_CH, CLA_THREADS, CLA_K = (constant(CLA, n) for n in (
    "kTT", "kCH", "kThreads", "kK"))
TT, CH, THREADS = (constant(TILE, n) for n in ("kTT", "kCH", "kThreads"))
THREE, ONE = ("a_small", "b_small", "big"), ("big",)


def cla_plan(f):
    """cla.cu's GluShape<F> and TailShape<F>: shared-memory bytes and
    blocks per SM of each launch, the conv's rows a thread, threads a
    channel and window rows, and the o product's floats a thread."""
    nc, warps = 2 * CLA_CH, CLA_THREADS // 32
    glu = 4 * (CLA_TT * (f + 8) + 2 * f * (nc + 4))
    window = CLA_TT + CLA_K - 1
    weights = max(f * (CLA_CH + 4) + CLA_CH * (f + 4), f * CLA_K)
    tail = 4 * (window * f + weights)
    own = 4
    o_floats = (CLA_TT // 16 // (warps // own)) * (f // 8 // own) * 4
    return dict(glu=glu, tail=tail,
                glu_blocks=2 if glu <= TWO_BLOCKS else 1,
                tail_blocks=2 if tail <= TWO_BLOCKS else 1,
                rows=CLA_TT * f // CLA_THREADS,
                threads_per_channel=CLA_THREADS // f, window=window,
                o_floats=o_floats)


def pair_plan(f):
    """gcfn_tile_mma.cuh's Shape<F> for K16: bytes, blocks per SM, wg's
    parts, where y lies, and the y floats a thread holds."""
    r, nc = TT + 2, 2 * CH
    lx, lw, lo, lu, lg, ly = f + 8, nc + 4, f + 4, nc + 8, CH + 8, f + 8
    wi = r * lx
    wo = wi + f * lw
    g = wo + CH * lo + r * lu
    smem = 4 * (g + r * lg)
    y_over_wo = wo + r * ly <= g
    warps_m, warps_n = THREADS // 32 // 4, 4
    frag = (r // 16 // warps_m) * (nc // 8 // warps_n) * 4
    return dict(smem=smem, blocks=2 if smem <= TWO_BLOCKS else 1,
                parts=f // nc, y_over_wo=y_over_wo,
                y_fits_wi=r * ly <= f * lw,
                held=0 if y_over_wo else f // nc * frag)


def test_k15_f256_plan():
    base, large = cla_plan(128), cla_plan(256)
    assert (base["glu"], base["tail"]) == (104448, 100864)
    assert (base["glu_blocks"], base["tail_blocks"]) == (2, 2)
    assert (base["rows"], base["threads_per_channel"]) == (32, 2)
    assert (large["glu"], large["tail"]) == (206848, 201216)
    for smem in (large["glu"], large["tail"]):
        assert smem <= BLOCK_MAX and 2 * (smem + 1024) > SM_BYTES
    assert (large["glu_blocks"], large["tail_blocks"]) == (1, 1)
    # one channel a thread over the tile's 64 rows: acc[64] and win[64]
    # in 128 of the 255 registers one block per SM allows
    assert (large["rows"], large["threads_per_channel"]) == (64, 1)
    assert large["window"] == CLA_TT + 64 == 128
    assert (base["o_floats"], large["o_floats"]) == (32, 64)
    for text in ("return bytes <= kTwoBlocks ? 2 : 1;",
                 "__launch_bounds__(kThreads, GluShape<F>::blocks_per_sm)",
                 "__launch_bounds__(kThreads, TailShape<F>::blocks_per_sm)",
                 "if (F == 256) return run(launch<256>);"):
        assert text in CLA, text


def test_k16_f256_plan():
    base, large = pair_plan(128), pair_plan(256)
    assert (base["smem"], base["blocks"], base["parts"]) == (115200, 2, 2)
    assert base["y_over_wo"] and base["held"] == 0
    assert (large["smem"], large["blocks"], large["parts"]) == (199168, 1, 4)
    assert not large["y_over_wo"] and large["y_fits_wi"]
    assert large["held"] == 64
    assert "static constexpr int y = y_over_wo ? wo : wi;" in TILE
    assert "gcfn_mma::Shape<F>::blocks_per_sm)" in PAIR
    assert "if (F == 256) return run(launch<256>);" in PAIR


def fma32(a, b, c):
    """fmaf in float32: a * b is exact in float64, one rounding after."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


@pytest.mark.parametrize("f", [128, 256])
def test_k15_conv_register_window(f):
    """The tail's conv as its threads run it: thread tid takes channel
    tid % F and rows r0 = (tid / F) R .. r0 + R - 1; R window rows slide
    through registers, one new row a tap.  Every (row, channel) once, and
    each output bit-equal to bias + the taps in order."""
    plan = cla_plan(f)
    rows, window = plan["rows"], plan["window"]
    rng = np.random.default_rng(f)
    vw = rng.normal(size=(window, f)).astype(np.float32)
    wdw = (rng.normal(size=(f, CLA_K)) * 0.1).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    y = np.full((CLA_TT, f), np.nan, dtype=np.float32)
    for part in range(CLA_THREADS // f):       # the threads of a channel
        r0 = part * rows
        col = vw[r0:, :]                        # every channel at once
        acc = [bias.copy() for _ in range(rows)]
        win = [col[r] for r in range(rows)]
        for tap in range(CLA_K):
            acc = [fma32(wdw[:, tap], win[r], acc[r]) for r in range(rows)]
            if tap + 1 < CLA_K:
                win = win[1:] + [col[rows + tap]]
        assert np.isnan(y[r0:r0 + rows]).all()  # no row twice
        y[r0:r0 + rows] = np.stack(acc)
    ref = np.broadcast_to(bias, (CLA_TT, f)).astype(np.float32)
    for tap in range(CLA_K):
        ref = fma32(wdw[:, tap], vw[tap:tap + CLA_TT], ref)
    np.testing.assert_array_equal(y, ref)


# T at K15's 64-row tiles: under one tile, one row into a second
@pytest.mark.parametrize("t", [10, 65])
def test_k15_f256_tile_holds_float32_accuracy(t):
    rng = np.random.default_rng(t + 256)
    f, k, b = 256, CLA_K, 1
    h = 2 * f
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.07), ((h,), 0.1),
                     ((k, f), 0.1), ((f,), 0.1), ((f, h), 0.07), ((h,), 0.1),
                     ((h,), 0.1), ((h,), 0.1), ((h, f), 0.07), ((f,), 0.1),
                     ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    params[8] = params[8] + np.float32(1.0)       # bn_s near 1
    ref = cla_f64(x, params, 1e-5)
    scale = np.abs(ref).max()
    errs = [np.abs(cla_tile(x, params, 1e-5, CLA_TT, CLA_CH, terms)
                   - ref).max() / scale for terms in (THREE, ONE)]
    assert errs[0] < 1e-6, errs
    assert errs[1] > 1e-4, errs


def test_k16_gate_parts_are_one_product():
    """wg's four parts of 64 columns, each its own zeroed product as the
    prologue takes them, give the bits of one product over all 256."""
    f, nc = 256, 2 * CH
    rng = np.random.default_rng(4)
    xn = rng.normal(size=(TT + 2, f)).astype(np.float32)
    wg = (rng.normal(size=(f, f)) * 0.1).astype(np.float32)
    parts = [mma_product(xn, wg[:, p * nc:(p + 1) * nc], THREE)
             for p in range(pair_plan(f)["parts"])]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1),
                                  mma_product(xn, wg, THREE))


# (T, L) at the tile's 62 rows: T one row into a second tile (r = 1),
# B*T under one tile (r = 2)
@pytest.mark.parametrize("t,length", [(63, 63), (10, 5)])
def test_k16_f256_tile_holds_float32_accuracy(t, length):
    rng = np.random.default_rng(t + length + 256)
    f, b = 256, 1
    h = 6 * f
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    xd = rng.normal(size=(b, length, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, f), 0.07), ((f,), 0.1),
                     ((f,), 1.0), ((f,), 1.0), ((f, h), 0.07), ((h,), 0.1),
                     ((h, 3), 0.3), ((h,), 0.1), ((h // 2, f), 0.07),
                     ((f,), 0.1), ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    gate, gcfn = params[:4], params[4:]
    lens = (t,) * b
    ref = gcfn_f64(ega_tail_f64(x, xd, gate, 1e-5), gcfn, 1e-5, lens)
    scale = np.abs(ref).max()
    errs = []
    for terms in (THREE, ONE):
        y = ega_tail_tile(x, xd, gate, 1e-5, terms)
        out = gcfn_tile(y, gcfn, 1e-5, lens, TT, CH, terms)
        errs.append(np.abs(out - ref).max() / scale)
    assert errs[0] < 1e-6, errs
    assert errs[1] > 1e-4, errs
