"""The accuracy argument of ``sepreformer_torch/csrc/mma_tf32x3.cuh``,
emulated in numpy: why K1, K7, K8 and K12 take their products on the
tensor cores as three TF32 products ("3xTF32") and not one.

The header splits a float32 x into big = x rounded to TF32 (10 mantissa
bits, round to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
rounds) and small = x - big, whose 13 low bits the tensor core drops
(TF32 toward zero), and takes a·b as a_small·b_big + a_big·b_small +
a_big·b_big per m16n8k8 step, into float32 accumulators.
Here each step's products are exact (two 11-bit significands fit float32)
and summed in float64, then rounded to float32 and added to the float32
accumulator, in the header's order.  Against float64, at K12's depth (the
head width 16) and K8's (the hidden width 768), the three products must
err by under 1e-6 of the largest |result|, which holds the kernels' card
tests and the smoke's limits (rtol 1e-4, 3e-5 of max|out|) with room;
one TF32 product must err by more than 1e-4 of it, which is why plain
TF32 cannot pass them.  The same holds for K1's whole tile
(``csrc/gcfn_tile_mma.cuh``), emulated row tile by row tile and chunk by
chunk at its height (62 rows) and chunk width (32 GLU pairs).
"""

import numpy as np
import pytest


def to_tf32(x):
    """float32 -> float32 with 10 mantissa bits, nearest, ties away."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x):
    """float32 -> TF32 by dropping the 13 low bits, as the tensor core
    reads an operand."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = to_tf32(x)
    return big, toward_zero(np.float32(x) - big)


def mma_product(a, b, terms):
    """a [M, K] @ b [K, N] as the tensor cores take it: per k-step of 8,
    each (a part, b part) product in ``terms`` added to a float32
    accumulator in turn."""
    (ab, as_), (bb, bs) = split(a), split(b)
    parts = {"big": (ab, bb), "a_small": (as_, bb), "b_small": (ab, bs)}
    c = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k0 in range(0, a.shape[1], 8):
        for term in terms:
            pa, pb = parts[term]
            step = (pa[:, k0:k0 + 8].astype(np.float64)
                    @ pb[k0:k0 + 8].astype(np.float64))
            c = c + step.astype(np.float32)
    return c


def test_tf32_rounds_to_nearest_with_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's spacing at 1
    x = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                  1 + 3 * 2 ** -11, 3.0], dtype=np.float32)
    np.testing.assert_array_equal(
        to_tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                              3.0], dtype=np.float32))
    rng = np.random.default_rng(3)
    v = rng.normal(size=4096).astype(np.float32)
    big, small = split(v)
    # the low 13 bits of both parts are zero, big is within half a TF32
    # unit of the value, and together they keep about 21 bits of it
    assert not np.any(big.view(np.uint32) & 0x1FFF)
    assert not np.any(small.view(np.uint32) & 0x1FFF)
    assert np.all(np.abs(v - big) <= np.abs(v) * 2.0 ** -11)
    rel = np.abs((big.astype(np.float64) + small) - v) / np.abs(v)
    assert rel.max() < 2.0 ** -20


@pytest.mark.parametrize("depth", [16, 768])
def test_three_tf32_products_hold_float32_accuracy(depth):
    rng = np.random.default_rng(depth)
    a = rng.normal(size=(64, depth)).astype(np.float32)
    b = rng.normal(size=(depth, 64)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    three = mma_product(a, b, ("a_small", "b_small", "big"))
    one = mma_product(a, b, ("big",))
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1


def gcfn_f64(x, params, eps, lens):
    """The GCFN forward with the u-row length mask, in float64."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = (
        p.astype(np.float64) for p in params)
    x = x.astype(np.float64)
    c = x - x.mean(-1, keepdims=True)
    xn = c / np.sqrt((c * c).mean(-1, keepdims=True) + eps) * lns + lnb
    u = xn @ win + bin_
    t = x.shape[1]
    u = u * (np.arange(t)[None, :, None] < np.asarray(lens)[:, None, None])
    up = np.pad(u, ((0, 0), (1, 1), (0, 0)))
    y = (up[:, :t] * wdw[:, 0] + up[:, 1:t + 1] * wdw[:, 1]
         + up[:, 2:] * wdw[:, 2] + bdw)
    half = y.shape[-1] // 2
    g = y[..., :half] / (1.0 + np.exp(-y[..., half:]))
    return x + ls * (g @ wout + bout)


def gcfn_tile(x, params, eps, lens, tt, ch, terms):
    """K1's tile (``csrc/gcfn_tile_mma.cuh``) in numpy: per batch row,
    tiles of ``tt`` rows with one halo row on each side (rows outside
    [0, T) zero); LayerNorm in float32; per chunk of ``ch`` GLU pairs,
    u = xn win_c as the tensor cores take it (``terms``, from zeroed
    fragments) + bin with rows outside [0, lens[b]) zero, then the k3
    conv and the GLU in float32, then o += g_c wout_c (a zeroed product
    per chunk, added to o in float32); out = x + ls (o + bout)."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    b, t, f = x.shape
    h3 = 3 * f
    out = np.empty_like(x)
    for bi in range(b):
        valid = min(lens[bi], t)
        for t0 in range(0, t, tt):
            rows = np.arange(t0 - 1, t0 + tt + 1)
            inside = (rows >= 0) & (rows < t)
            xr = np.where(inside[:, None], x[bi, np.clip(rows, 0, t - 1)],
                          np.float32(0))
            c = xr - xr.mean(-1, keepdims=True, dtype=np.float32)
            inv = 1 / np.sqrt((c * c).mean(-1, keepdims=True) + np.float32(eps))
            xn = np.where(inside[:, None], c * inv * lns + lnb, np.float32(0))
            keep = ((rows >= 0) & (rows < valid))[:, None]
            o = np.zeros((tt + 2, f), dtype=np.float32)
            for c0 in range(0, h3, ch):
                cols = np.r_[c0:c0 + ch, h3 + c0:h3 + c0 + ch]
                u = np.where(keep, mma_product(xn, win[:, cols], terms)
                             + bin_[cols], np.float32(0))
                w = wdw[cols]
                y = u[:-2] * w[:, 0] + u[1:-1] * w[:, 1] + u[2:] * w[:, 2]
                y = y + bdw[cols]
                g = y[:, :ch] / (np.float32(1) + np.exp(-y[:, ch:]))
                g = np.pad(g, ((0, 2), (0, 0)))     # the fragments' padding
                o = o + mma_product(g, wout[c0:c0 + ch], terms)
            n = min(tt, t - t0)
            out[bi, t0:t0 + n] = x[bi, t0:t0 + n] + ls * (o[:n] + bout)
    return out


# (T, lengths) at the tile's 62 rows: T one row into a second tile with a
# length mid-tile, T a multiple of the tile with a length on its edge, T
# one row past it with a length one row past an edge, B*T under one tile
@pytest.mark.parametrize("t,lens", [(63, (63, 31)), (124, (124, 62)),
                                    (125, (125, 63)), (10, (10, 7))])
def test_gcfn_tile_holds_float32_accuracy(t, lens):
    rng = np.random.default_rng(t)
    f = 128
    h = 6 * f
    b = len(lens)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((h, 3), 0.3), ((h,), 0.1), ((h // 2, f), 0.1),
                     ((f,), 0.1), ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    ref = gcfn_f64(x, params, 1e-5, lens)
    scale = np.abs(ref).max()
    three = gcfn_tile(x, params, 1e-5, lens, 62, 32,
                      ("a_small", "b_small", "big"))
    one = gcfn_tile(x, params, 1e-5, lens, 62, 32, ("big",))
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1
