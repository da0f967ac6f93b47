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
chunk at its height (62 rows) and chunk width (32 GLU pairs), for K16's
tile (the EGA tail's gate product as a prologue, then K1's tile on its
output), for K15's two launches (``csrc/cla.cu``: the GLU launch, then
the k65 conv and two products in chunks), and for K14's rel-pos adjoints
taken as products on a skewed G (``csrc/attention_train.cu``); K15's
tile and K14's adjoints are also held against the plain version.
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


def ega_tail_f64(x, xd, gate, eps):
    """K16's EGA tail in float64: x + sigmoid(LN_g(x) wg + bg) times the
    nearest upsample of x_down."""
    gns, gnb, wg, bg = (p.astype(np.float64) for p in gate)
    x = x.astype(np.float64)
    c = x - x.mean(-1, keepdims=True)
    gn = c / np.sqrt((c * c).mean(-1, keepdims=True) + eps) * gns + gnb
    up = np.repeat(xd.astype(np.float64), x.shape[1] // xd.shape[1], axis=1)
    return x + up / (1.0 + np.exp(-(gn @ wg + bg)))


def ega_tail_tile(x, xd, gate, eps, terms):
    """K16's prologue (``csrc/gcfn_tile_mma.cuh``, kPair) in numpy: LN_g
    in float32, the gate product as the tensor cores take it (``terms``),
    y = x + sigmoid(. + bg) * x_down[t // r] in float32.  Each row is the
    same whichever tile computes it, halo rows included."""
    gns, gnb, wg, bg = gate
    c = x - x.mean(-1, keepdims=True, dtype=np.float32)
    xn = c / np.sqrt((c * c).mean(-1, keepdims=True) + np.float32(eps))
    xn = xn * gns + gnb
    z = np.stack([mma_product(row, wg, terms) for row in xn]) + bg
    r = x.shape[1] // xd.shape[1]
    up = xd[:, np.arange(x.shape[1]) // r]
    return x + up / (np.float32(1) + np.exp(-z))


# (T, L) at the tile's 62 rows: T one row into a second tile (r = 1), two
# whole tiles (r = 2), B*T under one tile (r = 2)
@pytest.mark.parametrize("t,length", [(63, 63), (124, 62), (10, 5)])
def test_pair_tile_holds_float32_accuracy(t, length):
    rng = np.random.default_rng(t + length)
    f, b = 128, 2
    h = 6 * f
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    xd = rng.normal(size=(b, length, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, f), 0.1), ((f,), 0.1),
                     ((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((h, 3), 0.3), ((h,), 0.1), ((h // 2, f), 0.1),
                     ((f,), 0.1), ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    gate, gcfn = params[:4], params[4:]
    lens = (t,) * b
    ref = gcfn_f64(ega_tail_f64(x, xd, gate, 1e-5), gcfn, 1e-5, lens)
    scale = np.abs(ref).max()
    errs = []
    for terms in (("a_small", "b_small", "big"), ("big",)):
        y = ega_tail_tile(x, xd, gate, 1e-5, terms)
        out = gcfn_tile(y, gcfn, 1e-5, lens, 62, 32, terms)
        errs.append(np.abs(out - ref).max() / scale)
    assert errs[0] < 1e-6, errs
    assert errs[1] > 1e-4, errs


def attention_g_f64(q, k, v, dout, table, maxlen):
    """G = P (dP - rowsum(dP P)) / sqrt(d) of the rel-pos attention (no
    dropout, every key valid), and pe[i][j] = table[clip(i - j) +
    maxlen], in float64."""
    length, d = q.shape
    pos = np.arange(length)
    pe = table.astype(np.float64)[
        np.clip(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen]
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    s = (q64 @ k64.T + np.einsum("id,ijd->ij", q64, pe)) / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = dout.astype(np.float64) @ v.astype(np.float64).T
    return p * (dp - (dp * p).sum(-1, keepdims=True)) / np.sqrt(d), pe


def skewed_adjoints(g, q, table, maxlen, terms, tile=64):
    """K14's rel-pos adjoints (``csrc/attention_train.cu``, the dq launch)
    in numpy, per (query tile, key tile): G_skew[ii][ii - jj + 63] =
    G[ii][jj] (zero elsewhere), the tile's band of 128 clamped table rows
    from offset i0 - j0 - 63; dq += G_skew · band and the frame of band
    sums G_skewᵀ · Q, each as the tensor cores take it (``terms``), each
    tile's product added in float32; the frames summed into the table
    rows of their offsets."""
    length, d = q.shape
    dq = np.zeros((length, d), dtype=np.float32)
    dtable = np.zeros((2 * maxlen, d), dtype=np.float64)
    rr = np.arange(tile)
    for i0 in range(0, length, tile):
        qt = q[i0:i0 + tile]
        for j0 in range(0, length, tile):
            gs = np.zeros((tile, 2 * tile), dtype=np.float32)
            gs[rr[:, None], rr[:, None] - rr[None] + tile - 1] = (
                g[i0:i0 + tile, j0:j0 + tile])
            rel = i0 - j0 - (tile - 1) + np.arange(2 * tile)
            rows = np.clip(rel, -maxlen, maxlen - 1) + maxlen
            dq[i0:i0 + tile] += mma_product(gs, table[rows], terms)
            np.add.at(dtable, rows, mma_product(gs.T.copy(), qt, terms))
    return dq, dtable


# maxlen 2000: every band inside the clamp; maxlen 64 at L 128: the bands
# of the (query tile 1, key tile 0) and (0, 1) pairs straddle maxlen - 1
# and -maxlen, so the end rows of the table gather runs of offsets
@pytest.mark.parametrize("maxlen", [2000, 64])
def test_skewed_adjoints_hold_float32_accuracy(maxlen):
    import torch

    from sepreformer_torch.ops.kernels.attention_train import (
        attention_train_bwd_plain,
    )

    rng = np.random.default_rng(maxlen)
    length, d = 128, 16
    q, k, v, dout = (rng.normal(size=(length, d)).astype(np.float32)
                     for _ in range(4))
    table = rng.normal(size=(2 * maxlen, d)).astype(np.float32)
    g, pe = attention_g_f64(q, k, v, dout, table, maxlen)
    # the direct sums: dq_i += sum_j G_ij pe_{i-j}, dtable[r] += G_ij q_i
    # over the pairs whose clamped offset is row r
    dq_rel = np.einsum("ij,ijd->id", g, pe)
    pos = np.arange(length)
    rows = np.clip(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen
    dtable = np.zeros((2 * maxlen, d))
    np.add.at(dtable, rows.reshape(-1),
              (g[:, :, None] * q.astype(np.float64)[:, None]).reshape(-1, d))
    errs = []
    g32 = g.astype(np.float32)
    for terms in (("a_small", "b_small", "big"), ("big",)):
        got_dq, got_dt = skewed_adjoints(g32, q, table, maxlen, terms)
        errs.append(max(np.abs(got_dq - dq_rel).max() / np.abs(dq_rel).max(),
                        np.abs(got_dt - dtable).max() / np.abs(dtable).max()))
    assert errs[0] < 1e-6, errs
    assert errs[1] > 1e-4, errs
    # and the whole dq and dtable against the plain version's
    got_dq, got_dt = skewed_adjoints(g32, q, table, maxlen,
                                     ("a_small", "b_small", "big"))
    got_dq = got_dq + g @ k.astype(np.float64)
    ref = attention_train_bwd_plain(
        *(torch.from_numpy(a)[None, None] for a in (q, k, v)),
        torch.from_numpy(table), maxlen, 0, 0.0, None,
        torch.from_numpy(dout)[None, None])
    for got, want in ((got_dq, ref[0][0, 0].numpy()),
                      (got_dt, ref[3].numpy())):
        assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def cla_f64(x, params, eps):
    """K15's chain (``cla_plain``'s math) in float64; wdw is [k, F]."""
    (lns, lnb, w_in, b_in, wdw, bdw, w_mid, b_mid, bn_s, bn_t, w_out, b_out,
     ls) = (p.astype(np.float64) for p in params)
    from scipy.special import erf

    x = x.astype(np.float64)
    c = x - x.mean(-1, keepdims=True)
    xn = c / np.sqrt((c * c).mean(-1, keepdims=True) + eps) * lns + lnb
    u = xn @ w_in + b_in
    f, t, k = x.shape[-1], x.shape[1], wdw.shape[0]
    v = u[..., :f] / (1.0 + np.exp(-u[..., f:]))
    vp = np.pad(v, ((0, 0), (k // 2, k // 2), (0, 0)))
    y = sum(vp[:, tap:tap + t] * wdw[tap] for tap in range(k)) + bdw
    hv = (y @ w_mid + b_mid) * bn_s + bn_t
    z = 0.5 * hv * (1.0 + erf(hv / np.sqrt(2.0)))
    return x + ls * (z @ w_out + b_out)


def cla_tile(x, params, eps, tt, ch, terms):
    """K15 (``csrc/cla.cu``) in numpy, tile by tile of ``tt`` rows.  The
    GLU launch: LayerNorm in float32, then per chunk of ``ch`` GLU pairs
    (value columns and their gates F later) a zeroed product as the tensor
    cores take it (``terms``), the GLU in float32, into v.  The tail: the
    k65 conv of v with zero rows outside [0, T) in float32 (bias, then the
    taps in order), then per chunk of ``ch`` hidden columns z_c =
    GELU((y W_mid_c + b_mid) s + t) in float32 and o += z_c W_out_c (a
    zeroed product per chunk, added to o in float32); out = x + ls (o +
    b_out)."""
    (lns, lnb, w_in, b_in, wdw, bdw, w_mid, b_mid, bn_s, bn_t, w_out, b_out,
     ls) = params
    from scipy.special import erf

    b, t, f = x.shape
    k = wdw.shape[0]
    v = np.zeros_like(x)
    for bi in range(b):
        for t0 in range(0, t, tt):
            xr = x[bi, t0:t0 + tt]
            c = xr - xr.mean(-1, keepdims=True, dtype=np.float32)
            inv = 1 / np.sqrt((c * c).mean(-1, keepdims=True)
                              + np.float32(eps))
            xn = c * inv * lns + lnb
            for c0 in range(0, f, ch):
                cols = np.r_[c0:c0 + ch, f + c0:f + c0 + ch]
                u = mma_product(xn, w_in[:, cols], terms) + b_in[cols]
                v[bi, t0:t0 + tt, c0:c0 + ch] = (
                    u[:, :ch] / (np.float32(1) + np.exp(-u[:, ch:])))
    vp = np.pad(v, ((0, 0), (k // 2, k // 2), (0, 0)))
    y = np.broadcast_to(bdw, v.shape).astype(np.float32)
    for tap in range(k):
        y = y + wdw[tap] * vp[:, tap:tap + t]
    out = np.empty_like(x)
    for bi in range(b):
        for t0 in range(0, t, tt):
            yr = y[bi, t0:t0 + tt]
            o = np.zeros((len(yr), f), dtype=np.float32)
            for c0 in range(0, 2 * f, ch):
                cols = slice(c0, c0 + ch)
                hv = ((mma_product(yr, w_mid[:, cols], terms) + b_mid[cols])
                      * bn_s[cols] + bn_t[cols])
                z = (np.float32(0.5) * hv
                     * (np.float32(1) + erf(hv * np.float32(0.70710678))))
                o = o + mma_product(z.astype(np.float32), w_out[cols], terms)
            out[bi, t0:t0 + tt] = x[bi, t0:t0 + tt] + ls * (o + b_out)
    return out


# T at K15's 64-row tiles: under one tile, on a tile edge, one row into a
# second tile, and inside the second
@pytest.mark.parametrize("t", [10, 64, 65, 100])
def test_cla_tile_holds_float32_accuracy(t):
    import torch

    from sepreformer_torch.ops.kernels.cla import cla_plain

    rng = np.random.default_rng(t)
    f, k, b = 128, 65, 2
    h = 2 * f
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((k, f), 0.1), ((f,), 0.1), ((f, h), 0.1), ((h,), 0.1),
                     ((h,), 0.1), ((h,), 0.1), ((h, f), 0.1), ((f,), 0.1),
                     ((f,), 1.0)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes_scales]
    params[8] = params[8] + np.float32(1.0)       # bn_s near 1
    ref = cla_f64(x, params, 1e-5)
    scale = np.abs(ref).max()
    three = cla_tile(x, params, 1e-5, 64, 32, ("a_small", "b_small", "big"))
    one = cla_tile(x, params, 1e-5, 64, 32, ("big",))
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1
    # and against the plain version, float32 in PyTorch's order: each of
    # the two lies within 1e-6 of max|out| from float64
    plain = cla_plain(torch.from_numpy(x),
                      [torch.from_numpy(p) for p in params], 1e-5).numpy()
    assert np.abs(three - plain).max() < 2e-6 * scale
