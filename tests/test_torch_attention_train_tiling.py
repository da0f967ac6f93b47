"""K13's tile (``sepreformer_torch/csrc/flash_relpos_tile.cuh``, the tile
K12 runs too) and K11's cluster (``csrc/pit.cu``), emulated in numpy:
what the card tests cannot reach here.

K13: blocks of 64 query rows in row tiles of 16 (rows past L computed on
zeros and not written); each row tile walked by ``split`` warps, warp ks
taking the key tiles n = split k + ks of 64 keys below lim; Q scaled by
log2(e) / sqrt(D) and split once into 3xTF32 parts; per tile S = Q Kᵀ as
3xTF32 products over the k-steps' columns 4t + 2kk and 4t + 2kk + 1 (K
zero at or past lim); the bias by the warp tile's class: the per-row
constant q·table[2m-1] (or q·table[0]) as a shift of the row where every
pair clamps, else Q·bandᵀ over the warp's 80 band rows (rel = iw - j0 -
63 + r, clamped) read back at column r - jl + 63; the key mask; the
online softmax in log2 units with the rows' per-lane sums (lane t's keys
8nt + 2t and 8nt + 2t + 1, added in nt order); the hash dropout on the
numerator after the sum at row bh * pick_block(L) + i; P·V as 3xTF32
products in two chains of zeroed fragments per tile; the split warps'
states merged in ks order; the quad's sums last, 1 / (1 - p) with 1 / l;
the row max stored in natural units.  Each product is exact in float64
and rounded to float32 when added, as tests/test_torch_tf32x3.py takes
them.  The emulation must lie within 1e-6 of max|out| of float64 (one
TF32 product must not) and match ``attention_train_plain``; its row
statistics must give K14 the probabilities.

K11: a cluster of kCluster blocks per batch entry, block r holding
samples [r chunk, (r + 1) chunk) of every row (held in shared memory up
to the block's room, the rest read again in each pass); each pass sums a
thread's held float4s and then the rest of its samples in order, the
warp by xor shuffles, the warps in order, the cluster's blocks in rank
order; den2 as the explicit residual.  It
must match float64 to 1e-4 dB, and at about 60 dB to 1e-3 dB, where the
expanded |e|² - 2c·dots + c²·ss in the same float32 sums does not.  The
constants are read from the sources, so the emulation cannot drift from
them.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from sepreformer_torch.ops.kernels import (
    attention_train_plain,
    sisnr_pairwise_neg,
)
from sepreformer_torch.ops.kernels.attention_train import pick_block
from sepreformer_torch.ops.kernels.hash_dropout import keep_mask

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
        / "csrc")
TILE = (CSRC / "flash_relpos_tile.cuh").read_text()
PIT = (CSRC / "pit.cu").read_text()


def constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+)", source).group(1))


D, ROW_TILES = constant(TILE, "kBaseD"), constant(TILE, "kRowTiles")
KEYS, WARP_BAND = constant(TILE, "kKeys"), constant(TILE, "kWarpBand")
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
SEED = 4321


def to_tf32(x):
    """float32 -> float32 with 10 mantissa bits, nearest, ties away."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x):
    """The tensor core's reading of an operand: the 13 low bits dropped."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def parts(x):
    """x = big + small as mma_tf32x3.cuh splits it, as the tensor core
    reads the two: big rounded to TF32, small with its low bits dropped."""
    big = to_tf32(x)
    return big, toward_zero(x - big)


def product(acc, a, b, terms):
    """acc (float32) += a @ b over the last axis of a, as mma3 adds its
    three terms (one TF32 product with terms=1); a and b in parts."""
    (ab, asm), (bb, bsm) = a, b
    pairs = ([(asm, bb), (ab, bsm), (ab, bb)] if terms == 3 else [(ab, bb)])
    for pa, pb in pairs:
        step = np.matmul(pa.astype(np.float64), pb.astype(np.float64))
        acc = acc + step.astype(np.float32)
    return acc


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def exp2(x):
    return np.exp2(np.asarray(x, np.float64)).astype(np.float32)


# lane t's keys of a tile in the C fragments' order: nt, then the pair
LANE_KEYS = np.array([[8 * nt + 2 * t + c for nt in range(8)
                       for c in range(2)] for t in range(4)])


def emulate(q, k, v, table, maxlen, lens, p, split, terms=3):
    """The tile on float32 q, k, v [B, H, L, D], table [2*maxlen, D]:
    (out [B, H, L, D], row_max, row_sum [B, H, L])."""
    b_n, h_n, length, _ = q.shape
    block = pick_block(length)
    rows_pad = -(-length // (16 * ROW_TILES)) * 16 * ROW_TILES
    warps = rows_pad // 16
    scale_log2 = np.float32(LOG2E / np.float32(4.0))   # log2(e) / sqrt(16)
    out = np.full(q.shape, np.nan, np.float32)
    row_max = np.full(q.shape[:3], np.nan, np.float32)
    row_sum = np.full_like(row_max, np.nan)
    top, bottom = table[2 * maxlen - 1], table[0]
    for b in range(b_n):
        lim = min(length, int(lens[b]))
        tiles = -(-lim // KEYS)
        for h in range(h_n):
            bh = b * h_n + h
            qp = np.zeros((rows_pad, D), np.float32)
            qp[:length] = q[b, h]
            qs = (qp * scale_log2).reshape(warps, 16, D)
            qparts = parts(qs)
            # the clamped-bias constants: each lane's fma chain over its
            # four columns, then the quad's sum
            consts = []
            for row in (top, bottom):
                lane = np.zeros((warps, 16, 4), np.float32)
                for c in range(4):
                    lane = fma(qs[:, :, c::4][:, :, :4], row[c::4], lane)
                consts.append((lane[..., 0] + lane[..., 1])
                              + (lane[..., 2] + lane[..., 3]))
            hi, lo = consts
            iw = 16 * np.arange(warps)                      # warps' rows
            states = []
            for ks in range(split):
                m = np.full((warps, 16), -np.inf, np.float32)
                lsum = np.zeros((warps, 16, 4), np.float32)
                o = np.zeros((warps, 16, D), np.float32)
                for n in range(ks, tiles, split):
                    j0 = n * KEYS
                    keys = j0 + np.arange(KEYS)
                    ok = keys < lim
                    kt = np.where(ok[:, None], k[b, h][np.minimum(
                        keys, length - 1)], 0).astype(np.float32)
                    vt = np.where(ok[:, None], v[b, h][np.minimum(
                        keys, length - 1)], 0).astype(np.float32)
                    s = np.zeros((warps, 16, KEYS), np.float32)
                    kp = parts(kt.T)
                    for kk in range(2):
                        cols = [4 * t + 2 * kk + c for c in range(2)
                                for t in range(4)]
                        s = product(s, (qparts[0][..., cols],
                                        qparts[1][..., cols]),
                                    (kp[0][cols], kp[1][cols]), terms)
                    rel_min = iw - j0 - (KEYS - 1)
                    high = rel_min >= maxlen - 1
                    low = ~high & (rel_min + KEYS + 14 <= -maxlen)
                    band_w = ~high & ~low
                    shift = np.where(high[:, None], hi,
                                     np.where(low[:, None], lo, 0)
                                     ).astype(np.float32)
                    if band_w.any():
                        rel = rel_min[:, None] + np.arange(WARP_BAND)
                        rows = np.clip(rel, -maxlen, maxlen - 1) + maxlen
                        band = table[rows]                   # [W, 80, D]
                        bp = parts(np.swapaxes(band, 1, 2))
                        c = np.zeros((warps, 16, WARP_BAND), np.float32)
                        for kk in range(2):
                            cols = [4 * t + 2 * kk + x for x in range(2)
                                    for t in range(4)]
                            c = product(c, (qparts[0][..., cols],
                                            qparts[1][..., cols]),
                                        (bp[0][:, cols], bp[1][:, cols]),
                                        terms)
                        # (row r, key jl) reads band column r - jl + 63
                        col = (np.arange(16)[:, None] - np.arange(KEYS)[None]
                               + KEYS - 1)
                        bias = np.take_along_axis(
                            c, np.broadcast_to(col, (warps, 16, KEYS)), 2)
                        s = np.where(band_w[:, None, None], s + bias, s)
                    s = np.where(ok, s, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, s.max(-1) + shift)
                    alpha = exp2(m - m_new)
                    m_sub = m_new - shift
                    e = exp2(s - m_sub[..., None])
                    add = np.zeros((warps, 16, 4), np.float32)
                    for x in range(16):                     # the lane order
                        add = add + e[..., LANE_KEYS[:, x]]
                    lsum = lsum * alpha[..., None] + add
                    m = m_new
                    if p > 0.0:
                        word = bh * block + np.arange(rows_pad).reshape(
                            warps, 16, 1)
                        keep = keep_mask(SEED, 0, torch.from_numpy(word),
                                         torch.from_numpy(keys), p).numpy()
                        e = np.where(keep > 0, e, np.float32(0))
                    pv = np.zeros((2, warps, 16, D), np.float32)
                    vp = parts(vt)
                    for nt in range(8):
                        sl = slice(8 * nt, 8 * nt + 8)
                        pv[nt & 1] = product(pv[nt & 1], parts(e[..., sl]),
                                             (vp[0][sl], vp[1][sl]), terms)
                    o = o * alpha[..., None] + (pv[0] + pv[1])
                states.append((m, lsum, o))
            (m, lsum, o), rest = states[0], states[1:]
            for m1, l1, o1 in rest:                        # in ks order
                mx = np.maximum(m, m1)
                c0, c1 = exp2(m - mx), exp2(m1 - mx)
                m = mx
                lsum = lsum * c0[..., None] + l1 * c1[..., None]
                o = o * c0[..., None] + o1 * c1[..., None]
            lq = (lsum[..., 0] + lsum[..., 1]) + (lsum[..., 2] + lsum[..., 3])
            inv = (np.float32(1.0 / (1.0 - p) if p > 0 else 1.0)
                   / np.maximum(lq, np.float32(1e-30))).astype(np.float32)
            out[b, h] = (o * inv[..., None]).reshape(rows_pad, D)[:length]
            row_max[b, h] = (m * LN2).reshape(rows_pad)[:length]
            row_sum[b, h] = lq.reshape(rows_pad)[:length]
    return out, row_max, row_sum


def scores64(q, k, table, maxlen, lens):
    """float64 scaled scores of the float32 inputs, -inf past lim."""
    length = q.shape[2]
    pos = np.arange(length)
    rel = np.clip(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen
    q64, k64, t64 = (a.astype(np.float64) for a in (q, k, table))
    s = (np.einsum("bhid,bhjd->bhij", q64, k64)
         + np.einsum("bhid,ijd->bhij", q64, t64[rel])) / 4.0
    valid = pos[None] < np.asarray(lens)[:, None]
    return np.where(valid[:, None, None], s, -np.inf)


def exact(q, k, v, table, maxlen, lens, p):
    """float64 out, row max and row sum of exp(s - max)."""
    b_n, h_n, length, _ = q.shape
    s = scores64(q, k, table, maxlen, lens)
    mx = s.max(-1)
    e = np.exp(s - mx[..., None])
    lsum = e.sum(-1)
    w = e / lsum[..., None]
    if p > 0.0:
        block = pick_block(length)
        rows = (np.arange(b_n * h_n).reshape(b_n, h_n, 1, 1) * block
                + np.arange(length).reshape(1, 1, length, 1))
        keep = keep_mask(SEED, 0, torch.from_numpy(rows),
                         torch.arange(length).reshape(1, 1, 1, length),
                         p).numpy()
        w = w * keep / (1.0 - p)
    return w @ v.astype(np.float64), mx, lsum


def make_case(length, maxlen, lens, seed=3):
    rng = np.random.default_rng(seed)
    b_n, h_n = len(lens), 1
    q, k, v = (rng.normal(size=(b_n, h_n, length, D)).astype(np.float32)
               for _ in range(3))
    table = (rng.normal(size=(2 * maxlen, D)) * 0.5).astype(np.float32)
    return q, k, v, table, np.asarray(lens)


# L 77 (a partial key tile, rows past L in the block; a row of one valid
# key); L 129 (a third query block of one row; key length 65, one key into
# the second tile); L 300 with maxlen 64 (tiles of both clamped classes
# and band tiles straddling the clamp edge, hash row stride 512); L 500
# with maxlen 2000 (Base's decoder attention); with 1, 2 or 4 warps per
# row tile
CASES = [(77, 64, (77, 1), 4), (129, 64, (129, 65), 2),
         (300, 64, (300, 131), 1), (300, 64, (300, 131), 4),
         (500, 2000, (500,), 2)]


@pytest.mark.parametrize("length,maxlen,lens,split", CASES)
def test_k13_tile_holds_float32_accuracy(length, maxlen, lens, split):
    q, k, v, table, lens = make_case(length, maxlen, lens)
    p = 0.05
    out, row_max, row_sum = emulate(q, k, v, table, maxlen, lens, p, split)
    ref, mx, lsum = exact(q, k, v, table, maxlen, lens, p)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-6 * scale
    # the row statistics K14 reads: the natural max over the valid keys
    # and the sum of exp(s - max) before the drop
    np.testing.assert_allclose(row_max, mx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(row_sum, lsum, rtol=1e-6)
    # the plain version, in float32 by another order; a wrong hash row
    # or mask errs by O(1) at p 0.05
    plain = attention_train_plain(
        *(torch.from_numpy(a) for a in (q, k, v, table)), maxlen, SEED, p,
        torch.from_numpy(lens)).numpy()
    assert np.abs(out - plain).max() <= 2e-6 * scale


def test_one_tf32_product_is_not_enough():
    q, k, v, table, lens = make_case(129, 64, (129, 65))
    ref = exact(q, k, v, table, 64, lens, 0.05)[0]
    out = emulate(q, k, v, table, 64, lens, 0.05, 2, terms=1)[0]
    assert np.abs(out - ref).max() > 1e-4 * np.abs(ref).max()


def test_k13_row_stats_give_k14_the_probabilities():
    """K14 recomputes P = 2^(s c log2(e) - row_max log2(e)) / row_sum:
    from the tile's statistics it must be the softmax of the valid keys."""
    q, k, v, table, lens = make_case(300, 64, (300, 131))
    _, row_max, row_sum = emulate(q, k, v, table, 64, lens, 0.05, 4)
    s = scores64(q, k, table, 64, lens)
    prob = np.exp2(s * np.float64(LOG2E)
                   - (row_max * LOG2E).astype(np.float64)[..., None])
    prob /= row_sum[..., None]
    ref = np.exp(s - s.max(-1, keepdims=True))
    ref /= ref.sum(-1, keepdims=True)
    np.testing.assert_allclose(prob, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ K11

CLUSTER, THREADS = constant(PIT, "kCluster"), constant(PIT, "kThreads")
CACHE_BYTES = 192 * 1024
assert re.search(r"constexpr int kCacheBytes = 192 \* 1024;", PIT)
WARPS = THREADS // 32


def launch_shape(s, t):
    """(samples per block, samples per row held) as pit.cu's shape()."""
    chunk = (-(-t // CLUSTER) + 3) & ~3
    fixed = WARPS * (s * s + s) + CLUSTER * (2 * s + (s * s + s) + s * s)
    room = ((CACHE_BYTES // 4 - fixed) // (2 * s)) & ~3
    return chunk, max(0, min(chunk, room))


def block_sum(x, held, vec):
    """A block's sum of its samples x (float32), ``held`` of them in shared
    memory: each thread's float4s x4 = tid + kThreads k of the held ones
    (four samples each, in order), then those of the rest (vec, T % 4 ==
    0), or the rest's scalars x = 4 h4 + tid + kThreads k; the warp by xor
    shuffles, the warps in order."""
    acc = np.zeros(THREADS, np.float32)

    def slots(values):                      # [m, 4] float4s or [m] scalars
        for k in range(-(-len(values) // THREADS)):
            part = values[k * THREADS:(k + 1) * THREADS]
            for c in range(part.shape[1] if part.ndim == 2 else 1):
                add = part[:, c] if part.ndim == 2 else part
                acc[:len(part)] = acc[:len(part)] + add

    h4 = held // 4
    slots(x[:4 * h4].reshape(-1, 4))
    slots(x[4 * h4:].reshape(-1, 4) if vec else x[4 * h4:])
    w = acc.reshape(WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, np.arange(32) ^ o]
    total = np.float32(0)
    for part in w[:, 0]:
        total = np.float32(total + part)
    return total


def cluster_sum(f, s_n, t):
    """f(lo, hi) -> float32 values of samples lo .. hi, summed as the
    cluster sums them: blocks' sums in rank order."""
    chunk, room = launch_shape(s_n, t)
    total = np.float32(0)
    for r in range(CLUSTER):
        lo, hi = min(r * chunk, t), min((r + 1) * chunk, t)
        total = np.float32(total + block_sum(f(lo, hi), min(hi - lo, room),
                                             t % 4 == 0))
    return total


def emulate_pit(est, src, expanded=False, eps=1e-8):
    """K11's [B, S, S] table (unclamped) from float32 est, src [S, B, T];
    ``expanded`` takes den2 as |e|² - 2c·dots + c²·ss instead."""
    s_n, b_n, t = est.shape
    eps = np.float32(eps)
    out = np.zeros((b_n, s_n, s_n), np.float32)
    for b in range(b_n):
        rows = [est[i, b] for i in range(s_n)] + [src[j, b]
                                                  for j in range(s_n)]
        mean = [np.float32(cluster_sum(lambda lo, hi: r[lo:hi], s_n, t)
                           / np.float32(t)) for r in rows]
        cen = [(r - m).astype(np.float32) for r, m in zip(rows, mean)]

        def dot(x, y):
            return cluster_sum(lambda lo, hi: x[lo:hi] * y[lo:hi], s_n, t)

        for i in range(s_n):
            for j in range(s_n):
                e, sv = cen[i], cen[s_n + j]
                dots, ss = dot(e, sv), dot(sv, sv)
                c = np.float32(dots / (ss + eps))
                if expanded:
                    den2 = np.float32(dot(e, e) - np.float32(2) * c * dots
                                      + c * c * ss)
                else:
                    r = (e - c * sv).astype(np.float32)
                    den2 = dot(r, r)
                num2 = np.float32(c * c * ss)
                ratio = np.sqrt(num2) / (np.sqrt(max(den2, 0)) + eps)
                out[b, i, j] = -20 * np.log10(eps + ratio)
    return out


def exact_pit(est, src, eps=1e-8):
    e = est.astype(np.float64) - est.mean(-1, keepdims=True, dtype=np.float64)
    s = src.astype(np.float64) - src.mean(-1, keepdims=True, dtype=np.float64)
    dots = np.einsum("ibt,jbt->bij", e, s)
    ss = np.einsum("jbt,jbt->bj", s, s)[:, None]
    c = dots / (ss + eps)
    num = np.sqrt(c * c * ss)
    den = np.sqrt(np.einsum("ibt,ibt->bi", e, e)[..., None] - 2 * c * dots
                  + c * c * ss)
    # the residual in float64 directly, without cancellation
    for b in range(est.shape[1]):
        for i in range(est.shape[0]):
            for j in range(est.shape[0]):
                den[b, i, j] = np.sqrt((((e[i, b] - c[b, i, j] * s[j, b])
                                         ** 2).sum()))
    return -20 * np.log10(eps + num / (den + eps))


def pit_case(s_n, b_n, t, noise, seed=7):
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(s_n, b_n, t)) * 0.1).astype(np.float32)
    est = (src[::-1] + noise * rng.normal(size=(s_n, b_n, t))).astype(
        np.float32)
    return est, src


# S 2 at the 4 s crop; S 3; T 1001 (chunks of 128 a block, the last one
# short, T % 4 != 0); T 480000, 60 s of validation, past what a block
# holds (so each block reads the rest of its chunk again in passes 2, 3)
@pytest.mark.parametrize("s_n,b_n,t", [(2, 2, 32000), (3, 1, 32000),
                                       (2, 3, 1001), (2, 1, 480000)])
def test_k11_cluster_sums_match_float64(s_n, b_n, t):
    chunk, held = launch_shape(s_n, t)
    assert held < chunk if t == 480000 else held == chunk
    assert t % chunk if t == 1001 else True
    est, src = pit_case(s_n, b_n, t, 0.02)
    got = emulate_pit(est, src)
    np.testing.assert_allclose(got, exact_pit(est, src), rtol=0, atol=1e-4)
    plain = sisnr_pairwise_neg(torch.from_numpy(est), torch.from_numpy(src),
                               clamp_db=None).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-4)


def test_k11_explicit_residual_at_60_db():
    est, src = pit_case(2, 1, 32000, 1e-4)
    ref = exact_pit(est, src)
    assert ref[0, 0, 1] < -59.0                  # the matched pair, ~60 dB
    assert np.abs(emulate_pit(est, src) - ref).max() <= 1e-3
    assert np.abs(emulate_pit(est, src, expanded=True) - ref).max() > 1e-3
