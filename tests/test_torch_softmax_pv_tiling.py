"""The tile of K3, K3b, K9 and K9b (``sepreformer_torch/csrc/
softmax_pv_tile.cuh``), emulated in numpy: what the card tests cannot
reach here.

The emulation follows the tile's arithmetic and indexing: blocks of
kWarps / split warp tiles of 16 query rows (rows past Lp load row Lp - 1
and are not written), key tiles of kKeys keys walked while they start
below lim, tile n taken by the row tile's warp n % split (split 1 or 2),
a lane's keys (``key_of``: four neighbours 4t .. 4t+3 of each 16-key
group, in pairs) of rows g and g + 8, read as 16-byte loads of four
neighbours when Lp % 4 == 0 (a load whose first key is below lim, so up
to three keys at or past lim but below Lp), else key by key below lim,
keys at or past lim weighted 0 (the mask on the tile that crosses lim
alone), each warp's online softmax with each row's max and per-lane sums
(added in the lane's key order), e = 2^(s log2(e) - m log2(e)), the hash
dropout on the numerator at row (b*H + h)*Lp + i and key j (1 / (1 - p)
applied with 1 / l at the end), P·V as 3xTF32 m16n8k8 products (P's C
fragment as the A fragment, the k-step's keys in slots t and t+4) in two
chains of zeroed fragments per tile, added to the warp's running output
in float32, and with split 2 the two warps' states merged at the end
(the larger max, each side scaled by exp(m_side - m)), the sums over the
quad last. Each k-step's products are exact and summed in float64, then
rounded to float32, as tests/test_torch_tf32x3.py takes them. The result
must lie within 1e-6 of max|out| of float64 and match the plain versions
``softmax_pv_plain`` and ``softmax_pv_dropout_plain``; one TF32 product
must miss float64 by more than 1e-4. The row statistics must be what K10
reads: the natural-base max over the valid keys and the sum of exp(s -
max) before the drop. The tile's constants are read from the source, so
the emulation cannot drift from it.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from sepreformer_torch.ops.kernels import (
    softmax_pv_dropout_plain,
    softmax_pv_plain,
)
from sepreformer_torch.ops.kernels.hash_dropout import keep_mask

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
          / "csrc" / "softmax_pv_tile.cuh").read_text()


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


D, KEYS, WARPS = constant("kBaseD"), constant("kKeys"), constant("kWarps")
LOG2E = np.float32(1.4426950408889634)
SEED = 1234


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


def tile(scores, bias, vh, b, h, n, lim, m, lsum, o, load, rows, lane_key,
         p, terms, read, weight):
    """Key tile n of one warp's walk over the rows of (b, h): its new
    running max, per-lane sums and output."""
    h_n, lp = scores.shape[1], scores.shape[2]
    rows_pad = len(rows)
    j0 = n * KEYS
    keys = j0 + lane_key                                   # [8, 4, 2]
    ok = keys < lim
    # load_tile: a 16-byte load takes the four keys of a group when the
    # first is below lim (Lp % 4 == 0), else each key below lim alone
    loaded = keys - keys % 4 < lim if lp % 4 == 0 else ok
    kk = keys[loaded]
    assert kk.max() < lp, "a load past the row's end"
    s = np.zeros((rows_pad, 8, 4, 2), np.float32)
    s[:, loaded] = scores[b, h][load][:, kk]
    if bias is not None:
        s[:, loaded] += bias[b, h][load][:, kk]
    read[b, h, rows[:lp, None], kk[None]] += 1
    vt = np.zeros((KEYS, D), np.float32)                   # V's stage
    rng = np.arange(j0, min(j0 + KEYS, lim))
    vt[rng - j0] = vh[rng]
    if j0 + KEYS > lim:                                    # the crossing tile
        s[:, ~ok] = -np.inf
    m_new = np.maximum(m, s.reshape(rows_pad, -1).max(1))
    alpha = np.exp2((m - m_new).astype(np.float64) * LOG2E).astype(np.float32)
    mb = (m_new * LOG2E).astype(np.float32)
    e = np.exp2(s.astype(np.float64) * LOG2E
                - mb[:, None, None, None]).astype(np.float32)
    inside = keys < lp
    weight[b, h, rows[:lp, None], keys[inside][None]] += e[:lp][:, inside]
    add = np.zeros((rows_pad, 4), np.float32)
    for nt in range(8):                                    # the lane's order
        for q in range(2):
            add = add + e[:, nt, :, q]
    lsum = lsum * alpha[:, None] + add
    pd = e
    if p > 0.0:
        word = (b * h_n + h) * lp + rows
        keep = keep_mask(SEED, 0, torch.from_numpy(word).reshape(-1, 1, 1, 1),
                         torch.from_numpy(keys)[None], p).numpy() > 0
        pd = np.where(keep, e, np.float32(0))     # 1 / (1 - p) at the end
    pv = np.zeros((2, rows_pad, D), np.float32)
    for nt in range(8):
        a = pd[:, nt].reshape(rows_pad, 8)      # the k-step's keys, [t, e]
        bm = vt[lane_key[nt].reshape(8)]
        (ab, asm), (bb, bsm) = parts(a), parts(bm)
        # mma3's order; one TF32 product takes the last alone
        pairs = ([(asm, bb), (ab, bsm), (ab, bb)] if terms == 3
                 else [(ab, bb)])
        for pa, pb in pairs:
            step = pa.astype(np.float64) @ pb.astype(np.float64)
            pv[nt & 1] = pv[nt & 1] + step.astype(np.float32)
    o = o * alpha[:, None] + (pv[0] + pv[1])
    return m_new, lsum, o


def emulate(scores, bias, v, lens, length, split, p=0.0, terms=3):
    """The tile with ``split`` warps per row tile on numpy float32 inputs
    scores (and bias) [B, H, Lp, Lp], v [B, Lp, H*D]: (out [B, Lp, H*D],
    row_max and row_sum [B, H, Lp], how often each row read each key and
    the sum of the weights e each row gave each key, both [B, H, Lp, Lp]).
    """
    b_n, h_n, lp, _ = scores.shape
    f = v.shape[-1]
    out = np.full((b_n, lp, f), np.nan, np.float32)
    row_max = np.full((b_n, h_n, lp), np.nan, np.float32)
    row_sum = np.full_like(row_max, np.nan)
    read = np.zeros(scores.shape, np.int32)
    weight = np.zeros(scores.shape)
    rows_block = 16 * WARPS // split            # query rows per block
    rows_pad = -(-lp // rows_block) * rows_block   # the grid's rows
    rows = np.arange(rows_pad)
    load = np.minimum(rows, lp - 1)             # rows past Lp load Lp - 1
    # a lane's keys of a tile, key_of(nt, e, t): [nt, t, e % 2]
    nt_, t_, e_ = np.meshgrid(np.arange(8), np.arange(4), np.arange(2),
                              indexing="ij")
    lane_key = 16 * (nt_ // 2) + 4 * t_ + 2 * (nt_ % 2) + e_
    for b in range(b_n):
        lim = min(length, int(lens[b]), lp)
        tiles = -(-lim // KEYS)
        for h in range(h_n):
            vh = v[b, :, h * D:(h + 1) * D]
            warps = []
            for ks in range(split):      # the row tile's warps
                m = np.full(rows_pad, -np.inf, np.float32)
                lsum = np.zeros((rows_pad, 4), np.float32)    # per lane t
                o = np.zeros((rows_pad, D), np.float32)
                for n in range(ks, tiles, split):
                    m, lsum, o = tile(scores, bias, vh, b, h, n, lim, m,
                                      lsum, o, load, rows, lane_key, p,
                                      terms, read, weight)
                warps.append((m, lsum, o))
            (m, lsum, o), rest = warps[0], warps[1:]
            for m1, l1, o1 in rest:
                mx = np.maximum(m, m1)
                c0 = np.exp2((m - mx).astype(np.float64)
                             * LOG2E).astype(np.float32)
                c1 = np.exp2((m1 - mx).astype(np.float64)
                             * LOG2E).astype(np.float32)
                m = mx
                lsum = lsum * c0[:, None] + l1 * c1[:, None]
                o = o * c0[:, None] + o1 * c1[:, None]
            lq = (lsum[:, 0] + lsum[:, 1]) + (lsum[:, 2] + lsum[:, 3])
            scale = np.float32(1.0 / (1.0 - p) if p > 0.0 else 1.0)
            inv = (scale / lq).astype(np.float32)
            out[b, :, h * D:(h + 1) * D] = (o * inv[:, None])[:lp]
            row_max[b, h] = m[:lp]
            row_sum[b, h] = lq[:lp]
    return out, row_max, row_sum, read, weight


def exact(scores, bias, v, lens, length, p=0.0):
    """float64 softmax(s)·(keep / (1 - p))·V of the float32 sum s, and
    the row max and sum of exp(s - max) over the valid keys."""
    b_n, h_n, lp, _ = scores.shape
    s = scores if bias is None else (scores + bias).astype(np.float32)
    s = s.astype(np.float64)
    lim = np.minimum(np.minimum(np.asarray(lens), length), lp)
    valid = np.arange(lp)[None] < lim[:, None]             # [B, Lp]
    s = np.where(valid[:, None, None], s, -np.inf)
    mx = s.max(-1)
    e = np.exp(s - mx[..., None])
    lsum = e.sum(-1)
    w = e / lsum[..., None]
    if p > 0.0:
        rows = (np.arange(b_n * h_n).reshape(b_n, h_n, 1, 1) * lp
                + np.arange(lp).reshape(1, 1, lp, 1))
        keep = keep_mask(SEED, 0, torch.from_numpy(rows),
                         torch.arange(lp).reshape(1, 1, 1, lp), p).numpy()
        w = w * keep / (1.0 - p)
    vh = v.astype(np.float64).reshape(b_n, lp, h_n, D).transpose(0, 2, 1, 3)
    out = (w @ vh).transpose(0, 2, 1, 3).reshape(b_n, lp, h_n * D)
    return out, mx, lsum


def make_case(lp, length, lens, bias, seed=5):
    rng = np.random.default_rng(seed)
    b_n, h_n = len(lens), 2
    scores = (rng.normal(size=(b_n, h_n, lp, lp)) * 3).astype(np.float32)
    extra = ((rng.normal(size=scores.shape) * 2).astype(np.float32)
             if bias else None)
    v = rng.normal(size=(b_n, lp, h_n * D)).astype(np.float32)
    return scores, extra, v, np.asarray(lens)


# Lp 77 (odd, one row past a block's 64 in the second, a partial key
# tile; lens 1: a row with one valid key); Lp 136 (not a multiple of 16
# or 64; lim 65, one key into the second tile, the third past lim); Lp 200
# (lim 128 ends on a tile boundary, the fourth tile past it; length 190
# below Lp); Lp 17 (a block that is mostly rows past Lp); with one warp
# per row tile (blocks of 128 rows) or two (64 rows, merged at the end).
CASES = [(77, 77, (77, 1), 2), (136, 130, (130, 65), 1),
         (136, 130, (130, 65), 2), (200, 190, (190, 128), 1),
         (17, 17, (17, 9), 2)]
VARIANTS = [("K3", False, 0.0), ("K3b", True, 0.0), ("K9", False, 0.05),
            ("K9b", True, 0.05)]


@pytest.mark.parametrize("name,bias,p", VARIANTS)
@pytest.mark.parametrize("lp,length,lens,split", CASES)
def test_tile_holds_float32_accuracy(lp, length, lens, split, name, bias, p):
    scores, extra, v, lens = make_case(lp, length, lens, bias)
    out, row_max, row_sum, read, weight = emulate(scores, extra, v, lens,
                                                  length, split, p)
    ref, mx, lsum = exact(scores, extra, v, lens, length, p)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-6 * scale, name
    # every valid key read once per row; past lim only the rest of a
    # 16-byte load that starts below it (Lp % 4 == 0), and weighted 0
    lim = np.minimum(np.minimum(lens, length), lp)
    valid = np.arange(lp)[None] < lim[:, None]
    reach = -(-lim // 4) * 4 if lp % 4 == 0 else lim
    reached = np.arange(lp)[None] < reach[:, None]
    assert np.array_equal(read, np.broadcast_to(reached[:, None, None],
                                                read.shape).astype(int))
    assert (weight[np.broadcast_to(valid[:, None, None], read.shape)]
            > 0).all()
    assert not weight[np.broadcast_to(~valid[:, None, None],
                                      read.shape)].any()
    # the row statistics K10 reads: the natural-base max over the valid
    # keys, and the sum of exp(s - max) before the drop
    s32 = scores if extra is None else scores + extra
    assert np.array_equal(row_max, np.where(valid[:, None, None], s32,
                                            -np.inf).max(-1))
    np.testing.assert_allclose(row_sum, lsum, rtol=1e-6)
    # the plain versions, in float32 by another order
    t = [None if a is None else torch.from_numpy(a)
         for a in (scores, extra, v)]
    key_lens = torch.from_numpy(lens)
    plain = (softmax_pv_plain(t[0], t[2], key_lens, length, t[1]) if p == 0
             else softmax_pv_dropout_plain(t[0], t[2], SEED, key_lens,
                                           length, p, t[1]))
    assert np.abs(out - plain.numpy()).max() <= 2e-6 * scale, name


@pytest.mark.parametrize("name,bias,p", [VARIANTS[0], VARIANTS[2]])
def test_one_tf32_product_is_not_enough(name, bias, p):
    scores, extra, v, lens = make_case(136, 130, (130, 65), bias)
    ref = exact(scores, extra, v, lens, 130, p)[0]
    out = emulate(scores, extra, v, lens, 130, 2, p, terms=1)[0]
    assert np.abs(out - ref).max() > 1e-4 * np.abs(ref).max(), name


def test_row_stats_give_k10_the_probabilities():
    """K10 recomputes P = exp(s - row_max) / row_sum: from the tile's
    statistics it must be the softmax of the valid keys."""
    scores, _, v, lens = make_case(136, 130, (130, 65), False)
    _, row_max, row_sum, _, _ = emulate(scores, None, v, lens, 130, 2,
                                        0.05)
    lim = np.minimum(lens, 130)
    valid = np.arange(136)[None, None, None] < lim[:, None, None, None]
    prob = np.where(valid, np.exp(np.where(valid, scores, row_max[
        ..., None]) - row_max[..., None]) / row_sum[..., None], 0.0)
    s = np.where(valid, scores.astype(np.float64), -np.inf)
    ref = np.exp(s - s.max(-1, keepdims=True))
    ref /= ref.sum(-1, keepdims=True)
    np.testing.assert_allclose(prob, ref, rtol=0, atol=1e-6)
