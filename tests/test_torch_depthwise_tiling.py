"""The tiling of K4, K5 and K6 (``sepreformer_torch/csrc/depthwise.cu``,
namespace ``tiled``), emulated in numpy: what the card tests cannot
reach here.

The emulation follows the kernels' index arithmetic step by step: the
geometry for K taps (G groups of Q taps, KP = G * Q, S row splits, tiles
of TT = G * S * Q rows staged as TT + KP rows from K // 2 rows before the
tile, zeros outside [0, T) and past C), the launch plan (chunks of tiles
sized to the card's block slots), the two-buffer ring of stages, the dx
window of Q rows and the dw window of Q taps that slide one row a step
through slot (step + r) % Q, db on tap group 0's dy loads, the S splits
added in order at a block's end, and the partials summed by slices in the
reduction launch's fixed order.  Sums are float32, each FMA rounded once
by way of float64.  The result must match float64 and the plain versions
``depthwise_bwd_plain`` and ``depthwise_bwd_w_plain`` on seeded inputs.
K4 walks the same plan and a ring of x rows alone, the dx window with
the weight unflipped and each sum started at the bias; it must come
within 1e-6 of float64's max|y| and match ``depthwise_fwd_plain`` and,
at C 128, the JAX package's ``_impl_fwd`` in interpret mode.  The
geometry constants and the kernels' window instantiations are read
from the source, so the emulation cannot drift from it.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.depthwise import _impl_fwd as jax_impl_fwd
from sepreformer_torch.ops.kernels import (
    depthwise_bwd_plain,
    depthwise_bwd_w_plain,
    depthwise_fwd_plain,
)
from sepreformer_torch.ops.kernels.depthwise import MAX_KERNEL

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch"
          / "csrc" / "depthwise.cu").read_text()
LANES = 32
SMEM_PER_BLOCK = 232448      # the H100's largest dynamic shared memory


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


MAX_Q, MIN_WARPS = constant("kMaxQ"), constant("kMinWarps")
MAX_THREADS, SLICES = constant("kMaxThreads"), constant("kSlices")
FWD_WINDOWS = constant("kFwdWindows")


def geometry(k):
    """bwd::geometry: (G, Q, S, warps, TT, KP, SR)."""
    g = -(-k // MAX_Q)
    q = -(-k // g)
    s = -(-MIN_WARPS // g)
    warps = g * s
    return g, q, s, warps, warps * q, g * q, warps * q + g * q


def fwd_geometry(k):
    """K4's geometry: tiles FWD_WINDOWS times as tall."""
    g, q, s, warps, tt, kp, _ = geometry(k)
    return g, q, s, warps, FWD_WINDOWS * tt, kp, FWD_WINDOWS * tt + kp


def plan(b, t, c, k, slots, fwd=False):
    """make_plan with ``slots`` = blocks per SM x SMs: (tiles per block,
    chunks)."""
    tt = (fwd_geometry if fwd else geometry)(k)[4]
    tiles = -(-t // tt)
    per_block = -(-(-(-c // LANES) * b * tiles) // slots)
    return per_block, -(-tiles // per_block)


def fma(a, b, c):
    """float32 a * b + c, rounded once."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def stage(a, bb, tile, c0, tt, sr, h):
    """A tile's staged rows [sr, LANES] of a[bb]: zeros outside [0, T) and
    past C."""
    t, c = a.shape[1:]
    out = np.zeros((sr, LANES), np.float32)
    rows = np.arange(sr) + tile * tt - h
    ok = (rows >= 0) & (rows < t)
    cols = min(LANES, c - c0)
    out[ok, :cols] = a[bb, rows[ok], c0:c0 + cols]
    return out


def emulate(x, dy, w, slots, with_dx):
    """K5 (with_dx) or K6 on numpy float32 inputs x, dy [B, T, C], w [C,
    K] (K6 reads only its K): (dx or None, dw [C, K], db [C])."""
    b, t, c = x.shape
    k = w.shape[1]
    g_n, q_n, s_n, warps, tt, kp, sr = geometry(k)
    h = (k - 1) // 2
    per_block, chunks = plan(b, t, c, k, slots)
    tiles = -(-t // tt)
    dx = np.zeros_like(x) if with_dx else None
    partial = np.zeros((b * chunks, k + 1, c), np.float32)
    warp = np.arange(warps)
    g_of, s_of = warp % g_n, warp // g_n
    for c0 in range(0, c, LANES):
        lanes = min(LANES, c - c0)
        if with_dx:   # ws [KP, LANES]: the weight flipped, zero past K
            ws = np.zeros((kp, LANES), np.float32)
            ws[:k, :lanes] = w[c0:c0 + lanes, ::-1].T
        for bb in range(b):
            for chunk in range(chunks):
                first = chunk * per_block
                n = min(per_block, tiles - first)
                assert n >= 1
                dw_acc = np.zeros((warps, q_n, LANES), np.float32)
                db_acc = np.zeros((warps, LANES), np.float32)
                ring = [None, None]
                ring[0] = (stage(x, bb, first, c0, tt, sr, h),
                           stage(dy, bb, first, c0, tt, sr, h))
                for kk in range(n):
                    if kk + 1 < n:
                        ring[(kk + 1) & 1] = (
                            stage(x, bb, first + kk + 1, c0, tt, sr, h),
                            stage(dy, bb, first + kk + 1, c0, tt, sr, h))
                    xs, ds = ring[kk & 1]
                    if with_dx:
                        r0 = warp * q_n
                        acc = [np.zeros((warps, LANES), np.float32)
                               for _ in range(q_n)]
                        win = [ds[r0 + q] for q in range(q_n)]
                        for jb in range(0, kp, q_n):
                            for jj in range(q_n):
                                wv = ws[jb + jj]
                                for r in range(q_n):
                                    acc[r] = fma(wv, win[(jj + r) % q_n],
                                                 acc[r])
                                win[jj] = ds[r0 + jb + jj + q_n]
                        t0 = (first + kk) * tt + r0
                        for r in range(q_n):
                            for wi in range(warps):
                                if t0[wi] + r < t:
                                    dx[bb, t0[wi] + r, c0:c0 + lanes] = (
                                        acc[r][wi, :lanes])
                    i0 = s_of * kp
                    xrow = i0 + g_of * q_n
                    drow = i0 + h
                    win = [xs[xrow + q] for q in range(q_n)]
                    for ib in range(0, kp, q_n):
                        for ii in range(q_n):
                            d = ds[drow + ib + ii]
                            db_acc = np.where((g_of == 0)[:, None],
                                              db_acc + d, db_acc)
                            for q in range(q_n):
                                dw_acc[:, q] = fma(win[(ii + q) % q_n], d,
                                                   dw_acc[:, q])
                            win[ii] = xs[xrow + ib + ii + q_n]
                # the block's partial: each tap's S splits in order
                red = np.zeros((s_n, kp, LANES), np.float32)
                red_db = np.zeros((s_n, LANES), np.float32)
                for wi in range(warps):
                    g, s = g_of[wi], s_of[wi]
                    red[s, g * q_n:(g + 1) * q_n] = dw_acc[wi]
                    if g == 0:
                        red_db[s] = db_acc[wi]
                tot = np.zeros((k + 1, LANES), np.float32)
                for s in range(s_n):
                    tot[:k] += red[s, :k]
                    tot[k] += red_db[s]
                partial[bb * chunks + chunk, :, c0:c0 + lanes] = (
                    tot[:, :lanes])
    # the reduction launch: slice j adds parts j, j + SLICES, ... in
    # order, then the slices in order
    slices = np.zeros((SLICES, k + 1, c), np.float32)
    for j in range(SLICES):
        for q in range(j, b * chunks, SLICES):
            slices[j] += partial[q]
    out = slices[0].copy()
    for j in range(1, SLICES):
        out += slices[j]
    return dx, out[:k].T, out[k]


def reference(x, dy, w):
    """float64 dx, dw [C, K], db of the "same" conv's backward."""
    b, t, c = x.shape
    k = w.shape[1]
    h = (k - 1) // 2
    x64, dy64 = x.astype(np.float64), dy.astype(np.float64)
    xp = np.pad(x64, ((0, 0), (h, h), (0, 0)))
    dyp = np.pad(dy64, ((0, 0), (h, h), (0, 0)))
    dx = np.zeros((b, t, c))
    dw = np.zeros((c, k))
    for tap in range(k):
        dx += dyp[:, k - 1 - tap:k - 1 - tap + t] * w[:, tap]
        dw[:, tap] = (xp[:, tap:tap + t] * dy64).sum(axis=(0, 1))
    return dx, dw, dy64.sum(axis=(0, 1))


def case(b, t, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    dy = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(c, k)) * 0.1).astype(np.float32)
    return x, dy, w


def test_geometry_covers_every_odd_kernel():
    """Every odd K the wrapper takes has a window the source instantiates,
    at most kMaxThreads threads, and stages that fit a block's shared
    memory; the block's end-of-chunk sums fit in what the stages free."""
    body = SOURCE[SOURCE.index("const void* kernel_for("):]
    body = body[:body.index("return nullptr")]
    cases = {int(q) for q in re.findall(r"case (\d+): return pick<\1>",
                                        body)}
    seen = set()
    for k in range(1, MAX_KERNEL + 1, 2):
        g, q, s, warps, tt, kp, sr = geometry(k)
        seen.add(q)
        assert q in cases and q <= MAX_Q
        assert k <= kp < k + g and tt == s * kp
        assert warps >= MIN_WARPS and warps * 32 <= MAX_THREADS
        smem = 4 * (4 * sr * LANES + kp * LANES)
        assert smem <= SMEM_PER_BLOCK, (k, smem)
        assert s * (kp + 1) <= 4 * sr
    assert seen == cases


# T ending one row into a tile, T under one tile, T < K - 1, T = 1;
# C past one channel group and C not a multiple of 4.  ``slots`` is the
# card's block slots: 264 (two blocks on each of 132 SMs) or 3, which
# gives blocks of several tiles and more partials than slices.
TILE = {k: geometry(k)[4] for k in (1, 9, 65, 81)}
CASES = [(2, TILE[65] + 1, 40, 65, 264), (2, 2 * TILE[65] + 1, 6, 65, 3),
         (1, 100, 33, 65, 264), (2, 40, 8, 65, 264), (2, 1, 6, 65, 264),
         (3, 2 * TILE[9] + 1, 6, 9, 3), (2, 50, 36, 9, 264),
         (2, TILE[81] + 1, 6, 81, 3), (1, 40, 10, 81, 264),
         (2, 4 * TILE[1] + 1, 6, 1, 3), (1, 1, 35, 1, 264)]


@pytest.mark.parametrize("b,t,c,k,slots", CASES)
def test_k5_tiling_matches_float64_and_plain(b, t, c, k, slots):
    x, dy, w = case(b, t, c, k, 1000 * k + t)
    dx, dw, db = emulate(x, dy, w, slots, True)
    rdx, rdw, rdb = reference(x, dy, w)
    np.testing.assert_allclose(dx, rdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, rdw, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db, rdb, rtol=1e-5, atol=1e-4)
    pdx, pdw, pdb = depthwise_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(w[:, None, :].copy()),
        torch.from_numpy(dy))
    np.testing.assert_allclose(dx, pdx.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw, pdw.numpy()[:, 0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(db, pdb.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b,t,c,k,slots", CASES)
def test_k6_tiling_matches_float64_and_plain(b, t, c, k, slots):
    x, dy, w = case(b, t, c, k, 1000 * k + t + 1)
    _, dw, db = emulate(x, dy, w, slots, False)
    _, rdw, rdb = reference(x, dy, w)
    np.testing.assert_allclose(dw, rdw, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db, rdb, rtol=1e-5, atol=1e-4)
    pdw, pdb = depthwise_bwd_w_plain(torch.from_numpy(x),
                                     torch.from_numpy(dy), k)
    np.testing.assert_allclose(dw, pdw.numpy()[:, 0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(db, pdb.numpy(), rtol=1e-4, atol=1e-3)


def test_plan_fills_the_card_once_at_the_main_shape():
    """At [4, 8000, 128], k 65, with two blocks on each of 132 SMs: 256
    blocks of four 130-row tiles, 64 partials per output."""
    assert geometry(65) == (5, 13, 2, 10, 130, 65, 195)
    per_block, chunks = plan(4, 8000, 128, 65, 264)
    assert (per_block, chunks) == (4, 16)
    assert 128 // LANES * 4 * chunks <= 264


# ---- K4 (depthwise_fwd_kernel): K5's dx machinery, the weight unflipped


def emulate_fwd(x, w, bias, slots):
    """K4 on numpy float32 inputs x [B, T, C], w [C, K], bias [C]: y [B,
    T, C].  The plan and ring of the backward on tiles FWD_WINDOWS times
    as tall, x rows alone; warp w's FWD_WINDOWS windows of Q rows each,
    one weight a tap for all, each sum started at the bias and taking the
    taps in order."""
    b, t, c = x.shape
    k = w.shape[1]
    g_n, q_n, s_n, warps, tt, kp, sr = fwd_geometry(k)
    h = (k - 1) // 2
    per_block, chunks = plan(b, t, c, k, slots, fwd=True)
    tiles = -(-t // tt)
    y = np.full_like(x, np.nan)
    n_w = FWD_WINDOWS
    # window n of warp w starts at row (w * n_w + n) * Q: [warps * n_w]
    r0 = np.arange(warps * n_w) * q_n
    for c0 in range(0, c, LANES):
        lanes = min(LANES, c - c0)
        ws = np.zeros((kp, LANES), np.float32)   # as it is, zero past K
        ws[:k, :lanes] = w[c0:c0 + lanes].T
        start = np.zeros(LANES, np.float32)
        start[:lanes] = bias[c0:c0 + lanes]
        for bb in range(b):
            for chunk in range(chunks):
                first = chunk * per_block
                n = min(per_block, tiles - first)
                assert n >= 1
                ring = [stage(x, bb, first, c0, tt, sr, h), None]
                for kk in range(n):
                    if kk + 1 < n:
                        ring[(kk + 1) & 1] = stage(x, bb, first + kk + 1,
                                                   c0, tt, sr, h)
                    xs = ring[kk & 1]
                    acc = [np.broadcast_to(start, (warps * n_w, LANES))
                           for _ in range(q_n)]
                    win = [xs[r0 + q] for q in range(q_n)]
                    for jb in range(0, kp, q_n):
                        for jj in range(q_n):
                            wv = ws[jb + jj]
                            for r in range(q_n):
                                acc[r] = fma(wv, win[(jj + r) % q_n], acc[r])
                            win[jj] = xs[r0 + jb + jj + q_n]
                    t0 = (first + kk) * tt + r0
                    for r in range(q_n):
                        for wi in range(warps * n_w):
                            if t0[wi] + r < t:
                                y[bb, t0[wi] + r, c0:c0 + lanes] = (
                                    acc[r][wi, :lanes])
    assert np.isfinite(y).all()
    return y


def reference_fwd(x, w, bias):
    """float64 y of the "same" conv."""
    t, k = x.shape[1], w.shape[1]
    h = (k - 1) // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (h, h), (0, 0)))
    y = np.broadcast_to(bias.astype(np.float64), x.shape).copy()
    for tap in range(k):
        y += xp[:, tap:tap + t] * w[:, tap]
    return y


def fwd_case(b, t, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(c, k)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    return x, w, bias


def test_k4_takes_the_backward_windows():
    """K4 is instantiated for every window Q that K5 and K6 are, and its
    shared memory (two x buffers and the weight) fits a block."""
    body = SOURCE[SOURCE.index("const void* pick(Kind kind)"):]
    body = body[:body.index("return nullptr")]
    assert "&depthwise_fwd_kernel<Q>" in body
    for k in range(1, MAX_KERNEL + 1, 2):
        _, _, _, _, _, kp, sr = fwd_geometry(k)
        assert 4 * (2 * sr + kp) * LANES <= SMEM_PER_BLOCK


# K 3, 65 and 81 with C 128, 96 (three lane groups) and 33 (a lane group
# of one channel, 4-byte copies); T under one tile, T one row past a tile
# and past several; slots 3 walks chunks of several tiles through the
# ring, 264 (two blocks on each of 132 SMs) is the card's plan at k 65
FWD_TILE = {k: fwd_geometry(k)[4] for k in (3, 65, 81)}
FWD_CASES = [(2, FWD_TILE[65] + 1, 128, 65, 264),
             (1, 2 * FWD_TILE[65] + 5, 96, 65, 3), (2, 50, 33, 65, 264),
             (1, FWD_TILE[81] + 7, 128, 81, 3), (2, 40, 96, 81, 264),
             (1, 100, 33, 81, 3), (2, 3 * FWD_TILE[3] + 1, 128, 3, 3),
             (1, 5, 96, 3, 264), (2, 2 * FWD_TILE[3] - 1, 33, 3, 264)]


@pytest.mark.parametrize("b,t,c,k,slots", FWD_CASES)
def test_k4_tiling_matches_float64_and_plain(b, t, c, k, slots):
    x, w, bias = fwd_case(b, t, c, k, 100 * k + t + c)
    y = emulate_fwd(x, w, bias, slots)
    ref = reference_fwd(x, w, bias)
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()
    plain = depthwise_fwd_plain(torch.from_numpy(x),
                                torch.from_numpy(w[:, None, :].copy()),
                                torch.from_numpy(bias))
    np.testing.assert_allclose(y, plain.numpy(), rtol=1e-5, atol=1e-5)


def test_k4_tiling_matches_the_jax_kernel():
    """At C 128, the JAX kernel's channel block, against ``_impl_fwd`` in
    interpret mode (its weight [K, C])."""
    x, w, bias = fwd_case(2, 200, 128, 65, 5)
    y = emulate_fwd(x, w, bias, 264)
    ref = jax_impl_fwd(jnp.asarray(x), jnp.asarray(w.T.copy()),
                       jnp.asarray(bias), True)
    np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_k4_plan_at_the_main_shape():
    """At [4, 8000, 128], k 65, with two blocks on each of 132 SMs: 256
    blocks of two 260-row tiles (the last chunk one)."""
    assert fwd_geometry(65) == (5, 13, 2, 10, 260, 65, 325)
    per_block, chunks = plan(4, 8000, 128, 65, 264, fwd=True)
    assert (per_block, chunks) == (2, 16)
    assert 128 // LANES * 4 * chunks <= 264
