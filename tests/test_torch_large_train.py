"""Large training on the CPU: the train kernels' plain versions at
Large's widths against the JAX package, the CUDA kernels' Large
instances emulated in numpy, and a train step with one speaker-split
block per stage against ``make_train_step``.

- ``gcfn_train_plain`` (K7) and its autograd (K8) at F = 256 against
  ``gcfn_train_reference`` and ``jax.vjp`` of it, at p 0 and 0.1, and
  one case against the Pallas kernels in interpret mode.
- ``softmax_pv_dropout_plain`` (K9, K9b with ``bias``) and
  ``softmax_pv_dropout_bwd_plain`` (K10, K10b) at head width 32, ragged
  key lengths, p 0.1, against ``softmax_pv_dropout_reference`` and its
  VJP, and one case against the Pallas kernel in interpret mode.
- K8's row pass at F = 256 (``csrc/gcfn_train.cu``): its shared-memory
  plan, the warps' ownership of the products' fragments, and the pass in
  numpy (28-row tiles, chunks of 128 GLU pairs, 3xTF32 products) against
  float64.
- K10 at head width 32 (``csrc/softmax_pv_train.cu``): its ring's plan
  and its lane layout in numpy (two keys a lane, eight lanes a row's
  statistics, the warps' dV partials summed in warp order) against
  float64.
- One train step at dropout 0 with ``per_stage_spk_split``: the metrics,
  every gradient (the split blocks' among them) and the BatchNorm
  statistics against the JAX package's ``make_train_step``.

Inputs are numpy-seeded; each tolerance is stated where it is used.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.config import OptimConfig as JaxOptimConfig
from sepreformer_tpu.config import VariantConfig as JaxVariantConfig
from sepreformer_tpu.engine.train import TrainState as JaxTrainState
from sepreformer_tpu.engine.train import make_optimizer as jax_make_optimizer
from sepreformer_tpu.engine.train import make_train_step
from sepreformer_tpu.ops.pallas.gcfn_train import (
    fused_gcfn_train as jax_fused_gcfn_train,
)
from sepreformer_tpu.ops.pallas.gcfn_train import gcfn_train_reference
from sepreformer_tpu.ops.pallas.softmax_pv_train import (
    softmax_pv_dropout as jax_softmax_pv_dropout,
)
from sepreformer_tpu.ops.pallas.softmax_pv_train import (
    softmax_pv_dropout_reference,
)
from sepreformer_torch.config import ModelConfig, VariantConfig
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.models import from_jax_params
from sepreformer_torch.ops.kernels import (
    gcfn_train_bwd_plain,
    gcfn_train_plain,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
)
from sepreformer_torch.ops.kernels.hash_dropout import keep_mask
from test_torch_gcfn_train import NAMES, jax_case, port_params
from test_torch_tf32x3 import mma_product
from test_torch_train import STEP_MODEL, boosted_model, port_layout, to_flax

CSRC = pathlib.Path(__file__).resolve().parents[1] / "sepreformer_torch" / "csrc"
GCFN_TRAIN = (CSRC / "gcfn_train.cu").read_text()
SOFTMAX_PV_TRAIN = (CSRC / "softmax_pv_train.cu").read_text()
SM_BYTES, BLOCK_MAX = 228 * 1024, 227 * 1024
THREE = ("a_small", "b_small", "big")    # the 3xTF32 products' terms


def constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


# ------------------------------------------------ K7/K8, plain, F = 256

@pytest.mark.parametrize("p", [0.0, 0.1])
def test_gcfn_train_plain_f256_matches_reference(p):
    """Forward against ``gcfn_train_reference`` (rtol, atol 2e-5: float32
    in another order); dx and the nine parameter gradients against
    ``jax.vjp`` of it (rtol 1e-4, atol 1e-5 of each gradient's norm)."""
    x, dout, params = jax_case(b=1, t=40, f=256, seed=256)
    jp = [jnp.asarray(a) for a in params]
    out, vjp = jax.vjp(jax.jit(lambda xx, pp: gcfn_train_reference(
        xx, pp, 1e-5, jnp.int32(1234), p)), jnp.asarray(x), jp)
    got = gcfn_train_plain(torch.from_numpy(x), port_params(params), 1e-5,
                           1234, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    ref_dx, ref_dp = vjp(jnp.asarray(dout))
    dx, dparams = gcfn_train_bwd_plain(torch.from_numpy(x),
                                       port_params(params), 1e-5, 1234, p,
                                       torch.from_numpy(dout))
    ref_dp = [np.asarray(a) for a in ref_dp]
    ref_dp[4] = ref_dp[4].T
    for name, g, ref in zip(("x",) + NAMES, (dx, *dparams),
                            (np.asarray(ref_dx), *ref_dp)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.linalg.norm(ref),
                                   err_msg=name)


def test_gcfn_train_plain_f256_matches_the_pallas_kernels():
    """The JAX package's K7/K8 in interpret mode at F = 256, T = 32 (one
    block), p 0.1, against the plain forward and its autograd (the
    tolerances above)."""
    x, dout, params = jax_case(b=1, t=32, f=256, seed=257)
    out, vjp = jax.vjp(lambda xx, pp: jax_fused_gcfn_train(
        xx, pp, jnp.int32(7), 1e-5, 0.1, True), jnp.asarray(x),
        tuple(jnp.asarray(a) for a in params))
    got = gcfn_train_plain(torch.from_numpy(x), port_params(params), 1e-5, 7,
                           0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    ref_dx, ref_dp = vjp(jnp.asarray(dout))
    dx, dparams = gcfn_train_bwd_plain(torch.from_numpy(x),
                                       port_params(params), 1e-5, 7, 0.1,
                                       torch.from_numpy(dout))
    ref_dp = [np.asarray(a) for a in ref_dp]
    ref_dp[4] = ref_dp[4].T
    for name, g, ref in zip(("x",) + NAMES, (dx, *dparams),
                            (np.asarray(ref_dx), *ref_dp)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.linalg.norm(ref),
                                   err_msg=name)


# ---------------------------------------------- K9/K10, plain, d = 32

def attention_case(lp=64, heads=2, d=32, seed=32):
    rng = np.random.default_rng(seed)
    b = 2
    scores = (rng.normal(size=(b, heads, lp, lp)) * 3).astype(np.float32)
    bias = rng.normal(size=(b, heads, lp, lp)).astype(np.float32)
    v = rng.normal(size=(b, lp, heads * d)).astype(np.float32)
    dout = rng.normal(size=(b, lp, heads * d)).astype(np.float32)
    return scores, bias, v, dout


LENGTH, LENS = 60, (60, 23)     # ragged: the second row's keys end at 23


@pytest.mark.parametrize("with_bias", [False, True])
def test_softmax_pv_dropout_plain_d32_matches_reference(with_bias):
    """Forward against ``softmax_pv_dropout_reference`` and (dScores, dV)
    against its VJP (dScores also the bias's cotangent), p 0.1: rtol and
    atol 1e-5 (float32 in another order)."""
    scores, bias, v, dout = attention_case()
    jb = jnp.asarray(bias) if with_bias else None
    jl = jnp.asarray(LENS, jnp.int32)

    def ref(s, vv, *bb):
        return softmax_pv_dropout_reference(s, vv, jnp.int32(31), jl, LENGTH,
                                            0.1, *bb)

    args = (jnp.asarray(scores), jnp.asarray(v)) + ((jb,) if with_bias
                                                    else ())
    out, vjp = jax.vjp(jax.jit(ref), *args)
    grads = [np.asarray(a) for a in vjp(jnp.asarray(dout))]
    tb = torch.from_numpy(bias) if with_bias else None
    tl = torch.tensor(LENS)
    got = softmax_pv_dropout_plain(torch.from_numpy(scores),
                                   torch.from_numpy(v), 31, tl, LENGTH, 0.1,
                                   tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    ds, dv = softmax_pv_dropout_bwd_plain(
        torch.from_numpy(scores), torch.from_numpy(v), 31, tl, LENGTH, 0.1,
        torch.from_numpy(dout), tb)
    np.testing.assert_allclose(ds.numpy(), grads[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), grads[1], rtol=1e-5, atol=1e-5)
    if with_bias:
        np.testing.assert_allclose(ds.numpy(), grads[2], rtol=1e-5,
                                   atol=1e-5)


def test_softmax_pv_dropout_plain_d32_matches_the_pallas_kernel():
    """The JAX package's K9/K10 in interpret mode at head width 32, Lp 128
    (its 128-aligned length), ragged, p 0.1: the forward and both
    gradients against the plain versions (rtol, atol 1e-5)."""
    scores, _, v, dout = attention_case(lp=128, seed=33)
    lens, length = (100, 41), 100
    jl = jnp.asarray(lens, jnp.int32)
    out, vjp = jax.vjp(lambda s, vv: jax_softmax_pv_dropout(
        s, vv, jnp.int32(5), jl, length, 0.1, True), jnp.asarray(scores),
        jnp.asarray(v))
    ds_ref, dv_ref = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    tl = torch.tensor(lens)
    got = softmax_pv_dropout_plain(torch.from_numpy(scores),
                                   torch.from_numpy(v), 5, tl, length, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    ds, dv = softmax_pv_dropout_bwd_plain(
        torch.from_numpy(scores), torch.from_numpy(v), 5, tl, length, 0.1,
        torch.from_numpy(dout))
    np.testing.assert_allclose(ds.numpy(), ds_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), dv_ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------- K8's row pass at F = 256

TT = constant(GCFN_TRAIN, "kBwdTT")


def k8_plan(f):
    """``BwdShape<F>``: F/16 warps, each owning 16 columns of F and 8 of a
    chunk's GLU pairs; chunks of CH = F/2 pairs (NC = F hidden columns);
    the shared-memory layout's bytes and the blocks an SM holds."""
    warps = f // 16
    ch, r4, r2 = 8 * warps, TT + 4, TT + 2
    nc = 2 * ch
    lx, lu, lg = f + 8, nc + 8, ch + 8
    small = 4 * f + 5 * 6 * f
    floats = (r4 * lx + 32 * lx + (r4 + 2) * lu + r2 * lu + 32 * lg
              + 32 * lg + small)
    smem = 4 * floats
    return dict(warps=warps, threads=32 * warps, ch=ch, chunks=3 * f // ch,
                smem=smem, blocks=2 if smem <= 113 * 1024 else 1,
                lu=lu, r2=r2)


def test_k8_f256_plan():
    """Base's row pass keeps its plan (8 warps, 105 KB, two blocks per
    SM, chunks of 64 pairs); F = 256's takes 16 warps in one 205 KB
    block per SM, chunks of 128 pairs, and o0 and dxn of the tile rows
    still fit u and y at the end (NC = F)."""
    base, large = k8_plan(128), k8_plan(256)
    assert (base["warps"], base["smem"], base["blocks"], base["ch"],
            base["chunks"]) == (8, 105472, 2, 64, 6)
    assert (large["warps"], large["threads"], large["smem"], large["blocks"],
            large["ch"], large["chunks"]) == (16, 512, 204800, 1, 128, 6)
    assert large["smem"] <= BLOCK_MAX
    assert 2 * (large["smem"] + 1024) > SM_BYTES
    assert TT <= large["r2"] and large["lu"] >= 256
    for text in ("kWarps = F / 16, kThreads = 32 * kWarps",
                 "CH = 8 * kWarps",
                 "blocks_per_sm = smem_bytes <= 113 * 1024 ? 2 : 1",
                 "row_groups = kSMs * blocks_per_sm"):
        assert text in GCFN_TRAIN, text


def frag(lane, e):
    """A lane's (row, column) of fragment element e of an m16n8 C tile."""
    return (lane >> 2) + 8 * (e >> 1), 2 * (lane & 3) + (e & 1)


@pytest.mark.parametrize("f", [128, 256])
def test_k8_warps_own_every_fragment_once(f):
    """The four products' C fragments as the row pass assigns them (the
    kernel's index expressions): u [32, NC], each warp 16 local columns;
    o0 and dxn [32, F], each warp 16 columns; dg [32, CH], each warp 8
    pairs; and the small sums' columns, one thread each.  Every element
    is written by exactly one (warp, lane, fragment)."""
    plan = k8_plan(f)
    warps, ch = plan["warps"], plan["ch"]
    nc = 2 * ch
    for cols, nts, width in ((nc, 2, 16), (f, 2, 16), (ch, 1, 8)):
        count = np.zeros((32, cols), int)
        for w in range(warps):
            for lane in range(32):
                for mt in range(2):
                    for nt in range(nts):
                        for e in range(4):
                            r, c = frag(lane, e)
                            count[16 * mt + r, width * w + 8 * nt + c] += 1
        assert (count == 1).all()
    # steps 4 and 5: thread tid < F one column's sum, tid - F the other's
    assert plan["threads"] == 2 * f


def k8_f64(x, params, dout, eps):
    """dx of the GCFN in float64 (p 0) by autograd."""
    xd = torch.from_numpy(x).double().requires_grad_()
    pd = [torch.from_numpy(a).double() for a in params]
    out = gcfn_train_plain(xd, pd, eps, 0, 0.0)
    (dx,) = torch.autograd.grad(out, xd, torch.from_numpy(dout).double())
    return dx.numpy()


def k8_rows(x, params, dout, eps, terms):
    """dx from K8's row pass in numpy at p 0: tiles of TT rows; LN of the
    rows t0-2 .. t0+TT+1 in float32, do0 = dout * ls of the rows t0-1 ..
    t0+TT; per chunk of CH = F/2 GLU pairs: u = xn win_c (``terms``, from
    zeroed fragments) + bin, zero outside [0, T); y = dw3(u) for t0-1 ..
    t0+TT; g; o0 += g wout_c; dg = do0 wout_c^T; dy through the GLU (zero
    outside [0, T)); du by the transposed conv; dxn += du win_c^T; then
    the LayerNorm backward.  Products are [32, *] fragments, rows past
    the tile's zero."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    b, t, f = x.shape
    h3, ch = 3 * f, f // 2
    dx = np.empty_like(x)
    one = np.float32(1)
    for bi in range(b):
        for t0 in range(0, t, TT):
            rows = np.arange(t0 - 2, t0 + TT + 2)            # 32 LN rows
            inside = (rows >= 0) & (rows < t)
            xr = np.where(inside[:, None], x[bi, np.clip(rows, 0, t - 1)],
                          np.float32(0))
            c = xr - xr.mean(-1, keepdims=True, dtype=np.float32)
            inv = one / np.sqrt((c * c).mean(-1, keepdims=True)
                                + np.float32(eps))
            xn = np.where(inside[:, None], c * inv * lns + lnb,
                          np.float32(0))
            d0 = np.zeros((32, f), np.float32)                # t0-1 ..
            d0[:TT + 2] = np.where(inside[1:-1, None],
                                   dout[bi, np.clip(rows[1:-1], 0, t - 1)]
                                   * ls, np.float32(0))
            dxn = np.zeros((32, f), np.float32)
            for c0 in range(0, h3, ch):
                cols = np.r_[c0:c0 + ch, h3 + c0:h3 + c0 + ch]
                u = np.where(inside[:, None],
                             mma_product(xn, win[:, cols], terms)
                             + bin_[cols], np.float32(0))
                w = wdw[cols]
                y = (u[:-2] * w[:, 0] + u[1:-1] * w[:, 1] + u[2:] * w[:, 2]
                     + bdw[cols])                             # t0-1 .. t0+TT
                a, gate = y[:, :ch], y[:, ch:]
                sg = one / (one + np.exp(-gate))
                dg = mma_product(d0, wout[c0:c0 + ch].T, terms)[:TT + 2]
                dy = np.where(inside[1:-1, None],
                              np.concatenate([dg * sg, dg * a * sg
                                              * (one - sg)], 1),
                              np.float32(0))
                du = (dy[2:] * w[:, 0] + dy[1:-1] * w[:, 1]
                      + dy[:-2] * w[:, 2])                     # t0 .. +TT-1
                du = np.where((np.arange(t0, t0 + TT) < t)[:, None], du,
                              np.float32(0))
                du32 = np.zeros((32, 2 * ch), np.float32)
                du32[:TT] = du
                dxn = dxn + mma_product(du32, win[:, cols].T, terms)
            n = min(TT, t - t0)
            hat = c[2:2 + n] * inv[2:2 + n]
            dh = dxn[:n] * lns
            m1 = dh.mean(-1, keepdims=True)
            m2 = (dh * hat).mean(-1, keepdims=True)
            dx[bi, t0:t0 + n] = (dout[bi, t0:t0 + n]
                                 + (dh - m1 - hat * m2) * inv[2:2 + n])
    return dx


@pytest.mark.parametrize("t", [57, 28])
def test_k8_f256_row_pass_holds_float32_accuracy(t):
    """K8's row pass at F = 256 (dx, through the u, dg and dxn products of
    each tile): within 2e-6 of max|dx| of float64 with the three TF32
    products, and over 1e-4 with one.  T 57 ends a row into a third tile;
    T 28 is one tile."""
    x, dout, params = jax_case(b=1, t=t, f=256, seed=t)
    params = port_params(params)
    params = [a.numpy() for a in params]
    params[2] = params[2] * np.float32(0.7)      # keep dxn's scale modest
    params[8] = np.ones_like(params[8])
    ref = k8_f64(x, params, dout, 1e-5)
    scale = np.abs(ref).max()
    err3 = np.abs(k8_rows(x, params, dout, 1e-5, THREE) - ref).max() / scale
    err1 = np.abs(k8_rows(x, params, dout, 1e-5, ("big",)) - ref).max()
    assert err3 < 2e-6, err3
    assert err1 / scale > 1e-4, err1 / scale


# ---------------------------------------------------- K10 at d = 32

def k10_plan(d, bias):
    """``BwdStage<D, HAS_BIAS>``: the ring's stages and bytes, the dV
    partials' bytes over it, the blocks an SM holds, a lane's floats."""
    rows, keys = (constant(SOFTMAX_PV_TRAIN, n)
                  for n in ("kStageRows", "kKeyTile"))
    warps = constant(SOFTMAX_PV_TRAIN, "kThreads") // 32
    stages, blocks = (4, 2) if d == 16 else (8, 1)
    floats = rows * keys * (2 if bias else 1) + 2 * rows * d + 2 * rows
    return dict(stages=stages, blocks=blocks, ring=4 * stages * floats,
                red=4 * warps * keys * (d + 4), lane_floats=5 * d,
                stats_lanes=(rows // warps) * d // 4)


def test_k10_d32_plan():
    """D = 16 keeps its ring (4 stages, 49 KB, two blocks per SM); D = 32
    holds 160 floats a lane (two keys' V and dV, a dOut row), over the
    128 registers of two blocks, so one block per SM with 8 stages (133
    KB, 199 KB with the bias), the dV partials over the ring, and a row's
    statistics in 8 lanes (4 rows of a stage a warp: 32 lanes)."""
    base = k10_plan(16, False)
    assert (base["stages"], base["ring"], base["lane_floats"]) == (4, 50176,
                                                                   80)
    assert 2 * (base["ring"] + 1024) <= SM_BYTES
    for bias in (False, True):
        large = k10_plan(32, bias)
        assert large["lane_floats"] == 160 and large["blocks"] == 1
        assert large["red"] <= large["ring"] <= BLOCK_MAX
        assert large["stats_lanes"] == 32
    assert k10_plan(32, False)["ring"] == 133120
    assert k10_plan(32, True)["ring"] == 198656
    assert "kStages = D == 16 ? 4 : 8" in SOFTMAX_PV_TRAIN
    assert "kBlocks = D == 16 ? 2 : 1" in SOFTMAX_PV_TRAIN


def k10_f64(scores, v, dout, seed, key_len, p):
    """(dS, dV) in float64 from the formulas of the Pallas backward."""
    b, h, lp, _ = scores.shape
    d = v.shape[-1] // h
    s = torch.from_numpy(scores).double()
    kmask = torch.arange(lp)[None] < torch.tensor(key_len)[:, None]
    s = torch.where(kmask[:, None, None, :], s, torch.tensor(-1e30).double())
    prob = torch.softmax(s, -1)
    rows = (torch.arange(b * h).reshape(b, h, 1, 1) * lp
            + torch.arange(lp).reshape(1, 1, lp, 1))
    scale = keep_mask(seed, 0, rows, torch.arange(lp).reshape(1, 1, 1, lp),
                      p).double() / (1 - p)
    g = torch.from_numpy(dout).double().reshape(b, lp, h, d).transpose(1, 2)
    vh = torch.from_numpy(v).double().reshape(b, lp, h, d).transpose(1, 2)
    dv = torch.matmul((prob * scale).transpose(-1, -2), g)
    dp = torch.matmul(g, vh.transpose(-1, -2)) * scale
    ds = prob * (dp - (dp * prob).sum(-1, keepdim=True))
    return ds.numpy(), dv.transpose(1, 2).reshape(b, lp, h * d).numpy()


def k10_lanes(scores, v, dout, seed, key_len, p, d):
    """K10 in numpy as its block runs it: 64 keys a block, lane l the keys
    2l and 2l+1 (V and dV partials in float32), warp w the rows i with
    i % 8 == w of each 32-row stage, in row order; a row's max and sum
    from the forward's statistics, dOut . out from d/4 float4 partials
    summed by xor-shuffles (1, 2, 4 at d 32); dP as two chains over the
    even and odd columns; the warps' dV partials summed in warp order."""
    b, h, lp, _ = scores.shape
    f32 = np.float32
    ds = np.zeros_like(scores)
    dv = np.zeros_like(v)
    out_ref = softmax_pv_dropout_plain(torch.from_numpy(scores),
                                       torch.from_numpy(v), seed,
                                       torch.tensor(key_len), lp, p).numpy()
    cols = torch.arange(lp)
    for bi in range(b):
        lim = key_len[bi]
        for hi in range(h):
            s = scores[bi, hi]
            m = np.max(s[:, :lim], -1)
            lsum = np.exp(s[:, :lim] - m[:, None]).sum(-1, dtype=f32)
            keep = keep_mask(seed, 0, (bi * h + hi) * lp + cols[:, None],
                             cols[None], p).numpy()
            scale = np.where(keep, f32(1 / (1 - p)), f32(0)).astype(f32)
            g_all = dout[bi, :, hi * d:(hi + 1) * d]
            o_all = out_ref[bi, :, hi * d:(hi + 1) * d]
            parts = (g_all * o_all).reshape(lp, d // 4, 4).sum(-1, dtype=f32)
            step = 1
            while step < d // 4:              # the xor-shuffle butterfly
                idx = np.arange(d // 4) ^ step
                parts = parts + parts[:, idx]
                step *= 2
            rowdot = parts[:, 0]
            for j0 in range(0, lp, 64):
                keys = np.arange(j0, min(j0 + 64, lp))
                vj = v[bi, keys, hi * d:(hi + 1) * d] * (keys < lim)[:, None]
                partial = np.zeros((8, len(keys), d), f32)
                for i in range(lp):
                    e = np.exp(s[i, keys] - m[i]).astype(f32) * (f32(1)
                                                                 / lsum[i])
                    prob = np.where(keys < lim, e, f32(0))
                    g = g_all[i]
                    d0 = (g[0::2] * vj[:, 0::2]).sum(-1, dtype=f32)
                    d1 = (g[1::2] * vj[:, 1::2]).sum(-1, dtype=f32)
                    sc = scale[i, keys]
                    ds[bi, hi, i, keys] = prob * ((d0 + d1) * sc - rowdot[i])
                    partial[i % 8] += (prob * sc)[:, None] * g[None]
                acc = np.zeros((len(keys), d), f32)
                for w in range(8):
                    acc = acc + partial[w]
                dv[bi, keys, hi * d:(hi + 1) * d] = acc
    return ds, dv


@pytest.mark.parametrize("lp,key_len", [(136, (130, 1)), (77, (77, 40))])
def test_k10_d32_lane_layout_holds_float32_accuracy(lp, key_len):
    """K10's lane layout at head width 32, p 0.1: dS and dV within 1e-5 of
    their largest float64 values.  Lp 136 ends a stage 8 rows in and a key
    block past lim, a row with one valid key; Lp 77 is odd."""
    rng = np.random.default_rng(lp)
    b, h, d = 2, 2, 32
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    dout = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    ds_ref, dv_ref = k10_f64(scores, v, dout, 1234, key_len, 0.1)
    ds, dv = k10_lanes(scores, v, dout, 1234, key_len, 0.1, d)
    assert np.abs(ds - ds_ref).max() <= 1e-5 * np.abs(ds_ref).max()
    assert np.abs(dv - dv_ref).max() <= 1e-5 * np.abs(dv_ref).max()


# ------------------------------- the step with per_stage_spk_split

SPLIT_MODEL = dict(STEP_MODEL, per_stage_spk_split=True)


@pytest.fixture(scope="module")
def split_step():
    """One train step of the port and of the JAX package from the same
    weights and batch, one speaker-split block per stage (dropout 0,
    every LayerScale at 0.5)."""
    cfg = VariantConfig("split", model=ModelConfig(**SPLIT_MODEL))
    jcfg = JaxVariantConfig(name="split",
                            model=JaxModelConfig(**SPLIT_MODEL),
                            optim=JaxOptimConfig(lr=1e-3))
    model = boosted_model(cfg.model, seed=5)
    sd = model.state_dict()
    params = to_flax(sd, cfg.model)
    stats = to_flax(sd, cfg.model, "batch_stats")
    t = 2000
    rng = np.random.default_rng(5)
    x = rng.normal(scale=0.1, size=(2, t)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, t)).astype(np.float32)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats,
                           opt_state=jax_make_optimizer(jcfg).init(params))
    new_jstate, jm = make_train_step(jcfg, donate=False, debug_grads=True)(
        jstate, jnp.asarray(x), jnp.asarray(s), jnp.float32(1e-3),
        jnp.float32(0.4), jax.random.key(1))
    state = create_train_state(
        cfg, model=from_jax_params(params, stats, cfg.model, device="cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(s),
                             1e-3, 0.4, torch.Generator().manual_seed(1))
    finally:
        torch.set_num_threads(n)
    return cfg, state, metrics, new_jstate, jm


def test_split_step_metrics_match_jax(split_step):
    """The step's metrics at rtol 1e-4."""
    _, _, metrics, _, jm = split_step
    for name in ("total_loss", "time_loss", "mag_loss_0", "mag_loss_mean",
                 "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)


def test_split_step_gradients_match_jax(split_step):
    """Every gradient, the num_stages + 1 split blocks' among them, at the
    JAX package's bar (rtol 2e-3, atol 1e-5 of the gradient norm; the
    step's clip applied to JAX's gradients too)."""
    cfg, state, _, _, jm = split_step
    norm = float(jm["grad_norm"])
    clip = min(1.0, cfg.optim.clip_norm / norm)
    ref = port_layout(jax.tree.map(np.asarray, jm["grads"]), cfg.model)
    named = dict(state.model.named_parameters())
    assert set(ref) == set(named)
    split = {k for k in named if k.startswith("separator.spk_split_block.")}
    assert {k.split(".")[2] for k in split} == {
        str(i) for i in range(cfg.model.num_stages + 1)}
    for key, g in ref.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g * clip,
                                   rtol=2e-3, atol=1e-5 * norm * clip,
                                   err_msg=key)


def test_split_step_batch_statistics_match_jax(split_step):
    """The BatchNorm statistics after the step at rtol 1e-4, atol 1e-6."""
    cfg, state, _, new_jstate, _ = split_step
    stats = to_flax(state.model.state_dict(), cfg.model, "batch_stats")
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, new_jstate.batch_stats))
    assert flat
    for path, value in flat:
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, value, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))
