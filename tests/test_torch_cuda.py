"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card.
"""

import numpy as np
import pytest
import torch

from sepreformer_torch.ops.kernels import (
    attention_train_bwd,
    attention_train_bwd_plain,
    attention_train_fwd,
    attention_train_fwd_bf16,
    attention_train_plain,
    cla_plain,
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_bwd_w,
    depthwise_bwd_w_plain,
    depthwise_fwd,
    depthwise_fwd_plain,
    ega_tail_gcfn_plain,
    flash_relpos_attention,
    flash_relpos_attention_plain,
    flash_relpos_attention_train,
    fused_cla,
    fused_ega_tail_gcfn,
    fused_gcfn,
    fused_gcfn_train,
    gcfn_plain,
    gcfn_train_bwd,
    gcfn_train_bwd_plain,
    gcfn_train_fwd,
    gcfn_train_plain,
    materialize_pos_kt,
    materialize_pos_kt_plain,
    pos_kt,
    sisnr_pairwise_neg,
    sisnr_pairwise_neg_fused,
    softmax_pv,
    softmax_pv_bias,
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
    softmax_pv_plain,
    softmax_pv_train_bwd,
    softmax_pv_train_bwd_bias,
    softmax_pv_train_fwd,
    softmax_pv_train_fwd_bias,
)
from sepreformer_torch.ops.kernels.softmax_pv_train import (
    softmax_pv_train_bwd_bf16,
    softmax_pv_train_fwd_bf16,
)

# float32 sums in the kernels' order against cuBLAS's
CARD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def gcfn_params(gen, f, device):
    h = 6 * f
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((h, 3), 0.3), ((h,), 0.1), ((h // 2, f), 0.1),
                     ((f,), 0.1), ((f,), 0.5)]
    return [(torch.randn(s, generator=gen) * sc).to(device)
            for s, sc in shapes_scales]


@pytest.mark.cuda
# K1's tile is 62 rows: T 63 and 125 end one row into a tile, T 124 is a
# multiple of it, B*T = 20 is under one tile, and the explicit lengths end
# mid-tile (93), on a tile edge (62, 124) and one row past it (63)
@pytest.mark.parametrize("b,t,f,masked", [(2, 500, 128, True),
                                          (3, 77, 128, False),
                                          (4, 8000, 128, True),
                                          (2, 63, 128, False),
                                          (2, 125, 128, True),
                                          (2, 124, 128, False),
                                          (1, 20, 128, (13,)),
                                          (4, 200, 128, (93, 62, 124, 63))])
def test_gcfn_kernel_matches_plain(cuda_device, b, t, f, masked):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device)
    params = gcfn_params(gen, f, cuda_device)
    lens = None
    if masked is True:
        lens = torch.tensor([t, max(1, t // 3)] + [t] * (b - 2),
                            device=cuda_device)
    elif masked:
        lens = torch.tensor(masked, device=cuda_device)
    ref = gcfn_plain(x, params, 1e-5, lens)
    before = fused_gcfn.launches
    got = fused_gcfn(x, params, 1e-5, lens)
    torch.cuda.synchronize()
    assert fused_gcfn.launches == before + 1
    torch.testing.assert_close(got, ref, **CARD_TOL)


@pytest.mark.cuda
def test_relpos_kernel_matches_plain(cuda_device):
    table = torch.randn(4000, 16, device=cuda_device)
    got = materialize_pos_kt(table, 512, 2000)
    torch.cuda.synchronize()
    assert torch.equal(got, materialize_pos_kt_plain(table, 512, 2000))


# K2's tiles are 32 rows by 32 columns: t 37 (t % 4 == 1, 4-byte stores)
# ends five rows into a second tile, 500 and 512 are the route's lengths
# before and after its padding, 1024 that of the 8 s chunks; maxlen 200
# makes both clips act; d 20 spans two table-column slices, d 32 (Large's
# head width, [512, 32, 512] from a [4000, 32] table) two whole ones; d 8,
# 12 and 20 at maxlen 2000 are the T, S and M presets' pos_kt
@pytest.mark.cuda
@pytest.mark.parametrize("t,maxlen,d", [(37, 10, 16), (500, 200, 16),
                                        (512, 200, 16), (1024, 200, 16),
                                        (512, 200, 20), (512, 2000, 32),
                                        (37, 10, 32), (512, 2000, 8),
                                        (512, 2000, 12), (512, 2000, 20),
                                        (37, 10, 12)])
def test_relpos_kernel_tilings_match_plain(cuda_device, t, maxlen, d):
    gen = torch.Generator().manual_seed(t + d)
    table = torch.randn(2 * maxlen, d, generator=gen).to(cuda_device)
    before = materialize_pos_kt.launches
    got = materialize_pos_kt(table, t, maxlen)
    again = materialize_pos_kt(table, t, maxlen)
    torch.cuda.synchronize()
    assert materialize_pos_kt.launches == before + 2
    assert torch.equal(got, materialize_pos_kt_plain(table, t, maxlen))
    assert torch.equal(got, again)


# K3's and K3b's tile walks 64 keys at a time, 16 query rows a warp, 64
# a block: b, h, Lp, length and lens (None: length, length // 2, 1).
# Lp 2048 and 8192 take many key tiles (8192 is the longest bottleneck
# length the eval route gives K3); Lp 77 is odd (4-byte loads) and ends
# inside a block; Lp 17 leaves most of a block's rows past Lp; Lp 136
# with lens 65 has lim one key into a tile; every case but 8192's holds
# a row with one valid key.  The launcher splits a row tile's keys over
# two warps where blocks of 128 rows would give no SM a second block
# (every case here but Lp 2048 and the last two, which walk them whole).
SOFTMAX_PV_SHAPES = [(3, 4, 512, 500, None), (3, 4, 2048, 1900, None),
                     (3, 4, 128, 77, None), (1, 2, 8192, 8192, (8000,)),
                     (3, 4, 17, 17, (17, 9, 1)), (3, 4, 77, 77, (1, 77, 40)),
                     (2, 4, 136, 130, (65, 1)),
                     (16, 9, 136, 130, (65, 1, 130, 129) * 4),
                     (24, 8, 77, 77, (77, 1, 40) * 8)]


def softmax_pv_case(device, b, h, lp, length, lens, seed):
    gen = torch.Generator().manual_seed(seed)
    scores = (torch.randn(b, h, lp, lp, generator=gen) * 3).to(device)
    bias = (torch.randn(b, h, lp, lp, generator=gen) * 2).to(device)
    v = torch.randn(b, lp, h * 16, generator=gen).to(device)
    lens = torch.tensor([length, length // 2, 1] if lens is None else lens,
                        device=device)
    return scores, bias, v, lens


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_kernel_matches_plain(cuda_device, b, h, lp, length,
                                         lens):
    scores, _, v, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                         lens, seed=3)
    got = softmax_pv(scores, v, lens, length)
    again = softmax_pv(scores, v, lens, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, softmax_pv_plain(scores, v, lens, length),
                               **CARD_TOL)
    assert torch.equal(got, again)    # no atomics: the same bits every run


# K5 and K6 tile time by 130 rows at k 65 (168 at k 81, 72 at k 9, 8 at
# k 1): T = 1, T = 40 (under K - 1), T = 261 (one row past two tiles),
# T = 169 at k 81 (one row past a tile), k 1, and C = 6 (4-byte copies,
# one partial channel group) beside the train path's shapes.
DEPTHWISE_BWD_SHAPES = [(4, 8000, 128, 65), (2, 500, 128, 65), (3, 77, 40, 9),
                        (2, 1, 128, 65), (2, 40, 128, 65), (2, 261, 128, 65),
                        (2, 169, 40, 81), (2, 300, 128, 1), (3, 500, 6, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", DEPTHWISE_BWD_SHAPES)
def test_depthwise_bwd_kernel_matches_plain(cuda_device, b, t, c, k):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(b, t, c, generator=gen).to(cuda_device)
    dy = torch.randn(b, t, c, generator=gen).to(cuda_device)
    w = (torch.randn(c, 1, k, generator=gen) * 0.1).to(cuda_device)
    ref = depthwise_bwd_plain(x, w, dy)
    before = depthwise_bwd.launches
    got = depthwise_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert depthwise_bwd.launches == before + 1
    # dw and db sum B*T products: float32 sums in another order
    for g, r, atol in zip(got, ref, (1e-5, 1e-3, 1e-3)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol)
    again = depthwise_bwd(x, w, dy)
    for g, a in zip(got, again):
        assert torch.equal(g, a)      # no atomics: the same bits every run


# K10 walks the rows in stages of 32 and takes 64 keys a block: Lp 512
# with length 500 is the train path's shape; Lp 136 with length 130 ends
# a row stage 8 rows in and a key block 2 keys past lim (keys 130..135
# are padding, dS 0); Lp 77 (odd) takes the 4-byte copies and scalar dS
# stores.  The ragged lens hold 1: a single valid key.  K9's and K9b's
# tile (K3's) meets lim one key into a tile at lens 65 and 129, at Lp 17
# a block that is mostly rows past Lp, and at Lp 640 (more blocks of 128
# rows than SMs) walks each row tile's keys in one warp.
K10_SHAPES = [(512, 500, (500, 313, 438, 1)), (136, 130, (130, 67, 1, 129)),
              (77, 77, (77, 1, 40, 65)), (17, 17, (17, 1, 9, 16)),
              (640, 600, (600, 1, 577, 65))]


def softmax_pv_train_case(gen, device, lp, length, lens, ragged, bias,
                          d=16):
    b, h = 4, 8
    scores = (torch.randn(b, h, lp, lp, generator=gen) * 3).to(device)
    extra = ((torch.randn(b, h, lp, lp, generator=gen) * 2).to(device)
             if bias else None)
    v = torch.randn(b, lp, h * d, generator=gen).to(device)
    dout = torch.randn(b, lp, h * d, generator=gen).to(device)
    lens = torch.tensor(lens, device=device) if ragged else None
    key_len = (torch.full((b,), length, dtype=torch.int32, device=device)
               if lens is None else lens.to(torch.int32))
    return scores, extra, v, dout, lens, key_len


@pytest.mark.cuda
@pytest.mark.parametrize("lp,length,lens", K10_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.05])
@pytest.mark.parametrize("ragged", [False, True])
def test_softmax_pv_train_kernels_match_plain(cuda_device, p, ragged, lp,
                                              length, lens):
    gen = torch.Generator().manual_seed(7)
    scores, _, v, dout, lens, key_len = softmax_pv_train_case(
        gen, cuda_device, lp, length, lens, ragged, bias=False)
    out, row_max, row_sum = softmax_pv_train_fwd(scores, v, 1234, key_len,
                                                 length, p)
    fwd_again = softmax_pv_train_fwd(scores, v, 1234, key_len, length, p)
    ds, dv = softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum,
                                  1234, key_len, length, p)
    again = softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum,
                                 1234, key_len, length, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, softmax_pv_dropout_plain(scores, v, 1234, lens, length, p),
        **CARD_TOL)
    ds_ref, dv_ref = softmax_pv_dropout_bwd_plain(scores, v, 1234, lens,
                                                  length, p, dout)
    torch.testing.assert_close(ds, ds_ref, **CARD_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    # no atomics: the same bits every run
    assert torch.equal(ds, again[0]) and torch.equal(dv, again[1])
    assert all(torch.equal(a, b) for a, b in zip((out, row_max, row_sum),
                                                 fwd_again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_bias_kernel_matches_plain(cuda_device, b, h, lp, length,
                                              lens):
    """K3b: the softmax of scores + bias, the two summed in float32."""
    scores, bias, v, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                            lens, seed=4)
    before = softmax_pv_bias.launches, softmax_pv.launches
    got = softmax_pv(scores, v, lens, length, bias=bias)
    torch.cuda.synchronize()
    assert (softmax_pv_bias.launches, softmax_pv.launches) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(
        got, softmax_pv_plain(scores, v, lens, length, bias), **CARD_TOL)
    assert torch.equal(got, softmax_pv(scores, v, lens, length, bias=bias))
    with pytest.raises(ValueError, match="bias"):
        softmax_pv(scores, v, lens, length, bias=bias[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("lp,length,lens", K10_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.05])
@pytest.mark.parametrize("ragged", [False, True])
def test_softmax_pv_train_bias_kernels_match_plain(cuda_device, p, ragged, lp,
                                                   length, lens):
    """K9b and K10b: K9 and K10 on scores + bias."""
    gen = torch.Generator().manual_seed(42)
    scores, bias, v, dout, lens, key_len = softmax_pv_train_case(
        gen, cuda_device, lp, length, lens, ragged, bias=True)
    out, row_max, row_sum = softmax_pv_train_fwd_bias(
        scores, bias, v, 1234, key_len, length, p)
    fwd_again = softmax_pv_train_fwd_bias(scores, bias, v, 1234, key_len,
                                          length, p)
    ds, dv = softmax_pv_train_bwd_bias(scores, bias, v, out, dout, row_max,
                                       row_sum, 1234, key_len, length, p)
    again = softmax_pv_train_bwd_bias(scores, bias, v, out, dout, row_max,
                                      row_sum, 1234, key_len, length, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, softmax_pv_dropout_plain(scores, v, 1234, lens, length, p, bias),
        **CARD_TOL)
    ds_ref, dv_ref = softmax_pv_dropout_bwd_plain(scores, v, 1234, lens,
                                                  length, p, dout, bias)
    torch.testing.assert_close(ds, ds_ref, **CARD_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(ds, again[0]) and torch.equal(dv, again[1])
    assert all(torch.equal(a, b) for a, b in zip((out, row_max, row_sum),
                                                 fwd_again))


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_softmax_pv_train_fwd_at_long_length(cuda_device, bias):
    """K9 and K9b walk 128 key tiles at Lp 8192 (a small B x H): the
    output against the plain version, and the row statistics that K10
    reads, the max over the valid keys and the sum of exp(s - max)."""
    b, h, lp, length, p = 1, 2, 8192, 8000, 0.05
    scores, extra, v, _ = softmax_pv_case(cuda_device, b, h, lp, length,
                                          (length,), seed=5)
    extra = extra if bias else None
    key_len = torch.tensor([7999], dtype=torch.int32, device=cuda_device)

    def run():
        if extra is None:
            return softmax_pv_train_fwd(scores, v, 77, key_len, length, p)
        return softmax_pv_train_fwd_bias(scores, extra, v, 77, key_len,
                                         length, p)

    out, row_max, row_sum = run()
    again = run()
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, softmax_pv_dropout_plain(scores, v, 77, key_len, length, p,
                                      extra), **CARD_TOL)
    s = (scores if extra is None else scores + extra)[..., :7999]
    torch.testing.assert_close(row_max, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(
        row_sum, torch.exp(s - row_max[..., None]).sum(-1), rtol=1e-5,
        atol=0)
    assert all(torch.equal(a, b) for a, b in zip((out, row_max, row_sum),
                                                 again))


@pytest.mark.cuda
def test_softmax_pv_dropout_bias_gradient_on_the_card(cuda_device):
    """softmax_pv_dropout with bias under autograd (K9b, K10b): dscores,
    dv and dbias against the plain autograd; dbias in storage of its
    own."""
    b, h, lp, d, length = 2, 8, 128, 16, 100
    gen = torch.Generator().manual_seed(43)
    scores, bias = (torch.randn(b, h, lp, lp, generator=gen).to(cuda_device)
                    for _ in range(2))
    v = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    g = torch.randn(b, length, h * d, generator=gen).to(cuda_device)
    grads = []
    before = (softmax_pv_train_fwd_bias.launches,
              softmax_pv_train_bwd_bias.launches)
    for fn in (softmax_pv_dropout, softmax_pv_dropout_plain):
        leaves = [a.clone().requires_grad_() for a in (scores, v, bias)]
        out = fn(leaves[0], leaves[1], 9, None, length, 0.1, bias=leaves[2])
        (out[:, :length] * g).sum().backward()
        grads.append([a.grad for a in leaves])
    assert (softmax_pv_train_fwd_bias.launches,
            softmax_pv_train_bwd_bias.launches) == (before[0] + 1,
                                                    before[1] + 1)
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    assert grads[0][0].data_ptr() != grads[0][2].data_ptr()


@pytest.mark.cuda
def test_softmax_pv_dropout_gradient_on_the_card(cuda_device):
    b, h, lp, d, length = 2, 8, 128, 16, 100
    gen = torch.Generator().manual_seed(8)
    scores = torch.randn(b, h, lp, lp, generator=gen).to(cuda_device)
    v = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    g = torch.randn(b, length, h * d, generator=gen).to(cuda_device)
    grads = []
    for fn in (softmax_pv_dropout, softmax_pv_dropout_plain):
        s_t = scores.clone().requires_grad_()
        v_t = v.clone().requires_grad_()
        (fn(s_t, v_t, 9, None, length, 0.1)[:, :length] * g).sum().backward()
        grads.append((s_t.grad, v_t.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# [2, 2, 32000]: the 4 s train crop; S 3; T 1000 (a chunk of 128 a
# block, the last one short); T 480000 (60 s of validation: past what a
# cluster holds in shared memory, so each block reads the rest of its
# chunk from memory); T 4003 (not a multiple of 4: 4-byte copies); and a
# pair at about 60 dB (unclamped), where the residual's explicit sum
# matters
@pytest.mark.cuda
@pytest.mark.parametrize("s,b,t,noise,clamp", [
    (2, 2, 32000, 0.02, -30.0), (3, 2, 32000, 0.02, -30.0),
    (2, 3, 1000, 0.02, -30.0), (2, 2, 480000, 0.02, -30.0),
    (2, 1, 4003, 0.02, -30.0), (2, 2, 32000, 1e-4, None)])
def test_pit_kernel_and_gradient_match_plain(cuda_device, s, b, t, noise,
                                             clamp):
    gen = torch.Generator().manual_seed(9)
    src = (torch.randn(s, b, t, generator=gen) * 0.1).to(cuda_device)
    est = src.flip(0) + noise * torch.randn(s, b, t,
                                            generator=gen).to(cuda_device)
    results = []
    for fn in (sisnr_pairwise_neg_fused, sisnr_pairwise_neg):
        e = est.clone().requires_grad_()
        table = fn(e, src, clamp_db=clamp)
        table.sum().backward()
        results.append((table.detach(), e.grad))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-4,
                               atol=1e-6)
    # the cluster's sums run in a fixed order: the same bits every run
    with torch.no_grad():
        assert torch.equal(sisnr_pairwise_neg_fused(est, src, clamp_db=clamp),
                           sisnr_pairwise_neg_fused(est, src, clamp_db=clamp))


@pytest.mark.cuda
def test_pos_kt_gradient_on_the_card(cuda_device):
    table = torch.randn(4000, 16, device=cuda_device)
    g = torch.randn(512, 16, 512, device=cuda_device)
    grads = []
    for fn in (pos_kt, materialize_pos_kt_plain):
        tab = table.clone().requires_grad_()
        (fn(tab, 512, 2000) * g).sum().backward()
        grads.append(tab.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-3)
    # the adjoint sums diagonals with no atomics: it repeats bit for bit
    tab = table.clone().requires_grad_()
    (pos_kt(tab, 512, 2000) * g).sum().backward()
    assert torch.equal(tab.grad, grads[0])


@pytest.mark.cuda
def test_eval_kernels_refuse_autograd(cuda_device):
    """K2 has no backward (``pos_kt`` is its gradient): under autograd it
    raises instead of returning a result with no gradient.  K1, K3 and
    K12 have their plain versions' gradients (the tests below)."""
    table = torch.randn(40, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        materialize_pos_kt(table, 32, 20)
    with torch.no_grad():
        materialize_pos_kt(table, 32, 20)


def grads_of(fn, args, w):
    """Gradients of sum(fn(*leaves) * w) with respect to every argument."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    (fn(*leaves) * w).sum().backward()
    return [a.grad for a in leaves]


def assert_grads_match(got, ref, name):
    """Each gradient within 1e-4 of the largest value of the plain
    version's own: the backward recomputes the plain version, so only
    the kernel's forward can differ, and it does not reach the
    gradient."""
    for g, r in zip(got, ref):
        assert g is not None and g.shape == r.shape, name
        assert (g - r).abs().max() <= 1e-4 * r.abs().max(), name


@pytest.mark.cuda
def test_eval_kernel_gradients_match_plain(cuda_device):
    """K1, K3 and K3b under autograd: the forward launches the kernel, the
    backward recomputes the plain version, as the JAX package's
    ``custom_vjp``s do; gradients of every input against the plain
    version's autograd."""
    gen = torch.Generator().manual_seed(40)
    x = torch.randn(2, 500, 128, generator=gen).to(cuda_device)
    params = gcfn_params(gen, 128, cuda_device)
    lens = torch.tensor([500, 313], device=cuda_device)
    w = torch.randn(2, 500, 128, generator=gen).to(cuda_device)
    before = fused_gcfn.launches
    got = grads_of(lambda x, *p: fused_gcfn(x, p, 1e-5, lens), [x] + params,
                   w)
    assert fused_gcfn.launches == before + 1
    ref = grads_of(lambda x, *p: gcfn_plain(x, p, 1e-5, lens), [x] + params,
                   w)
    assert_grads_match(got, ref, "fused_gcfn")

    b, h, lp, length = 2, 8, 512, 500
    scores = (torch.randn(b, h, lp, lp, generator=gen) * 3).to(cuda_device)
    bias = torch.randn(b, h, lp, lp, generator=gen).to(cuda_device)
    v = torch.randn(b, lp, 128, generator=gen).to(cuda_device)
    w = torch.randn(b, lp, 128, generator=gen).to(cuda_device)
    klens = torch.tensor([500, 313], device=cuda_device)
    for args, counter in (([scores, v], softmax_pv),
                          ([scores, v, bias], softmax_pv_bias)):
        before = counter.launches
        got = grads_of(lambda s, vv, *bb: softmax_pv(s, vv, klens, length,
                                                     *bb), args, w)
        assert counter.launches == before + 1
        ref = grads_of(lambda s, vv, *bb: softmax_pv_plain(s, vv, klens,
                                                           length, *bb),
                       args, w)
        assert_grads_match(got, ref, counter.__name__)


def gcfn_train_case(device, b, t, f, seed=10):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, f, generator=gen).to(device)
    dout = torch.randn(b, t, f, generator=gen).to(device)
    return x, gcfn_params(gen, f, device), dout


def assert_grads_close(got, ref):
    """dx and the nine parameter gradients: the parameter gradients sum
    B*T rows, float32 sums in another order than cuBLAS's."""
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * r.abs().max().item() + 1e-6)


@pytest.mark.cuda
# T=77 ends in a partial tile: the halo rows of K7 and K8 must take their
# masks and their zero padding from the global rows.  K8's row tile is 28
# rows: T 65 and 129 end one to nine rows into a tile, and B*T = 20 is
# under one tile, at both rates.  K7's is 62 rows: T 63 and 125 end one
# row into a tile, T 124 is a multiple of it
@pytest.mark.parametrize("b,t,p", [(3, 77, 0.05), (4, 8000, 0.05),
                                   (2, 200, 0.0), (2, 65, 0.0),
                                   (2, 65, 0.05), (3, 129, 0.0),
                                   (3, 129, 0.05), (1, 20, 0.0),
                                   (1, 20, 0.05), (2, 63, 0.0),
                                   (2, 63, 0.05), (2, 124, 0.0),
                                   (2, 124, 0.05), (2, 125, 0.0),
                                   (2, 125, 0.05)])
def test_gcfn_train_kernels_match_plain(cuda_device, b, t, p):
    x, params, dout = gcfn_train_case(cuda_device, b, t, 128)
    before = (gcfn_train_fwd.launches, gcfn_train_bwd.launches)
    out = gcfn_train_fwd(x, params, 1e-5, 4321, p)
    dx, dparams = gcfn_train_bwd(x, params, 1e-5, 4321, p, dout)
    torch.cuda.synchronize()
    assert (gcfn_train_fwd.launches, gcfn_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, gcfn_train_plain(x, params, 1e-5, 4321,
                                                     p), rtol=1e-4, atol=1e-4)
    ref_dx, ref_dparams = gcfn_train_bwd_plain(x, params, 1e-5, 4321, p,
                                               dout)
    assert_grads_close((dx, *dparams), (ref_dx, *ref_dparams))


@pytest.mark.cuda
def test_gcfn_forward_kernels_are_deterministic(cuda_device):
    x, params, _ = gcfn_train_case(cuda_device, 4, 2000, 128, seed=12)
    lens = torch.tensor([2000, 1500, 1001, 62], device=cuda_device)
    for run in (lambda: fused_gcfn(x, params, 1e-5, lens),
                lambda: gcfn_train_fwd(x, params, 1e-5, 7, 0.05)):
        first, again = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, again)  # no atomics: the same bits


@pytest.mark.cuda
def test_gcfn_train_backward_is_deterministic(cuda_device):
    x, params, dout = gcfn_train_case(cuda_device, 4, 2000, 128, seed=11)
    first = gcfn_train_bwd(x, params, 1e-5, 7, 0.05, dout)
    again = gcfn_train_bwd(x, params, 1e-5, 7, 0.05, dout)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0])
    for g, a in zip(first[1], again[1]):
        assert torch.equal(g, a)      # no atomics: the same bits every run


@pytest.mark.cuda
def test_fused_gcfn_train_gradient_on_the_card(cuda_device):
    """The autograd function hands each gradient back in its parameter's
    shape: the [6F, F] transposed view, the [6F, 1, 3] conv weight."""
    from sepreformer_torch.models.blocks import GCFN

    gcfn = GCFN(128).to(cuda_device)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for prm in gcfn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.2)
    x = torch.randn(2, 300, 128, generator=gen).to(cuda_device)
    params = (gcfn.net1[0].weight, gcfn.net1[0].bias,
              gcfn.net1[1].weight.t(), gcfn.net1[1].bias,
              gcfn.depthwise.weight.squeeze(1), gcfn.depthwise.bias,
              gcfn.net2[2].weight.t(), gcfn.net2[2].bias,
              gcfn.Layer_scale.layer_scale.reshape(-1))
    fused_gcfn_train(x, params, 1e-5, 99, 0.1).square().sum().backward()
    got = [prm.grad.clone() for prm in gcfn.parameters()]
    gcfn.zero_grad()
    gcfn_train_plain(x, params, 1e-5, 99, 0.1).square().sum().backward()
    for g, prm in zip(got, gcfn.parameters()):
        assert g.shape == prm.shape
        torch.testing.assert_close(g, prm.grad, rtol=1e-4,
                                   atol=1e-5 * prm.grad.abs().max().item())


@pytest.mark.cuda
def test_gcfn_train_kernels_refuse_other_widths(cuda_device):
    x, params, dout = gcfn_train_case(cuda_device, 2, 64, 16)
    with pytest.raises(ValueError, match="width 16"):
        gcfn_train_fwd(x, params, 1e-5, 1, 0.05)
    with pytest.raises(ValueError, match="width 16"):
        gcfn_train_bwd(x, params, 1e-5, 1, 0.05, dout)


@pytest.mark.cuda
# L 77: one partial query tile and key tile; L 300 with maxlen 64: tiles
# that straddle the clamp edge |i - j| = 64; L 8750, maxlen 2000: the
# decoder batch of a 70 s request, where most pairs clamp.  The tile
# classes of the tensor-core kernel: maxlen >= L (no tile clamps), a
# band that meets the clamp inside a tile (L 1000, maxlen 100), and key
# lengths of exactly 64 n and 64 n + 1 (a full last key tile, and a last
# tile of one key)
@pytest.mark.parametrize("b,length,maxlen,lens", [
    (3, 77, 64, (77, 30, 1)), (2, 300, 64, None), (2, 300, 64, (300, 131)),
    (2, 8750, 2000, (8750, 7000)), (2, 300, 512, (300, 200)),
    (2, 1000, 100, None), (2, 1000, 100, (1000, 517)),
    (3, 300, 64, (256, 257, 64)), (2, 129, 2000, (128, 129))])
def test_flash_kernel_matches_plain(cuda_device, b, length, maxlen, lens):
    h, d = 8, 16
    gen = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn(b, length, h * d, generator=gen).to(cuda_device)
               for _ in range(3))
    table = torch.randn(2 * maxlen, d, generator=gen).to(cuda_device)
    tl = None if lens is None else torch.tensor(lens, device=cuda_device)
    ref = flash_relpos_attention_plain(q, k, v, table, maxlen, tl)
    before = flash_relpos_attention.launches
    got = flash_relpos_attention(q, k, v, table, maxlen, tl)
    torch.cuda.synchronize()
    assert flash_relpos_attention.launches == before + 1
    torch.testing.assert_close(got, ref, **CARD_TOL)
    assert torch.equal(got, flash_relpos_attention(q, k, v, table, maxlen,
                                                   tl))


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_widths(cuda_device):
    """Head width 24 is built for no preset; the T/S/M head widths have no
    bfloat16 instance."""
    q = torch.randn(1, 100, 96, device=cuda_device)
    table = torch.randn(128, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_relpos_attention(q, q, q, table, 64)
    qb = q[..., :64].to(torch.bfloat16).contiguous()
    tb = table[:, :8].to(torch.bfloat16).contiguous()
    with pytest.raises(ValueError, match="queue B, bfloat16 streams"):
        flash_relpos_attention(qb, qb, qb, tb, 64)


@pytest.mark.cuda
def test_flash_kernel_gradient_matches_plain(cuda_device):
    """K12 under autograd: dq, dk, dv and the table's gradient recompute
    the plain version, as the JAX package's ``custom_vjp`` does."""
    gen = torch.Generator().manual_seed(41)
    length, maxlen = 2000, 500
    q, k, v, w = (torch.randn(1, length, 128, generator=gen).to(cuda_device)
                  for _ in range(4))
    table = torch.randn(2 * maxlen, 16, generator=gen).to(cuda_device)
    lens = torch.tensor([1700], device=cuda_device)
    before = flash_relpos_attention.launches
    got = grads_of(lambda *a: flash_relpos_attention(*a, maxlen, lens),
                   [q, k, v, table], w)
    assert flash_relpos_attention.launches == before + 1
    ref = grads_of(lambda *a: flash_relpos_attention_plain(*a, maxlen, lens),
                   [q, k, v, table], w)
    assert_grads_match(got, ref, "flash_relpos_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", DEPTHWISE_BWD_SHAPES)
def test_depthwise_bwd_w_kernel_matches_plain(cuda_device, b, t, c, k):
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(b, t, c, generator=gen).to(cuda_device)
    dy = torch.randn(b, t, c, generator=gen).to(cuda_device)
    ref = depthwise_bwd_w_plain(x, dy, k)
    before = depthwise_bwd_w.launches
    got = depthwise_bwd_w(x, dy, k)
    torch.cuda.synchronize()
    assert depthwise_bwd_w.launches == before + 1
    # dw and db sum B*T products: float32 sums in another order
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)
    again = depthwise_bwd_w(x, dy, k)
    for g, a in zip(got, again):
        assert torch.equal(g, a)      # no atomics: the same bits every run


def attention_train_case(b, h, length, maxlen, device, seed, d=16):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, length, d, generator=gen).to(device)
                     for _ in range(4))
    table = torch.randn(2 * maxlen, d, generator=gen).to(device)
    return q, k, v, table, dout


# L 77: one partial tile (hash row stride 128); L 300 with maxlen 64: tiles
# straddling the clamp edge, both end rows of the table gathering runs of
# offsets, and a row stride of 512 where K9's would be 384; L 500, maxlen
# 2000: the decoder batch of a B=2 x 4 s train batch; L 64, maxlen 2000:
# one whole tile, no offset clamped; L 129 with lengths 129 and 65: a
# third query tile of one row, and a last key tile of one key; L 512 at
# B*H 72: the longest length, and a grid past two blocks per SM (K13 at
# one warp per row tile; the others take 2 or 4); L 16 with a row of one
# valid key
@pytest.mark.cuda
@pytest.mark.parametrize("b,length,maxlen,lens,p", [
    (2, 77, 64, (77, 30), 0.0), (2, 77, 64, None, 0.1),
    (2, 300, 64, None, 0.1), (2, 300, 64, (300, 131), 0.0),
    (4, 500, 2000, None, 0.05), (1, 64, 2000, None, 0.05),
    (2, 129, 64, (129, 65), 0.1), (9, 512, 2000, None, 0.05),
    (2, 16, 64, (16, 1), 0.1)])
def test_attention_train_kernels_match_plain(cuda_device, b, length, maxlen,
                                             lens, p):
    check_attention_train_kernels(cuda_device, b, length, maxlen, lens, p,
                                  d=16)


def check_attention_train_kernels(cuda_device, b, length, maxlen, lens, p,
                                  d, split=0):
    """K13 (at ``split`` warps per row tile, 0: its rule's) and K14 at
    [b, 8, length, d] against their plain versions, K13's row statistics
    against float64, both bit-equal on a repeat call."""
    h, seed = 8, 4321
    q, k, v, table, dout = attention_train_case(b, h, length, maxlen,
                                                cuda_device, length, d)
    tl = None if lens is None else torch.tensor(lens, device=cuda_device)
    key_len = (torch.full((b,), length, dtype=torch.int32, device=cuda_device)
               if tl is None else tl.to(torch.int32))
    fwd, bwd = attention_train_fwd.launches, attention_train_bwd.launches
    out, row_max, row_sum = attention_train_fwd(q, k, v, table, maxlen, seed,
                                                p, key_len, split)
    grads = attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                out, dout, row_max, row_sum)
    torch.cuda.synchronize()
    assert (attention_train_fwd.launches, attention_train_bwd.launches) == (
        fwd + 1, bwd + 1)
    # a wrong dropout mask or hash row errs by O(1) at p > 0
    torch.testing.assert_close(
        out, attention_train_plain(q, k, v, table, maxlen, seed, p, tl),
        **CARD_TOL)
    # the row statistics K14 reads: the max of the scaled scores over the
    # valid keys, and the sum of exp(s - max) before the drop
    pos = torch.arange(length, device=cuda_device)
    rel = torch.clamp(pos[:, None] - pos[None], -maxlen, maxlen - 1) + maxlen
    s = (torch.einsum("bhid,bhjd->bhij", q.double(), k.double())
         + torch.einsum("bhid,ijd->bhij", q.double(), table.double()[rel]))
    s = s / d ** 0.5
    valid = pos[None] < key_len[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    mx = s.amax(-1)
    torch.testing.assert_close(row_max.double(), mx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(row_sum.double(),
                               torch.exp(s - mx[..., None]).sum(-1),
                               rtol=1e-5, atol=0)
    # no atomics, a fixed order of sums: the same bits every run
    again = attention_train_fwd(q, k, v, table, maxlen, seed, p, key_len,
                                split)
    for x, y in zip((out, row_max, row_sum), again):
        assert torch.equal(x, y)
    ref = attention_train_bwd_plain(q, k, v, table, maxlen, seed, p, tl, dout)
    for name, g, r in zip(("dq", "dk", "dv", "dtable"), grads, ref):
        # dtable sums B*H*L pairs per row in another order than cuBLAS's
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * r.abs().max().item() + 1e-6,
                                   msg=name)
    again = attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                out, dout, row_max, row_sum)
    for g, a in zip(grads, again):
        assert torch.equal(g, a)      # no atomics: the same bits every run


# test_attention_train_kernels_match_plain's cases at head width 32, and
# Large's train shapes: [2, 8, 500] (the encoder, K13 at split 4), [4, 8,
# 500] (the decoder, split 1) and the "single" serve's [8, 8, 500] with
# key lengths
@pytest.mark.cuda
@pytest.mark.parametrize("b,length,maxlen,lens,p", [
    (2, 77, 64, (77, 30), 0.0), (2, 77, 64, None, 0.1),
    (2, 300, 64, None, 0.1), (2, 300, 64, (300, 131), 0.0),
    (4, 500, 2000, None, 0.1), (2, 500, 2000, None, 0.1),
    (8, 500, 2000, (500, 438, 375, 313) * 2, 0.0), (1, 64, 2000, None, 0.1),
    (2, 129, 64, (129, 65), 0.1), (9, 512, 2000, None, 0.05),
    (2, 16, 64, (16, 1), 0.1)])
def test_attention_train_kernels_d32_match_plain(cuda_device, b, length,
                                                 maxlen, lens, p):
    check_attention_train_kernels(cuda_device, b, length, maxlen, lens, p,
                                  d=32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("b,lens", [(2, None), (3, (500, 300, 1))])
def test_attention_train_fwd_every_split_matches_plain(cuda_device, d, split,
                                                       b, lens):
    """K13 at each split, whatever the rule takes (D 32's SPLIT 4 runs
    one stage), against the plain version."""
    check_attention_train_kernels(cuda_device, b, 500, 2000, lens, 0.1, d,
                                  split)


@pytest.mark.cuda
def test_flash_relpos_attention_train_gradient_on_the_card(cuda_device):
    """The autograd function (K13, then K14) against the CPU's plain
    version and its autograd, the table's gradient included."""
    check_attention_train_gradient(cuda_device, 16)


@pytest.mark.cuda
def test_flash_relpos_attention_train_d32_gradient_on_the_card(cuda_device):
    check_attention_train_gradient(cuda_device, 32)


def check_attention_train_gradient(cuda_device, d):
    b, h, length, maxlen, p, seed = 2, 8, 300, 64, 0.1, 99
    cpu = attention_train_case(b, h, length, maxlen, "cpu", 5, d)

    def run(device):
        q, k, v, table = (a.to(device).requires_grad_() for a in cpu[:4])
        out = flash_relpos_attention_train(q, k, v, table, seed, maxlen, p)
        (out * cpu[4].to(device)).sum().backward()
        return [a.detach().cpu() for a in (out, q.grad, k.grad, v.grad,
                                           table.grad)]

    for name, g, r in zip(("out", "dq", "dk", "dv", "dtable"),
                          run(cuda_device), run("cpu")):
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * r.abs().max().item() + 1e-6,
                                   msg=name)


def cla_params(gen, f, k, device):
    """``cla_plain``'s params, wdw as the CLA module passes it: the Conv1d
    weight [F, 1, k] seen as [k, F]."""
    h = 2 * f
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((f, k), 0.1), ((f,), 0.1), ((f, h), 0.1), ((h,), 0.1),
                     ((h,), 0.1), ((h,), 0.1), ((h, f), 0.1), ((f,), 0.1),
                     ((f,), 0.5)]
    out = [(torch.randn(s, generator=gen) * sc).to(device)
           for s, sc in shapes_scales]
    out[8] = out[8] + 1.0               # bn_s near 1
    out[4] = out[4].t()                 # [k, F], Conv1d storage
    return out


def pair_params(gen, f, device):
    gate = [(torch.randn(s, generator=gen) * sc).to(device)
            for s, sc in (((f,), 1.0), ((f,), 1.0), ((f, f), 0.1),
                          ((f,), 0.1))]
    return gate, gcfn_params(gen, f, device)


@pytest.mark.cuda
# 8000 rows: many tiles; 77: one partial tile whose halo reaches both
# ends.  K15's tiles are 64 rows: T 65 ends one row into a second tile,
# T 128 on a tile edge, T 10 under one tile, and B*T is ragged in each
@pytest.mark.parametrize("b,t", [(4, 8000), (3, 77), (3, 65), (1, 128),
                                 (3, 10)])
def test_cla_kernel_matches_plain(cuda_device, b, t):
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(b, t, 128, generator=gen).to(cuda_device)
    params = cla_params(gen, 128, 65, cuda_device)
    ref = cla_plain(x, params, 1e-5)
    before = fused_cla.launches
    with torch.no_grad():
        got = fused_cla(x, params, 1e-5)
        again = fused_cla(x, params, 1e-5)
    torch.cuda.synchronize()
    assert fused_cla.launches == before + 2
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)    # no atomics: the same bits every run


@pytest.mark.cuda
# r = 16 over many tiles; r = 1 on one partial tile; K16's tile is 62
# rows: T 63 (r = 1) ends one row into a second tile, T 124 (r = 2) is
# two whole tiles, T 125 (r = 1) one row past them, and B*T = 10 (r = 2)
# is under one tile
@pytest.mark.parametrize("b,t,length", [(4, 8000, 500), (2, 77, 77),
                                        (2, 63, 63), (2, 124, 62),
                                        (3, 125, 125), (1, 10, 5)])
def test_pair_kernel_matches_plain(cuda_device, b, t, length):
    gen = torch.Generator().manual_seed(32)
    x = torch.randn(b, t, 128, generator=gen).to(cuda_device)
    xd = torch.randn(b, length, 128, generator=gen).to(cuda_device)
    gate, gcfn = pair_params(gen, 128, cuda_device)
    ref = ega_tail_gcfn_plain(x, xd, gate, gcfn, 1e-5)
    before = fused_ega_tail_gcfn.launches
    with torch.no_grad():
        got = fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5)
        again = fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5)
    torch.cuda.synchronize()
    assert fused_ega_tail_gcfn.launches == before + 2
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)    # no atomics: the same bits every run
    with pytest.raises(ValueError, match="not a multiple"):
        fused_ega_tail_gcfn(x[:, :-1].contiguous(), xd, gate, gcfn, 1e-5)


@pytest.mark.cuda
# K4's tiles (K5's geometry) are 130 rows at k 65, 168 at k 81, 24 at k 3:
# [2, 1000, 96] has three channel groups and ends inside a tile, T 100 is
# under one tile at k 65 and k 81, C 33 leaves one channel in its last
# group and takes 4-byte copies; ``offset`` 1 starts x one float past an
# aligned address, which takes the 4-byte copies at C 128
@pytest.mark.parametrize("b,t,c,k,offset", [(4, 8000, 128, 65, 0),
                                            (3, 77, 40, 9, 0),
                                            (2, 1000, 96, 65, 0),
                                            (2, 1000, 128, 3, 0),
                                            (2, 1000, 128, 81, 0),
                                            (2, 100, 128, 65, 0),
                                            (3, 100, 33, 81, 0),
                                            (2, 1000, 128, 65, 1)])
def test_depthwise_fwd_kernel_matches_plain(cuda_device, b, t, c, k,
                                            offset):
    gen = torch.Generator().manual_seed(33)
    flat = torch.randn(b * t * c + offset, generator=gen).to(cuda_device)
    x = flat[offset:].view(b, t, c)
    w = (torch.randn(c, 1, k, generator=gen) * 0.1).to(cuda_device)
    bias = torch.randn(c, generator=gen).to(cuda_device)
    before = depthwise_fwd.launches
    got = depthwise_fwd(x, w, bias)
    again = depthwise_fwd(x, w, bias)
    torch.cuda.synchronize()
    assert depthwise_fwd.launches == before + 2
    torch.testing.assert_close(got, depthwise_fwd_plain(x, w, bias),
                               **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_fused_block_gradients_on_the_card(cuda_device):
    """K15 and K16 under autograd: the forward launches the kernel, the
    backward recomputes the plain version; every gradient within 1e-4 of
    its largest value of the plain version's own."""
    gen = torch.Generator().manual_seed(34)
    b, t, length = 2, 1000, 125
    x = torch.randn(b, t, 128, generator=gen).to(cuda_device)
    xd = torch.randn(b, length, 128, generator=gen).to(cuda_device)
    w = torch.randn(b, t, 128, generator=gen).to(cuda_device)
    cla = cla_params(gen, 128, 65, cuda_device)
    gate, gcfn = pair_params(gen, 128, cuda_device)
    cases = (
        (fused_cla, cla_plain, [x], cla, "fused_cla"),
        (lambda x, xd, *p: fused_ega_tail_gcfn(x, xd, p[:4], p[4:], 1e-5),
         lambda x, xd, *p: ega_tail_gcfn_plain(x, xd, p[:4], p[4:], 1e-5),
         [x, xd], gate + gcfn, "fused_ega_tail_gcfn"))
    for fused, plain, args, params, name in cases:
        grads = []
        for fn in (fused, plain):
            leaves = [a.detach().clone().requires_grad_()
                      for a in args + params]
            if name == "fused_cla":
                out = fn(leaves[0], leaves[1:], 1e-5)
            else:
                out = fn(*leaves)
            (out * w).sum().backward()
            grads.append([a.grad for a in leaves])
        for g, r in zip(*grads):
            assert (g - r).abs().max() <= 1e-4 * r.abs().max(), name


# ---------------------------------------------------------------- Large
# The instances at Large's widths: K1 at F 256 (one block per SM), K3 and
# K12 at head width 32, K7/K8 at F 256, K9/K10 and K9b/K10b at head width
# 32, K15 and K16 at F 256, each against its plain version and bit-equal
# on a repeat call; and the Base instances of K1, K3, K7, K8, K9, K10,
# K12, K13, K14, K15 and K16 against the SHA-1 of their outputs on
# fixed-seed inputs, as the trees before the Large instances gave them on
# an H100 (``base_digests``).

@pytest.mark.cuda
# the shapes of test_gcfn_kernel_matches_plain, and Large's widest GCFN of
# a B=4 x 4 s batch
@pytest.mark.parametrize("b,t,masked", [(2, 500, True), (3, 77, False),
                                        (4, 8000, True), (2, 63, False),
                                        (2, 125, True), (1, 20, (13,)),
                                        (4, 200, (93, 62, 124, 63))])
def test_gcfn_kernel_f256_matches_plain(cuda_device, b, t, masked):
    gen = torch.Generator().manual_seed(t + 256)
    x = torch.randn(b, t, 256, generator=gen).to(cuda_device)
    params = gcfn_params(gen, 256, cuda_device)
    lens = None
    if masked is True:
        lens = torch.tensor([t, max(1, t // 3)] + [t] * (b - 2),
                            device=cuda_device)
    elif masked:
        lens = torch.tensor(masked, device=cuda_device)
    before = fused_gcfn.launches
    got = fused_gcfn(x, params, 1e-5, lens)
    again = fused_gcfn(x, params, 1e-5, lens)
    torch.cuda.synchronize()
    assert fused_gcfn.launches == before + 2
    torch.testing.assert_close(got, gcfn_plain(x, params, 1e-5, lens),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
# Base's K15 shapes at Large's width: many tiles, a partial tile whose
# halo reaches both ends, T one row into a second 64-row tile, T on a
# tile edge, T under one tile
@pytest.mark.parametrize("b,t", [(4, 8000), (3, 77), (3, 65), (1, 128),
                                 (3, 10)])
def test_cla_kernel_f256_matches_plain(cuda_device, b, t):
    gen = torch.Generator().manual_seed(t + 256)
    x = torch.randn(b, t, 256, generator=gen).to(cuda_device)
    params = cla_params(gen, 256, 65, cuda_device)
    before = fused_cla.launches
    with torch.no_grad():
        got = fused_cla(x, params, 1e-5)
        again = fused_cla(x, params, 1e-5)
    torch.cuda.synchronize()
    assert fused_cla.launches == before + 2
    torch.testing.assert_close(got, cla_plain(x, params, 1e-5), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
# Base's K16 shapes at Large's width (62-row tiles; r = 16, 1, 2)
@pytest.mark.parametrize("b,t,length", [(4, 8000, 500), (2, 77, 77),
                                        (2, 63, 63), (2, 124, 62),
                                        (3, 125, 125), (1, 10, 5)])
def test_pair_kernel_f256_matches_plain(cuda_device, b, t, length):
    gen = torch.Generator().manual_seed(t + length + 256)
    x = torch.randn(b, t, 256, generator=gen).to(cuda_device)
    xd = torch.randn(b, length, 256, generator=gen).to(cuda_device)
    gate, gcfn = pair_params(gen, 256, cuda_device)
    before = fused_ega_tail_gcfn.launches
    with torch.no_grad():
        got = fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5)
        again = fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5)
    torch.cuda.synchronize()
    assert fused_ega_tail_gcfn.launches == before + 2
    torch.testing.assert_close(
        got, ega_tail_gcfn_plain(x, xd, gate, gcfn, 1e-5), rtol=1e-4,
        atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_kernel_d32_matches_plain(cuda_device, b, h, lp, length,
                                             lens):
    scores, _, _, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                         lens, seed=32)
    gen = torch.Generator().manual_seed(lp)
    v = torch.randn(b, lp, h * 32, generator=gen).to(cuda_device)
    before = softmax_pv.launches
    got = softmax_pv(scores, v, lens, length)
    again = softmax_pv(scores, v, lens, length)
    torch.cuda.synchronize()
    assert softmax_pv.launches == before + 2
    torch.testing.assert_close(got, softmax_pv_plain(scores, v, lens, length),
                               **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_bias_kernel_d32_matches_plain(cuda_device, b, h, lp,
                                                  length, lens):
    """K3b at head width 32: the softmax of scores + bias, bit-equal on
    a repeat call."""
    scores, bias, _, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                            lens, seed=33)
    gen = torch.Generator().manual_seed(lp + 1)
    v = torch.randn(b, lp, h * 32, generator=gen).to(cuda_device)
    before = softmax_pv_bias.launches, softmax_pv.launches
    got = softmax_pv(scores, v, lens, length, bias=bias)
    again = softmax_pv(scores, v, lens, length, bias=bias)
    torch.cuda.synchronize()
    assert (softmax_pv_bias.launches, softmax_pv.launches) == (
        before[0] + 2, before[1])
    torch.testing.assert_close(
        got, softmax_pv_plain(scores, v, lens, length, bias), **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
# the cases of test_flash_kernel_matches_plain at head width 32
@pytest.mark.parametrize("b,length,maxlen,lens", [
    (3, 77, 64, (77, 30, 1)), (2, 300, 64, None), (2, 300, 64, (300, 131)),
    (2, 8750, 2000, (8750, 7000)), (2, 300, 512, (300, 200)),
    (2, 1000, 100, (1000, 517)), (3, 300, 64, (256, 257, 64)),
    (2, 129, 2000, (128, 129))])
def test_flash_kernel_d32_matches_plain(cuda_device, b, length, maxlen,
                                        lens):
    h, d = 8, 32
    gen = torch.Generator().manual_seed(length + d)
    q, k, v = (torch.randn(b, length, h * d, generator=gen).to(cuda_device)
               for _ in range(3))
    table = torch.randn(2 * maxlen, d, generator=gen).to(cuda_device)
    tl = None if lens is None else torch.tensor(lens, device=cuda_device)
    ref = flash_relpos_attention_plain(q, k, v, table, maxlen, tl)
    before = flash_relpos_attention.launches
    got = flash_relpos_attention(q, k, v, table, maxlen, tl)
    again = flash_relpos_attention(q, k, v, table, maxlen, tl)
    torch.cuda.synchronize()
    assert flash_relpos_attention.launches == before + 2
    torch.testing.assert_close(got, ref, **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
# K8's row tile is 28 rows and K7's 62: T 20 is under one tile, 65 and
# 129 end a few rows into one, 77 and 125 end in a partial tile of both;
# 8000 is Large's widest GCFN of a B=2 x 4 s train batch (B*spks = 4 rows
# at the decoder's first stage), p 0.1 its dropout
@pytest.mark.parametrize("b,t,p", [(1, 20, 0.0), (1, 20, 0.1), (2, 65, 0.1),
                                   (3, 77, 0.0), (3, 77, 0.1), (2, 125, 0.1),
                                   (3, 129, 0.0), (2, 8000, 0.1)])
def test_gcfn_train_kernels_f256_match_plain(cuda_device, b, t, p):
    x, params, dout = gcfn_train_case(cuda_device, b, t, 256, seed=t + 256)
    before = (gcfn_train_fwd.launches, gcfn_train_bwd.launches)
    out = gcfn_train_fwd(x, params, 1e-5, 4321, p)
    out_again = gcfn_train_fwd(x, params, 1e-5, 4321, p)
    dx, dparams = gcfn_train_bwd(x, params, 1e-5, 4321, p, dout)
    again = gcfn_train_bwd(x, params, 1e-5, 4321, p, dout)
    torch.cuda.synchronize()
    assert (gcfn_train_fwd.launches, gcfn_train_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    torch.testing.assert_close(out, gcfn_train_plain(x, params, 1e-5, 4321,
                                                     p), rtol=1e-4, atol=1e-4)
    ref_dx, ref_dparams = gcfn_train_bwd_plain(x, params, 1e-5, 4321, p,
                                               dout)
    assert_grads_close((dx, *dparams), (ref_dx, *ref_dparams))
    # no atomics: the same bits every run
    assert torch.equal(out, out_again)
    assert all(torch.equal(g, a) for g, a in zip((dx, *dparams),
                                                 (again[0], *again[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("lp,length,lens", K10_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_softmax_pv_train_kernels_d32_match_plain(cuda_device, p, ragged,
                                                  lp, length, lens, bias):
    """K9/K10 (K9b/K10b with ``bias``) at head width 32 on K10's shapes:
    against the plain versions, bit-equal on a repeat call."""
    gen = torch.Generator().manual_seed(lp + 32)
    scores, extra, v, dout, lens, key_len = softmax_pv_train_case(
        gen, cuda_device, lp, length, lens, ragged, bias, d=32)
    if bias:
        fwd = lambda: softmax_pv_train_fwd_bias(  # noqa: E731
            scores, extra, v, 1234, key_len, length, p)
        bwd = lambda o, r, s: softmax_pv_train_bwd_bias(  # noqa: E731
            scores, extra, v, o, dout, r, s, 1234, key_len, length, p)
    else:
        fwd = lambda: softmax_pv_train_fwd(  # noqa: E731
            scores, v, 1234, key_len, length, p)
        bwd = lambda o, r, s: softmax_pv_train_bwd(  # noqa: E731
            scores, v, o, dout, r, s, 1234, key_len, length, p)
    out, row_max, row_sum = fwd()
    fwd_again = fwd()
    ds, dv = bwd(out, row_max, row_sum)
    again = bwd(out, row_max, row_sum)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, softmax_pv_dropout_plain(scores, v, 1234, lens, length, p,
                                      extra), **CARD_TOL)
    ds_ref, dv_ref = softmax_pv_dropout_bwd_plain(scores, v, 1234, lens,
                                                  length, p, dout, extra)
    torch.testing.assert_close(ds, ds_ref, **CARD_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(ds, again[0]) and torch.equal(dv, again[1])
    assert all(torch.equal(a, b) for a, b in zip((out, row_max, row_sum),
                                                 fwd_again))


@pytest.mark.cuda
def test_large_train_kernels_gradient_on_the_card(cuda_device):
    """The autograd functions at Large's widths: a GCFN of F 256 (K7, K8)
    and softmax_pv_dropout at head width 32 (K9, K10; K9b, K10b with a
    bias), each gradient against the plain version's autograd."""
    from sepreformer_torch.models.blocks import GCFN

    gen = torch.Generator().manual_seed(256)
    gcfn = GCFN(256).to(cuda_device)
    with torch.no_grad():
        for prm in gcfn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.2)
    x = torch.randn(2, 300, 256, generator=gen).to(cuda_device)
    grads = []
    for fn in (fused_gcfn_train, gcfn_train_plain):
        gcfn.zero_grad()
        fn(x, gcfn.params(), 1e-5, 99, 0.1).square().sum().backward()
        grads.append([prm.grad.clone() for prm in gcfn.parameters()])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-5 * r.abs().max().item())
    b, h, lp, d, length = 2, 8, 128, 32, 100
    scores, extra = (torch.randn(b, h, lp, lp, generator=gen).to(cuda_device)
                     for _ in range(2))
    v = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    g = torch.randn(b, length, h * d, generator=gen).to(cuda_device)
    for bias in (None, extra):
        grads = []
        for fn in (softmax_pv_dropout, softmax_pv_dropout_plain):
            leaves = [a.clone().requires_grad_() for a in (scores, v)]
            kw = {} if bias is None else {"bias": bias}
            out = fn(leaves[0], leaves[1], 9, None, length, 0.1, **kw)
            (out[:, :length] * g).sum().backward()
            grads.append([a.grad for a in leaves])
        for got, ref in zip(*grads):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def base_digests(device):
    """SHA-1 of the outputs of the Base instances of K1, K3, K7, K8, K9,
    K10, K12, K13, K14, K15 and K16 on inputs drawn from fixed CPU
    seeds."""
    import hashlib

    def sha(t):
        torch.cuda.synchronize()
        return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()

    gen = torch.Generator().manual_seed(2024)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    x = randn(2, 500, 128)
    params = gcfn_params(gen, 128, device)
    scores, v = randn(4, 8, 512, 512, scale=3.0), randn(4, 512, 128)
    lens = torch.tensor([500, 438, 313, 1], device=device)
    full = torch.full((4,), 500, dtype=torch.int32, device=device)
    q, k, vv = randn(2, 2000, 128), randn(2, 2000, 128), randn(2, 2000, 128)
    table = randn(4000, 16)
    qh, kh, vh = randn(4, 8, 500, 16), randn(4, 8, 500, 16), randn(4, 8, 500,
                                                                  16)
    dout, dout_a = randn(2, 500, 128), randn(4, 512, 128)
    dout_h = randn(4, 8, 500, 16)
    # K15's and K16's inputs, drawn after the others so that their
    # digests stay as they were
    xc, xd = randn(2, 500, 128), randn(2, 125, 128)
    cla = cla_params(gen, 128, 65, device)
    gate, pair_gcfn = pair_params(gen, 128, device)
    flat = lambda ts: torch.cat([a.flatten() for a in ts])  # noqa: E731
    with torch.no_grad():
        stats = softmax_pv_train_fwd(scores, v, 1234, full, 500, 0.05)
        k13 = attention_train_fwd(qh, kh, vh, table, 2000, 4321, 0.05, full)
        dx, dparams = gcfn_train_bwd(x, params, 1e-5, 4321, 0.05, dout)
        return {
            "K1": sha(fused_gcfn(x, params, 1e-5,
                                 torch.tensor([500, 321], device=device))),
            "K3": sha(softmax_pv(scores, v, lens, 500)),
            "K9": sha(torch.cat([a.flatten() for a in softmax_pv_train_fwd(
                scores, v, 1234, full, 500, 0.05)])),
            "K12": sha(flash_relpos_attention(
                q, k, vv, table, 2000, torch.tensor([2000, 1500],
                                                    device=device))),
            "K13": sha(flat(k13)),
            "K14": sha(flat(attention_train_bwd(
                qh, kh, vh, table, 2000, 4321, 0.05, full, k13[0], dout_h,
                k13[1], k13[2]))),
            "K7": sha(gcfn_train_fwd(x, params, 1e-5, 4321, 0.05)),
            "K8": sha(flat((dx, *dparams))),
            "K10": sha(flat(softmax_pv_train_bwd(
                scores, v, stats[0], dout_a, stats[1], stats[2], 1234, full,
                500, 0.05))),
            "K15": sha(fused_cla(xc, cla, 1e-5)),
            "K16": sha(fused_ega_tail_gcfn(xc, xd, gate, pair_gcfn, 1e-5)),
        }


# base_digests on an H100 80GB HBM3 with the kernels of the trees before
# the Large instances: K1, K3, K9, K12 and K13 before the eval instances
# (5a5dd13), K7, K8 and K10 before the train instances (31c48ab), K14
# before its head-width-32 instance (f41302c), K15 and K16 before their
# F-256 instances (013b131)
BASE_DIGESTS = {
    "K1": "e21e7e336d1ac95e22863f016c23a600d9edfdd4",
    "K3": "db2d328a28c02de0b04b0d146050158f76028b30",
    "K9": "55387d40c5cd50b24d2add365b24df22fb73c6f5",
    "K12": "fbc42492ea022fe8e9647013609dcfaca0c51055",
    "K13": "4a44c20dcf55254a7bc1ec83ea067b410b15c16c",
    "K7": "c9f81e0a370934174fcac7aee4cec0395444de18",
    "K8": "adfea2ece94702516359d4301ab5c543d08b9208",
    "K10": "d28b1f1b3b6c13fb6dd463ab74e492ca6df827ca",
    "K14": "54260ebc9282ef1ca8cac7cd3997a227144c2cc7",
    "K15": "9e31874ecb4c5458e7cff36d2e57bccd7e9eb63e",
    "K16": "8c20ab8f336dee6d92afa077d125fed4c76f8bf8",
}


@pytest.mark.cuda
def test_base_instances_keep_their_bits(cuda_device):
    assert base_digests(cuda_device) == BASE_DIGESTS


# The bfloat16 instances of K1, K3 and K12 against their plain bfloat16
# versions on the card (chip_smoke.py's limits; PERF.md section 2): max
# |kernel - plain| <= 2 bf16 ulps of max|out|; each bit-equal on repeat,
# each counted as its bf16 instance and not as the float32 one.  Where
# the kernel and the plain version round the probabilities against the
# same max (K1, which has none; K3 and K12 on scores whose row max lies in
# the first key tile of each warp that walks the row), the mean is held
# to BF16_MEAN, and the plain version with the rounding steps left out
# (float32 operands throughout, the result rounded) must exceed it, so
# the limit sees them.  On other scores K3 and K12 round p against each
# key tile's running max, the plain versions against the row's, which
# moves the mean as far as leaving the rounding out does (up to 5.6e-5 on
# an H100): BF16_TILE_MEAN holds agreement only.
BF16 = torch.bfloat16
BF16_MAX = 2 * 2.0 ** -7
BF16_MEAN = 1e-5
BF16_TILE_MEAN = 6e-5


def bf16_errors(got, ref):
    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max()
    return (d.max() / scale).item(), (d.mean() / scale).item()


def assert_bf16_close(got, ref, limit=BF16_MEAN, control=None):
    assert got.dtype == ref.dtype == BF16
    err_max, err_mean = bf16_errors(got, ref)
    ctl_mean = None if control is None else bf16_errors(control, ref)[1]
    print(f"bf16: max {err_max:.3e}, mean {err_mean:.3e} (limit {limit:.0e})"
          f", without the rounding steps {ctl_mean}")
    assert err_max <= BF16_MAX, err_max
    assert err_mean <= limit, err_mean
    if control is not None:
        assert control.dtype == BF16
        assert ctl_mean > limit, ctl_mean


def max_in_first_tiles(scores, lens):
    """Each row's max over its valid keys copied to keys 0, 64, 128 and
    192, the first key tile of each warp that shares a row in K3."""
    lp = scores.shape[-1]
    valid = torch.arange(lp, device=scores.device)[None] < lens[:, None]
    row_max = scores.float().masked_fill(
        ~valid[:, None, None, :], float("-inf")).amax(dim=-1)
    out = scores.clone()
    for j in range(0, min(lp, 256), 64):
        out[..., j] = row_max.to(scores.dtype)
    return out


def max_at_key0(gen, b, length, h, d, maxlen, device):
    """bf16 q, k, v [B, L, H*d] and a table on which every query's largest
    score is at key 0: per head the keys are multiples lambda_j < 0.9 of
    one vector w (lambda_0 = 1), each query w plus noise, and the table
    one repeated row (the same bias on each of a query's keys)."""
    w = torch.randn(h, d, generator=gen)
    q = w + 0.3 * torch.randn(b, length, h, d, generator=gen)
    lam = torch.rand(b, length, generator=gen) * 1.9 - 1.0
    lam[:, 0] = 1.0
    k = lam[..., None, None] * w
    v = torch.randn(b, length, h, d, generator=gen)
    table = (0.5 * torch.randn(1, d, generator=gen)).expand(2 * maxlen, d)
    return [a.reshape(b, length, -1).to(device, BF16).contiguous()
            for a in (q, k, v)] + [table.to(device, BF16).contiguous()]


def check_bf16_launch(wrapper, instance, run):
    """``run()`` twice: one launch each of ``wrapper``'s ``instance`` and
    none of its float32 instance; the same bits both times."""
    f32, other = wrapper.launches, wrapper.instance_launches.get(instance, 0)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert wrapper.launches == f32
    assert wrapper.instance_launches[instance] == other + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("b,t,masked", [(2, 500, True), (3, 77, False),
                                        (4, 8000, True), (3, 124, True)])
def test_gcfn_bf16_kernel_matches_plain(cuda_device, f, b, t, masked):
    gen = torch.Generator().manual_seed(t + f)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device).to(BF16)
    params = gcfn_params(gen, f, cuda_device)
    lens = (torch.tensor([t, t - 63, 62, 1][:b], device=cuda_device)
            if masked else None)
    got = check_bf16_launch(fused_gcfn, "bf16",
                            lambda: fused_gcfn(x, params, 1e-5, lens))
    assert_bf16_close(got, gcfn_plain(x, params, 1e-5, lens), control=(
        gcfn_plain(x.float(), params, 1e-5, lens).to(BF16)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("scores_bf16,v_bf16", [(False, True), (True, True),
                                                (True, False)])
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_bf16_kernel_matches_plain(cuda_device, d, scores_bf16,
                                              v_bf16, b, h, lp, length, lens):
    scores, _, v, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                         lens, seed=3)
    if d == 32:
        v = torch.cat([v, v.flip(-1)], dim=-1)
    if scores_bf16:
        scores = scores.to(BF16)
    if v_bf16:
        v = v.to(BF16).contiguous()
    instance = {(False, True): "bf16", (True, True): "bf16 scores",
                (True, False): "bf16 scores f32 v"}[scores_bf16, v_bf16]
    got = check_bf16_launch(softmax_pv, instance,
                            lambda: softmax_pv(scores, v, lens, length))
    ref = softmax_pv_plain(scores, v, lens, length)
    if v_bf16:
        assert_bf16_close(got, ref, BF16_TILE_MEAN)
        first = max_in_first_tiles(scores, lens)
        got = check_bf16_launch(softmax_pv, instance,
                                lambda: softmax_pv(first, v, lens, length))
        assert_bf16_close(got, softmax_pv_plain(first, v, lens, length),
                          control=softmax_pv_plain(first.float(), v.float(),
                                                   lens, length).to(BF16))
    else:  # float32 out: float32's bar
        torch.testing.assert_close(got, ref, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("b,length,maxlen,lens", [
    (3, 77, 64, (77, 30, 1)), (2, 300, 64, (300, 131)),
    (2, 8750, 2000, (8750, 7000)), (2, 1000, 100, (1000, 517)),
    (2, 129, 2000, (128, 129))])
def test_flash_bf16_kernel_matches_plain(cuda_device, d, b, length, maxlen,
                                         lens):
    h = 8
    gen = torch.Generator().manual_seed(length + d)
    q, k, v = (torch.randn(b, length, h * d, generator=gen).to(cuda_device)
               .to(BF16) for _ in range(3))
    table = torch.randn(2 * maxlen, d, generator=gen).to(cuda_device).to(BF16)
    tl = torch.tensor(lens, device=cuda_device)
    got = check_bf16_launch(
        flash_relpos_attention, "bf16",
        lambda: flash_relpos_attention(q, k, v, table, maxlen, tl))
    assert_bf16_close(got, flash_relpos_attention_plain(
        q, k, v, table, maxlen, tl), BF16_TILE_MEAN)
    first = max_at_key0(gen, b, length, h, d, maxlen, cuda_device)
    got = check_bf16_launch(
        flash_relpos_attention, "bf16",
        lambda: flash_relpos_attention(*first, maxlen, tl))
    control = flash_relpos_attention_plain(*(a.float() for a in first),
                                           maxlen, tl)
    assert_bf16_close(got, flash_relpos_attention_plain(*first, maxlen, tl),
                      control=control.to(BF16))


@pytest.mark.cuda
def test_kernels_without_bf16_refuse_it_on_the_card(cuda_device):
    """K3b raises on a bf16 CUDA tensor, naming the ROADMAP item, and
    launches nothing (K13-K16 take bfloat16 since their instances came:
    ``test_*_bf16_kernel*_match_plain`` below)."""
    dev = cuda_device
    s = torch.zeros(1, 2, 128, 128, device=dev, dtype=BF16)
    before = softmax_pv_bias.launches
    with pytest.raises(ValueError, match="queue B, bfloat16 streams"):
        softmax_pv(s, torch.zeros(1, 128, 32, device=dev), bias=s)
    assert softmax_pv_bias.launches == before


# The bfloat16 instances of K13/K14 (the single-block attention), K15 (the
# fused CLA) and K16 (the EGA tail + GCFN) against their plain bfloat16
# versions, at the limits above: each kernel rounds at its plain
# version's points (K13 the normalised, dropped p, after a statistics
# pass), so BF16_MEAN holds and the plain version without its rounding
# steps must exceed it; each bit-equal on a repeat call, counted as its
# bf16 instance.  K13's out32 (the float32 P·V of the unrounded p) is held
# at F32_OUT_MAX against the float32 plain version on the same values.
# K14's gradients are sums of products of rounded operands (P·z, G),
# whose rounding can flip between two orders of summation: they are held
# at BF16_SUM_MEAN, with the control further from the plain version than
# the kernel (dv's control cannot exceed BF16_MEAN: P·z's rounding errors
# average out over the 500 query rows of each sum).  Readings on an H100
# (mean over max|out|): K13 3e-8 to 8e-8 at every split, K14's four 7e-8
# to 2.5e-7, K15 and K16 6e-8 to 5.6e-6; the controls 6.8e-5 and above
# but K14's dv with key lengths (1.8e-6, 2.4e-6).
def bf16_attention_case(b, h, length, maxlen, device, seed, d):
    q, k, v, table, dout = attention_train_case(b, h, length, maxlen,
                                                device, seed, d)
    return [a.to(BF16).contiguous() for a in (q, k, v, table, dout)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,p", [(16, 0.05), (32, 0.1)])
@pytest.mark.parametrize("lens", [None, (500, 438, 375, 1)])
@pytest.mark.parametrize("split", [0, 1, 2, 4])
def test_attention_train_bf16_kernels_match_plain(cuda_device, d, p, lens,
                                                  split):
    """K13's and K14's bfloat16 instances at [4, 8, 500, d] (PERF.md
    section 6's shapes), with and without key lengths, K13 at every
    split (0: its rule's)."""
    b, h, length, maxlen, seed = 4, 8, 500, 2000, 77
    q, k, v, table, dout = bf16_attention_case(b, h, length, maxlen,
                                               cuda_device, length + d, d)
    tl = None if lens is None else torch.tensor(lens, device=cuda_device)
    key_len = (torch.full((b,), length, dtype=torch.int32, device=cuda_device)
               if tl is None else tl.to(torch.int32))
    out, out32, row_max, row_sum = check_bf16_launches(
        [attention_train_fwd], "bf16",
        lambda: attention_train_fwd_bf16(q, k, v, table, maxlen, seed, p,
                                         key_len, split))
    f32 = [a.float() for a in (q, k, v, table)]
    assert_bf16_close(out, attention_train_plain(q, k, v, table, maxlen,
                                                 seed, p, tl),
                      control=attention_train_plain(*f32, maxlen, seed, p,
                                                    tl).to(BF16))
    assert_f32_close(out32, attention_train_plain(*f32, maxlen, seed, p, tl))
    if split:
        return
    grads = check_bf16_launches(
        [attention_train_bwd], "bf16",
        lambda: attention_train_bwd(q, k, v, table, maxlen, seed, p, key_len,
                                    out32, dout, row_max, row_sum))
    ref = attention_train_bwd_plain(q, k, v, table, maxlen, seed, p, tl,
                                    dout)
    ctl = attention_train_bwd_plain(*f32, maxlen, seed, p, tl, dout.float())
    for name, g, r, c in zip(("dq", "dk", "dv", "dtable"), grads, ref, ctl):
        print(name, end=": ")
        assert_bf16_close(g, r, BF16_SUM_MEAN)
        # the control is further from the plain version than the kernel
        assert bf16_errors(c.to(BF16), r)[1] > bf16_errors(g, r)[1], name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_flash_relpos_attention_train_bf16_route(cuda_device, d):
    """``flash_relpos_attention_train`` on bfloat16 tensors under autograd
    takes K13's and K14's bfloat16 instances: bfloat16 gradients equal to
    K14's on K13's outputs, and a "single"-style eval call (key lengths,
    p 0) launches K13's bfloat16 instance alone."""
    b, h, length, maxlen = 2, 8, 300, 64
    q, k, v, table, dout = bf16_attention_case(b, h, length, maxlen,
                                               cuda_device, 5, d)
    leaves = [a.clone().requires_grad_() for a in (q, k, v, table)]
    fwd = attention_train_fwd.instance_launches.get("bf16", 0)
    bwd = attention_train_bwd.instance_launches.get("bf16", 0)
    out = flash_relpos_attention_train(*leaves, 9, maxlen, 0.1)
    out.backward(dout)
    assert out.dtype == BF16
    assert all(a.grad.dtype == BF16 for a in leaves)
    assert attention_train_fwd.instance_launches["bf16"] == fwd + 1
    assert attention_train_bwd.instance_launches["bf16"] == bwd + 1
    key_len = torch.full((b,), length, dtype=torch.int32, device=cuda_device)
    o, o32, rmax, rsum = attention_train_fwd_bf16(q, k, v, table, maxlen, 9,
                                                  0.1, key_len)
    want = attention_train_bwd(q, k, v, table, maxlen, 9, 0.1, key_len, o32,
                               dout, rmax, rsum)
    for a, w in zip(leaves, want):
        assert torch.equal(a.grad, w)
    lens = torch.tensor([300, 17], device=cuda_device)
    with torch.no_grad():
        got = flash_relpos_attention_train(q, k, v, table, 0, maxlen, 0.0,
                                           lens)
    assert_bf16_close(got, attention_train_plain(q, k, v, table, maxlen, 0,
                                                 0.0, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("b,t", [(4, 8000), (3, 77), (3, 65), (1, 128)])
def test_cla_bf16_kernel_matches_plain(cuda_device, f, b, t):
    """K15's bfloat16 instances at Base's and Large's widths: [4, 8000, F]
    and the float32 tests' tile edges."""
    gen = torch.Generator().manual_seed(t + f)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device, BF16)
    params = cla_params(gen, f, 65, cuda_device)
    with torch.no_grad():
        got = check_bf16_launch(fused_cla, "bf16",
                                lambda: fused_cla(x, params, 1e-5))
    assert_bf16_close(got, cla_plain(x, params, 1e-5),
                      control=cla_plain(x.float(), params, 1e-5).to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("b,t,length", [(4, 8000, 500), (2, 77, 77),
                                        (2, 124, 62), (3, 125, 125)])
def test_pair_bf16_kernel_matches_plain(cuda_device, f, b, t, length):
    """K16's bfloat16 instances at Base's and Large's widths: [4, 8000, F]
    at r = 16 and the float32 tests' tile edges; under autograd a
    bfloat16 call raises, as the JAX package's VJP does."""
    gen = torch.Generator().manual_seed(t + length + f)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device, BF16)
    xd = torch.randn(b, length, f, generator=gen).to(cuda_device, BF16)
    gate, gcfn = pair_params(gen, f, cuda_device)
    with torch.no_grad():
        got = check_bf16_launch(
            fused_ega_tail_gcfn, "bf16",
            lambda: fused_ega_tail_gcfn(x, xd, gate, gcfn, 1e-5))
    assert_bf16_close(got, ega_tail_gcfn_plain(x, xd, gate, gcfn, 1e-5),
                      control=ega_tail_gcfn_plain(
                          x.float(), xd.float(), gate, gcfn, 1e-5).to(BF16))
    before = fused_ega_tail_gcfn.instance_launches["bf16"]
    with pytest.raises(NotImplementedError, match="no bfloat16 gradient"):
        fused_ega_tail_gcfn(x.clone().requires_grad_(), xd, gate, gcfn, 1e-5)
    assert fused_ega_tail_gcfn.instance_launches["bf16"] == before


# The bfloat16 instances of K7/K8 and K9/K10 (training) against their
# plain bfloat16 versions, at the limits above.  K7 and K8 round at the
# same points as their plain versions; so does K10, whose P comes from
# K9's final row statistics, and whose rowsum(dP * P) is dOut . out32
# (K9's float32 output of the unrounded weights).  K9 rounds its weights
# against each key tile's running max, as K3 does: BF16_MEAN holds on the
# scores of ``max_in_first_tiles``, K9_TILE_MEAN elsewhere.  Float32
# outputs of float32 operands (K10's dS, K9 and K10 with a float32 V) are
# held at max <= 1e-4 of max|out|.  K8's nine parameter gradients are
# float32 sums over the rows of products of rounded operands: where du's
# float32 value differs in its last bits between the kernel's order of
# summation and the plain version's, its bfloat16 rounding can flip by an
# ulp (2^-8 of it), and the short sums (the LayerNorm's, ls's) carry that
# into their mean: up to 2.8e-5 of max|grad| on an H100, where the
# unrounded control reads 1e-4 and more.  They are held at BF16_MAX and
# BF16_SUM_MEAN, and the control must exceed it on the two products'
# gradients.
F32_OUT_MAX = 1e-4
BF16_SUM_MEAN = 5e-5
# K9 rounds e / (1 - p) against each key tile's running max: up to 7.3e-5
# of max|out| on other scores (agreement only; chip_smoke.py's
# K9_TILE_MEAN)
K9_TILE_MEAN = 1e-4


def assert_f32_close(got, ref, max_limit=F32_OUT_MAX, mean_limit=None):
    assert got.dtype == ref.dtype == torch.float32
    err_max, err_mean = bf16_errors(got, ref)
    assert err_max <= max_limit, (err_max, err_mean)
    assert mean_limit is None or err_mean <= mean_limit, (err_max, err_mean)


def check_bf16_launches(wrappers, instance, run):
    """``run()`` twice: one launch each of each wrapper's ``instance`` a
    run and none of their float32 instances; the same bits both times."""
    before = [(w.launches, w.instance_launches.get(instance, 0))
              for w in wrappers]
    got, again = run(), run()
    torch.cuda.synchronize()
    for w, (f32, other) in zip(wrappers, before):
        assert w.launches == f32
        assert w.instance_launches[instance] == other + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("b,t,p", [(2, 500, 0.1), (3, 77, 0.0),
                                   (2, 2000, 0.05), (1, 29, 0.1)])
def test_gcfn_train_bf16_kernels_match_plain(cuda_device, f, b, t, p):
    gen = torch.Generator().manual_seed(t + f)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device).to(BF16)
    dout = torch.randn(b, t, f, generator=gen).to(cuda_device).to(BF16)
    params = gcfn_params(gen, f, cuda_device)
    (got,) = check_bf16_launches(
        [gcfn_train_fwd], "bf16",
        lambda: (gcfn_train_fwd(x, params, 1e-5, 99, p),))
    assert_bf16_close(got, gcfn_train_plain(x, params, 1e-5, 99, p),
                      control=gcfn_train_plain(x.float(), params, 1e-5, 99,
                                               p).to(BF16))
    dx, *dparams = check_bf16_launches(
        [gcfn_train_bwd], "bf16",
        lambda: (lambda r: (r[0], *r[1]))(
            gcfn_train_bwd(x, params, 1e-5, 99, p, dout)))
    ref_dx, ref_dp = gcfn_train_bwd_plain(x, params, 1e-5, 99, p, dout)
    ctl_dx, ctl_dp = gcfn_train_bwd_plain(x.float(), params, 1e-5, 99, p,
                                          dout.float())
    assert_bf16_close(dx, ref_dx, control=ctl_dx.to(BF16))
    for g, r in zip(dparams, ref_dp):
        assert_f32_close(g, r, BF16_MAX, BF16_SUM_MEAN)
    for i in (2, 6):  # d win, d wout
        assert bf16_errors(ctl_dp[i], ref_dp[i])[1] > BF16_SUM_MEAN


TRAIN_PV_SHAPES = [(3, 4, 512, 500, None), (3, 4, 128, 77, None),
                   (3, 4, 77, 77, (1, 77, 40)), (2, 4, 136, 130, (65, 1)),
                   (3, 4, 17, 17, (17, 9, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("scores_bf16,v_bf16", [(False, True), (True, True),
                                                (True, False)])
@pytest.mark.parametrize("b,h,lp,length,lens", TRAIN_PV_SHAPES)
def test_softmax_pv_train_bf16_kernels_match_plain(
        cuda_device, d, scores_bf16, v_bf16, b, h, lp, length, lens):
    scores, _, v, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                         lens, seed=7)
    if d == 32:
        v = torch.cat([v, v.flip(-1)], dim=-1)
    gen = torch.Generator().manual_seed(lp + d)
    dout = torch.randn(v.shape, generator=gen).to(cuda_device)
    key_len = lens.to(torch.int32).contiguous()
    if v_bf16:
        v, dout = v.to(BF16).contiguous(), dout.to(BF16)
    instance = {(False, True): "bf16", (True, True): "bf16 scores",
                (True, False): "bf16 scores f32 v"}[scores_bf16, v_bf16]
    for first in (False, True):
        s = max_in_first_tiles(scores, lens) if first else scores
        s = s.to(BF16) if scores_bf16 else s
        out, out32, rmax, rsum = check_bf16_launches(
            [softmax_pv_train_fwd], instance,
            lambda: softmax_pv_train_fwd_bf16(s, v, 31, key_len, length,
                                              0.1))
        ref = softmax_pv_dropout_plain(s, v, 31, lens, length, 0.1)
        rows = slice(0, length)
        if v_bf16:
            control = softmax_pv_dropout_plain(s.float(), v.float(), 31, lens,
                                               length, 0.1).to(BF16)
            assert_bf16_close(out[:, rows], ref[:, rows],
                              BF16_MEAN if first else K9_TILE_MEAN,
                              control[:, rows] if first else None)
        else:
            assert_f32_close(out[:, rows], ref[:, rows])
        ds, dv = check_bf16_launches(
            [softmax_pv_train_bwd], instance,
            lambda: softmax_pv_train_bwd_bf16(s, v, out32, dout, rmax, rsum,
                                              31, key_len, length, 0.1))
        ref_ds, ref_dv = softmax_pv_dropout_bwd_plain(s, v, 31, lens, length,
                                                      0.1, dout)
        keep = torch.arange(lp, device=cuda_device) < length
        for got, want in ((ds[:, :, keep], ref_ds[:, :, keep]), (dv, ref_dv)):
            if got.dtype == BF16:
                assert_bf16_close(got, want)
            else:
                assert_f32_close(got, want)


@pytest.mark.cuda
def test_softmax_pv_dropout_bf16_route(cuda_device):
    """``softmax_pv_dropout`` takes K9's and K10's bfloat16 instances
    under autograd for each pairing, and its gradients are K10's."""
    scores, _, v, lens = softmax_pv_case(cuda_device, 2, 8, 512, 500,
                                         (500, 311), seed=9)
    for sdt, vdt in ((torch.float32, BF16), (BF16, BF16),
                     (BF16, torch.float32)):
        s = scores.to(sdt).clone().requires_grad_()
        vv = v.to(vdt).clone().requires_grad_()
        out = softmax_pv_dropout(s, vv, 5, lens, 500, 0.1)
        assert out.dtype == vdt
        out.float().square().sum().backward()
        assert s.grad.dtype == sdt and vv.grad.dtype == vdt
        assert torch.isfinite(s.grad.float()).all()


# The instances at the T, S and M presets' widths (F 64, 96, 160; head
# widths 8, 12, 20; float32), on the shapes of the Base and Large tests:
# each against its plain version within the limits those instances meet,
# bit-equal on a repeat call, counted as the wrapper's float32 launches.
TSM_WIDTHS = [(64, 8), (96, 12), (160, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64, 96, 160])
@pytest.mark.parametrize("b,t,masked", [(2, 500, True), (3, 77, False),
                                        (4, 8000, True), (2, 63, False),
                                        (2, 125, True), (1, 20, (13,)),
                                        (4, 200, (93, 62, 124, 63))])
def test_gcfn_kernel_tsm_matches_plain(cuda_device, f, b, t, masked):
    gen = torch.Generator().manual_seed(t + f)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device)
    params = gcfn_params(gen, f, cuda_device)
    lens = None
    if masked is True:
        lens = torch.tensor([t, max(1, t // 3)] + [t] * (b - 2),
                            device=cuda_device)
    elif masked:
        lens = torch.tensor(masked, device=cuda_device)
    before = fused_gcfn.launches
    got = fused_gcfn(x, params, 1e-5, lens)
    again = fused_gcfn(x, params, 1e-5, lens)
    torch.cuda.synchronize()
    assert fused_gcfn.launches == before + 2
    torch.testing.assert_close(got, gcfn_plain(x, params, 1e-5, lens),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 20])
@pytest.mark.parametrize("b,h,lp,length,lens", SOFTMAX_PV_SHAPES)
def test_softmax_pv_kernel_tsm_matches_plain(cuda_device, d, b, h, lp,
                                             length, lens):
    """K3 at the T/S/M head widths: V's rows staged as D / 4 16-byte
    pieces, the products at 8 ceil(D / 8)."""
    scores, _, _, lens = softmax_pv_case(cuda_device, b, h, lp, length,
                                         lens, seed=d)
    gen = torch.Generator().manual_seed(lp + d)
    v = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    before = softmax_pv.launches
    got = softmax_pv(scores, v, lens, length)
    again = softmax_pv(scores, v, lens, length)
    torch.cuda.synchronize()
    assert softmax_pv.launches == before + 2
    torch.testing.assert_close(got, softmax_pv_plain(scores, v, lens, length),
                               **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 20])
# the cases of test_flash_kernel_d32_matches_plain
@pytest.mark.parametrize("b,length,maxlen,lens", [
    (3, 77, 64, (77, 30, 1)), (2, 300, 64, None), (2, 300, 64, (300, 131)),
    (2, 8750, 2000, (8750, 7000)), (2, 300, 512, (300, 200)),
    (2, 1000, 100, (1000, 517)), (3, 300, 64, (256, 257, 64)),
    (2, 129, 2000, (128, 129))])
def test_flash_kernel_tsm_matches_plain(cuda_device, d, b, length, maxlen,
                                        lens):
    """K12 at the T/S/M head widths: QKᵀ and Q·bandᵀ over k = 8 ceil(D /
    8) with the staged rows' pad columns zero."""
    h = 8
    gen = torch.Generator().manual_seed(length + d)
    q, k, v = (torch.randn(b, length, h * d, generator=gen).to(cuda_device)
               for _ in range(3))
    table = torch.randn(2 * maxlen, d, generator=gen).to(cuda_device)
    tl = None if lens is None else torch.tensor(lens, device=cuda_device)
    ref = flash_relpos_attention_plain(q, k, v, table, maxlen, tl)
    before = flash_relpos_attention.launches
    got = flash_relpos_attention(q, k, v, table, maxlen, tl)
    again = flash_relpos_attention(q, k, v, table, maxlen, tl)
    torch.cuda.synchronize()
    assert flash_relpos_attention.launches == before + 2
    torch.testing.assert_close(got, ref, **CARD_TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("f,d", TSM_WIDTHS)
def test_tsm_widths_refuse_bfloat16_on_the_card(cuda_device, f, d):
    """No bfloat16 instance of K1, K3 or K12 at the T/S/M widths: each
    refuses a bfloat16 stream before it launches."""
    gen = torch.Generator().manual_seed(f)
    x = torch.randn(1, 64, f, generator=gen).to(cuda_device, BF16)
    params = gcfn_params(gen, f, cuda_device)
    scores = torch.randn(1, 8, 128, 128, device=cuda_device)
    v = torch.randn(1, 128, f, device=cuda_device).to(BF16)
    table = torch.randn(128, d, device=cuda_device).to(BF16)
    before = (fused_gcfn.launches, softmax_pv.launches,
              flash_relpos_attention.launches)
    for call in (lambda: fused_gcfn(x, params, 1e-5),
                 lambda: softmax_pv(scores, v, None, 100),
                 lambda: flash_relpos_attention(x, x, x, table, 64)):
        with pytest.raises(ValueError, match="queue B, bfloat16 streams"):
            call()
    assert (fused_gcfn.launches, softmax_pv.launches,
            flash_relpos_attention.launches) == before
