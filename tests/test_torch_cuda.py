"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card.
"""

import numpy as np
import pytest
import torch

from sepreformer_torch.ops.kernels import (
    depthwise_bwd,
    depthwise_bwd_plain,
    flash_relpos_attention,
    flash_relpos_attention_plain,
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
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
    softmax_pv_plain,
    softmax_pv_train_bwd,
    softmax_pv_train_fwd,
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
@pytest.mark.parametrize("b,t,f,masked", [(2, 500, 128, True),
                                          (3, 77, 128, False),
                                          (4, 8000, 128, True)])
def test_gcfn_kernel_matches_plain(cuda_device, b, t, f, masked):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b, t, f, generator=gen).to(cuda_device)
    params = gcfn_params(gen, f, cuda_device)
    lens = None
    if masked:
        lens = torch.tensor([t, max(1, t // 3)] + [t] * (b - 2),
                            device=cuda_device)
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


@pytest.mark.cuda
# lp=2048 takes several key chunks: the online softmax across chunks
@pytest.mark.parametrize("d,lp,length", [(16, 512, 500), (16, 2048, 1900),
                                         (16, 128, 77)])
def test_softmax_pv_kernel_matches_plain(cuda_device, d, lp, length):
    b, h = 3, 4
    scores = torch.randn(b, h, lp, lp, device=cuda_device) * 3
    v = torch.randn(b, lp, h * d, device=cuda_device)
    lens = torch.tensor([length, length // 2, 1], device=cuda_device)
    got = softmax_pv(scores, v, lens, length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, softmax_pv_plain(scores, v, lens, length),
                               **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,k", [(4, 8000, 128, 65), (2, 500, 128, 65),
                                     (3, 77, 40, 9)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.05])
@pytest.mark.parametrize("ragged", [False, True])
def test_softmax_pv_train_kernels_match_plain(cuda_device, p, ragged):
    b, h, lp, d, length = 4, 8, 512, 16, 500
    gen = torch.Generator().manual_seed(7)
    scores = (torch.randn(b, h, lp, lp, generator=gen) * 3).to(cuda_device)
    v = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    dout = torch.randn(b, lp, h * d, generator=gen).to(cuda_device)
    lens = (torch.tensor([500, 313, 438, 1], device=cuda_device) if ragged
            else None)
    key_len = (torch.full((b,), length, dtype=torch.int32, device=cuda_device)
               if lens is None else lens.to(torch.int32))
    out, row_max, row_sum = softmax_pv_train_fwd(scores, v, 1234, key_len,
                                                 length, p)
    ds, dv = softmax_pv_train_bwd(scores, v, out, dout, row_max, row_sum,
                                  1234, key_len, length, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, softmax_pv_dropout_plain(scores, v, 1234, lens, length, p),
        **CARD_TOL)
    ds_ref, dv_ref = softmax_pv_dropout_bwd_plain(scores, v, 1234, lens,
                                                  length, p, dout)
    torch.testing.assert_close(ds, ds_ref, **CARD_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
def test_pit_kernel_and_gradient_match_plain(cuda_device):
    gen = torch.Generator().manual_seed(9)
    src = (torch.randn(2, 2, 32000, generator=gen) * 0.1).to(cuda_device)
    est = src.flip(0) + 0.02 * torch.randn(2, 2, 32000,
                                           generator=gen).to(cuda_device)
    results = []
    for fn in (sisnr_pairwise_neg_fused, sisnr_pairwise_neg):
        e = est.clone().requires_grad_()
        table = fn(e, src)
        table.sum().backward()
        results.append((table.detach(), e.grad))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-4,
                               atol=1e-6)


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
    """K1, K2 and K3 have no backward: under autograd they raise instead of
    returning a result with no gradient."""
    table = torch.randn(40, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        materialize_pos_kt(table, 32, 20)
    scores = torch.randn(1, 8, 128, 128, device=cuda_device,
                         requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        softmax_pv(scores, torch.randn(1, 128, 128, device=cuda_device))
    with torch.no_grad():
        materialize_pos_kt(table, 32, 20)


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
# T=77 ends in a partial tile of 16 rows: the halo rows of K8 must take
# their masks and their zero padding from the global rows
@pytest.mark.parametrize("b,t,p", [(3, 77, 0.05), (4, 8000, 0.05),
                                   (2, 200, 0.0)])
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
# decoder batch of a 70 s request, where most pairs clamp
@pytest.mark.parametrize("b,length,maxlen,lens", [
    (3, 77, 64, (77, 30, 1)), (2, 300, 64, None), (2, 300, 64, (300, 131)),
    (2, 8750, 2000, (8750, 7000))])
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
def test_flash_kernel_refuses_autograd_and_other_head_widths(cuda_device):
    q = torch.randn(1, 100, 128, device=cuda_device, requires_grad=True)
    table = torch.randn(128, 16, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_relpos_attention(q, q, q, table, 64)
    with torch.no_grad():
        flash_relpos_attention(q, q, q, table, 64)
        with pytest.raises(ValueError, match="head dim 8"):
            flash_relpos_attention(q, q, q, table[:, :8], 64)
