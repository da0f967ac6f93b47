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
    fused_gcfn,
    gcfn_plain,
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
