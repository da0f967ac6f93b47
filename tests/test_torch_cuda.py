"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  This file imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card.
"""

import numpy as np
import pytest
import torch

from sepreformer_torch.ops.kernels import (
    fused_gcfn,
    gcfn_plain,
    materialize_pos_kt,
    materialize_pos_kt_plain,
    softmax_pv,
    softmax_pv_plain,
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
