"""K15, the fused CLA, on the CPU: the port's plain version against the
JAX package's reference and its Pallas kernel in interpret mode, the
autograd function's gradients against ``jax.grad`` of the JAX wrapper,
the route condition's ``pick_block``, ``BatchNorm.folded`` against
``FoldableBatchNorm``, and the port's CLA module on the fused route
against its unfused chain.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.models.blocks import FoldableBatchNorm
from sepreformer_tpu.ops.pallas import cla as jcla
from sepreformer_torch.models.blocks import CLA, BatchNorm, TrainMode
from sepreformer_torch.ops.kernels import cla as tcla
from sepreformer_torch.ops.kernels.gcfn import pick_block

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as in test_torch_engine.py: beside the
    other test workers torch's own pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_params(rng, f, k):
    """(lns, lnb, w_in, b_in, wdw [k, F], bdw, w_mid, b_mid, bn_s, bn_t,
    w_out, b_out, ls) as float32 numpy, as tests/test_pallas_cla.py."""
    h = 2 * f
    return [rng.normal(size=(f,)), rng.normal(size=(f,)),
            rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(k, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
            rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
            1.0 + 0.1 * rng.normal(size=(h,)), rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(h, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
            rng.normal(size=(f,)) * 0.01]


def as32(arrays):
    return [np.asarray(a, np.float32) for a in arrays]


# the JAX package's kernel tests' shapes: multi-block cases cross the
# halo at block edges, every case reaches both sequence ends; Large's
# F = 256 in one block and in five (t 640: blocks of 128)
@pytest.mark.parametrize("b,t,f,k", [(2, 256, 128, 65), (1, 500, 128, 65),
                                     (2, 768, 64, 65), (1, 1024, 64, 65),
                                     (1, 320, 64, 5), (1, 200, 256, 65),
                                     (1, 640, 256, 65)])
def test_cla_plain_matches_jax(b, t, f, k):
    rng = np.random.default_rng(t + k)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    params = as32(make_params(rng, f, k))
    ref = jcla.cla_reference(jnp.asarray(x), [jnp.asarray(p) for p in params],
                             1e-5)
    kernel = jcla._fused_cla_impl(jnp.asarray(x),
                                  tuple(jnp.asarray(p) for p in params),
                                  1e-5, interpret=True)
    got = tcla.cla_plain(torch.from_numpy(x),
                         [torch.from_numpy(p) for p in params], 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)


def test_pick_block_matches_jax():
    for t in range(1, 4200):
        assert pick_block(t) == jcla.pick_block(t, 128), t


def test_fused_cla_gradients_match_jax():
    """x and all thirteen parameters: the recompute VJP of ``fused_cla``
    against ``jax.grad`` of the JAX wrapper (its kernel in interpret
    mode)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 256, 64)).astype(np.float32)
    params = as32(make_params(rng, 64, 65))

    def loss(x, p):
        return jnp.sum(jcla.fused_cla(x, p, 1e-5, True) ** 2)

    gx, gp = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), tuple(jnp.asarray(p) for p in params))
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in params]
    (tcla.fused_cla(xt, pt, 1e-5) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for name, a, ref in zip(tcla.PARAM_NAMES, pt, gp):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)


def test_batchnorm_folded_matches_jax():
    rng = np.random.default_rng(4)
    scale, bias, mean = (rng.normal(size=(32,)).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=(32,)).astype(np.float32)
    bn = FoldableBatchNorm(32, momentum=0.9, epsilon=1e-5)
    s_ref, t_ref = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, return_folded=True)
    port = BatchNorm(32, eps=1e-5)
    with torch.no_grad():
        for name, a in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(a))
    s, t = port.folded()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(t_ref),
                               rtol=1e-6, atol=1e-6)
    # γ and β get gradients through the fold
    (s.sum() + t.sum()).backward()
    assert port.weight.grad is not None and port.bias.grad is not None


def seeded_cla(f, k, fused, seed=5):
    gen = torch.Generator().manual_seed(seed)
    cla = CLA(f, k, fused=fused)
    with torch.no_grad():
        for p in cla.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        cla.BN.running_mean.copy_(torch.randn(2 * f, generator=gen) * 0.1)
        cla.BN.running_var.uniform_(0.5, 2.0, generator=gen)
        cla.Layer_scale.layer_scale.fill_(0.5)
    return cla.eval()


@pytest.mark.parametrize("t", [256, 1009])
def test_cla_module_fused_route(monkeypatch, t):
    """Eval without lengths at a length whose ``pick_block`` > 0 calls K15
    once and agrees with the unfused chain; at 1009 (no block) and with
    ``seq_lens`` or in train mode the unfused chain runs."""
    from sepreformer_torch.models import blocks

    calls = []
    real = blocks.fused_cla
    monkeypatch.setattr(blocks, "fused_cla",
                        lambda *a: calls.append(1) or real(*a))
    fused, plain = seeded_cla(16, 9, "on"), seeded_cla(16, 9, "off")
    for lin in (fused.linear1, fused.linear2, fused.linear3[1]):
        assert lin.weight.t().is_contiguous()
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(2, t, 16)).astype(np.float32))
    with torch.no_grad():
        got, ref = fused(x), plain(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert len(calls) == (1 if t == 256 else 0)
    with torch.no_grad():
        fused(x, seq_lens=torch.tensor([t, t // 2]))
        fused(x, train=TrainMode(0.0, torch.Generator(), torch.Generator()))
    assert len(calls) == (1 if t == 256 else 0)


def test_fused_cla_checks_before_launch():
    """The kernel path raises on what the CUDA kernel does not take (a
    width other than 128, a kernel other than 65) before it reaches the
    device checks; the CPU wrapper takes the plain version and launches
    nothing."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 40, 64)).astype(np.float32))
    params = [torch.from_numpy(p) for p in as32(make_params(rng, 64, 65))]
    with pytest.raises(ValueError, match="width 64"):
        tcla.cla_kernel(x, params, 1e-5)
    x128 = torch.zeros(1, 40, 128)
    params5 = [torch.from_numpy(p) for p in as32(make_params(rng, 128, 5))]
    with pytest.raises(ValueError, match="kernel 5"):
        tcla.cla_kernel(x128, params5, 1e-5)
    before = tcla.fused_cla.launches
    got = tcla.fused_cla(x, params, 1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  tcla.cla_plain(x, params, 1e-5).numpy())
    assert tcla.fused_cla.launches == before
