"""K7 and K8 (the GCFN with hash dropout for training) and the dense train
attention past a padded length of 512, against the JAX package on the CPU.

The plain forward is held against ``gcfn_train_reference``, its autograd
against ``jax.vjp`` of that reference, and one case against the JAX
package's Pallas kernels in interpret mode.  The CUDA kernels against
their plain versions are in ``test_torch_cuda.py``.  Inputs are
numpy-seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.models import blocks as jb
from sepreformer_tpu.ops.pallas.gcfn_train import (
    fused_gcfn_train as jax_fused_gcfn_train,
)
from sepreformer_tpu.ops.pallas.gcfn_train import gcfn_train_reference
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import convert
from sepreformer_torch.ops.kernels import (
    fused_gcfn_train,
    gcfn_train_bwd_plain,
    gcfn_train_plain,
    materialize_pos_kt,
)
from test_torch_modules import _jax_relpos, boost_layer_scale, load_port

NAMES = ("lns", "lnb", "win", "bin", "wdw", "bdw", "wout", "bout", "ls")


def jax_case(b=2, t=64, f=16, seed=0):
    """x, dout and the JAX reference's parameters (wdw [3, 6F])."""
    rng = np.random.default_rng(seed)
    h = 6 * f
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    dout = rng.normal(size=(b, t, f)).astype(np.float32)
    shapes = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
              ((3, h), 0.3), ((h,), 0.1), ((h // 2, f), 0.1), ((f,), 0.1),
              ((f,), 0.5)]
    params = [(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in shapes]
    return x, dout, params


def port_params(params):
    """The port's layout: the k3 weight [6F, 3]."""
    out = [torch.from_numpy(a) for a in params]
    out[4] = out[4].t().contiguous()
    return out


def jax_ref(x, params, seed, p):
    return gcfn_train_reference(jnp.asarray(x),
                                [jnp.asarray(a) for a in params], 1e-5,
                                jnp.int32(seed), p)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3])
def test_plain_forward_matches_reference(p):
    x, _, params = jax_case()
    got = gcfn_train_plain(torch.from_numpy(x), port_params(params), 1e-5,
                           1234, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref(x, params,
                                                               1234, p)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3])
def test_plain_backward_matches_jax_vjp(p):
    """dx and all nine parameter gradients of the plain version's autograd
    against ``jax.vjp`` of the reference."""
    x, dout, params = jax_case(seed=1)
    _, vjp = jax.vjp(lambda xx, pp: gcfn_train_reference(
        xx, pp, 1e-5, jnp.int32(99), p), jnp.asarray(x),
        [jnp.asarray(a) for a in params])
    ref_dx, ref_dp = vjp(jnp.asarray(dout))
    dx, dparams = gcfn_train_bwd_plain(torch.from_numpy(x),
                                       port_params(params), 1e-5, 99, p,
                                       torch.from_numpy(dout))
    ref_dp = [np.asarray(a) for a in ref_dp]
    ref_dp[4] = ref_dp[4].T
    for name, got, ref in zip(("x",) + NAMES, (dx, *dparams),
                              (np.asarray(ref_dx), *ref_dp)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.linalg.norm(ref),
                                   err_msg=name)


def test_plain_matches_the_pallas_kernels_in_interpret_mode():
    """The JAX package's K7/K8 (interpret mode) against the port's plain
    forward and its autograd, at T = 32, one block."""
    x, dout, params = jax_case(b=2, t=32, seed=2)
    jp = tuple(jnp.asarray(a) for a in params)
    out, vjp = jax.vjp(lambda xx, pp: jax_fused_gcfn_train(
        xx, pp, jnp.int32(7), 1e-5, 0.1, True), jnp.asarray(x), jp)
    ref_dx, ref_dp = vjp(jnp.asarray(dout))
    got = gcfn_train_plain(torch.from_numpy(x), port_params(params), 1e-5, 7,
                           0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
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


def test_gcfn_module_in_train_mode_matches_reference():
    """The port's GCFN in train mode (weights through the flax mapping
    table) drops with the seed its TrainMode draws, as the reference does
    with that seed; its gradients reach the parameters in their shapes."""
    f, t, p = 16, 40, 0.1
    x = np.random.default_rng(3).normal(size=(2, t, f)).astype(np.float32)
    model = jb.GCFN(f, p, fused="off")
    params = boost_layer_scale(
        model.init(jax.random.key(3), jnp.asarray(x))["params"])
    port = load_port(tb.GCFN(f), convert._gcfn, params)
    seeds = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=torch.Generator().manual_seed(5)))
    train = tb.TrainMode(p, torch.Generator().manual_seed(0), seeds)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, None, train)
    ref_params = [params["norm"]["scale"], params["norm"]["bias"],
                  params["proj_in"]["kernel"], params["proj_in"]["bias"],
                  params["depthwise"]["kernel"][:, 0, :],
                  params["depthwise"]["bias"], params["proj_out"]["kernel"],
                  params["proj_out"]["bias"], params["layer_scale"]["scale"]]
    ref = jax_ref(x, ref_params, seed, p)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    got.square().sum().backward()
    for name, prm in port.named_parameters():
        assert prm.grad is not None and prm.grad.shape == prm.shape, name


def test_fused_gcfn_train_takes_the_plain_version_on_the_cpu():
    x, _, params = jax_case(seed=4)
    pp = port_params(params)
    got = fused_gcfn_train(torch.from_numpy(x), pp, 1e-5, 3, 0.05)
    torch.testing.assert_close(
        got, gcfn_train_plain(torch.from_numpy(x), pp, 1e-5, 3, 0.05),
        rtol=0, atol=0)


def test_dense_train_attention_past_512_matches_flax():
    """t = 600 pads to 640 > 512: the port's train attention takes the
    dense path that JAX's "xla" train path runs (dropout 0 here, where
    both are deterministic)."""
    f, h, t, maxlen = 16, 2, 600, 700
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    table = rng.normal(size=(2 * maxlen, f // h)).astype(np.float32)
    pos = _jax_relpos(table, t, maxlen)
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(6), jnp.asarray(x), pos)["params"])
    ref = model.apply({"params": params}, jnp.asarray(x), pos, train=True)
    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    tpos = tb.RelPos(length=t, pos_kt=materialize_pos_kt(
        torch.from_numpy(table), 640, maxlen))
    train = tb.TrainMode(0.0, torch.Generator(), torch.Generator())
    got = port(torch.from_numpy(x), tpos, train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
