"""Gradients through the eval kernels K1 (the fused GCFN) and K12 (the
flash rel-pos attention), against the JAX package on the CPU.

The JAX package wraps both in ``jax.custom_vjp`` with a backward that
recomputes through its XLA reference, so ``jax.grad`` through an eval
forward works.  The port gives them the gradient of their plain versions
(``ops/kernels/_autograd.py``).  Each test holds against ``jax.vjp`` of
the JAX call (its Pallas forward in interpret mode) both the wrapper's
CPU path (the plain version's autograd) and the autograd function that
CUDA tensors take, driven with the plain version in the kernel's place.
Tolerances: ``GCFN_TOL`` of ``tests/test_torch_kernels.py`` (rtol 2e-5,
atol 2e-5) and ``KERNEL_TOL`` of ``tests/test_torch_flash.py`` (the
same), float32 sums in another order than XLA's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.attention import (
    flash_relpos_attention as jax_flash_relpos_attention,
)
from sepreformer_tpu.ops.pallas.gcfn import fused_gcfn as jax_fused_gcfn
from sepreformer_torch.ops.kernels import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
    fused_gcfn,
    gcfn_plain,
)
from sepreformer_torch.ops.kernels.softmax_pv import _key_lens

from test_torch_flash import KERNEL_TOL, to_heads
from test_torch_kernels import GCFN_TOL, gcfn_params, torch_layout

# the modules, which the package's functions of the same names hide
gcfn_module = importlib.import_module("sepreformer_torch.ops.kernels.gcfn")
flash_module = importlib.import_module(
    "sepreformer_torch.ops.kernels.flash_attention")
ROUTES = ("wrapper", "autograd function")


def leaves(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


@pytest.mark.parametrize("lens", [None, (48, 31)])
def test_fused_gcfn_gradient_matches_jax_vjp(lens):
    b, t, f, eps = 2, 48, 16, 1e-5
    rng = np.random.default_rng(21)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    params = gcfn_params(rng, f)
    g = rng.normal(size=(b, t, f)).astype(np.float32)
    mask = None
    if lens is not None:
        mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None])
        mask = jnp.asarray(mask[..., None], jnp.float32)
    _, vjp = jax.vjp(
        lambda xx, pp: jax_fused_gcfn(xx, pp, eps, True, mask),
        jnp.asarray(x), tuple(map(jnp.asarray, params)))
    dx_ref, dparams_ref = vjp(jnp.asarray(g))
    refs = [np.asarray(dx_ref)] + [np.asarray(a) for a in dparams_ref]
    refs[5] = refs[5].T             # the k3 weight [3, 6F] as [6F, 3]
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    for route in ROUTES:
        ts = leaves([x] + [a.detach().numpy() for a in torch_layout(params)])
        if route == "wrapper":
            out = fused_gcfn(ts[0], ts[1:], eps, tl)
        else:
            before = fused_gcfn.launches
            out = gcfn_module._with_grad(gcfn_plain, ts[0], ts[1:], eps, tl)
            assert fused_gcfn.launches == before
        out.backward(torch.from_numpy(g))
        for name, a, ref in zip(["x"] + "lns lnb win bin wdw bdw wout bout "
                                "ls".split(), ts, refs):
            np.testing.assert_allclose(a.grad.numpy(), ref, **GCFN_TOL,
                                       err_msg=f"{route}: d{name}")


@pytest.mark.parametrize("lens", [None, (160, 37)])
def test_flash_relpos_attention_gradient_matches_jax_vjp(lens):
    """L 160 with maxlen 48, so that most pairs clamp; dq, dk, dv and the
    table's gradient."""
    b, h, d, length, maxlen = 2, 2, 16, 160, 48
    rng = np.random.default_rng(22)
    q, k, v = (rng.normal(size=(b, length, h * d)).astype(np.float32)
               for _ in range(3))
    table = rng.normal(size=(2 * maxlen, d)).astype(np.float32)
    g = rng.normal(size=(b, length, h * d)).astype(np.float32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    _, vjp = jax.vjp(
        lambda qq, kk, vv, tt: jax_flash_relpos_attention(qq, kk, vv, tt,
                                                          maxlen, True, jl),
        *(jnp.asarray(to_heads(a, h)) for a in (q, k, v)),
        jnp.asarray(table))
    grads = vjp(jnp.asarray(to_heads(g, h)))
    refs = [np.asarray(a).transpose(0, 2, 1, 3).reshape(b, length, h * d)
            for a in grads[:3]] + [np.asarray(grads[3])]
    tl = None if lens is None else torch.tensor(lens)
    key_len = _key_lens(b, length, tl, "cpu")
    for route in ROUTES:
        ts = leaves([q, k, v, table])
        if route == "wrapper":
            out = flash_relpos_attention(*ts, maxlen, tl)
        else:
            before = flash_relpos_attention.launches
            out = flash_module._with_grad(
                lambda *a: flash_relpos_attention_plain(*a, block=64),
                *ts, maxlen, key_len)
            assert flash_relpos_attention.launches == before
        out.backward(torch.from_numpy(g))
        for name, a, ref in zip(("q", "k", "v", "table"), ts, refs):
            np.testing.assert_allclose(a.grad.numpy(), ref, **KERNEL_TOL,
                                       err_msg=f"{route}: d{name}")
