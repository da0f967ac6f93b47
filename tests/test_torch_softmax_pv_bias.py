"""K3b, K9b and K10b: the two-tensor ``bias=`` forms of the masked
softmax·V kernels, against the JAX package on the CPU.

- ``softmax_pv_plain(..., bias=)`` against the JAX ``softmax_pv(qk, v,
  lens, length, True, bias)`` (its Pallas ``_kernel2`` in interpret
  mode), with and without key lengths, at ``PV_TOL`` of
  ``tests/test_torch_kernels.py`` (rtol 1e-5, atol 1e-6: float32 in
  another order than XLA's).
- The gradient (dscores, dv, dbias) of the wrapper's CPU path, and of its
  autograd function driven with the plain version in the kernel's place,
  against ``jax.vjp`` of the same JAX call.
- ``softmax_pv_dropout_plain`` and ``softmax_pv_dropout_bwd_plain`` with
  ``bias`` against the JAX ``softmax_pv_dropout(..., True, bias)``,
  forward and ``jax.vjp``, at p 0 and 0.1 with ragged key lengths, at
  ``TOL`` of ``tests/test_torch_train_kernels.py`` (rtol 1e-5, atol
  1e-5); and the autograd function of K9b/K10b with the plain versions
  in the kernels' place.

The CUDA kernels against these plain versions are in
``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.softmax_pv import softmax_pv as jax_softmax_pv
from sepreformer_tpu.ops.pallas.softmax_pv_train import (
    softmax_pv_dropout as jax_softmax_pv_dropout,
)
from sepreformer_torch.ops.kernels import (
    softmax_pv,
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
    softmax_pv_plain,
)
from sepreformer_torch.ops.kernels import softmax_pv_train as train_module
from sepreformer_torch.ops.kernels.softmax_pv import _key_lens

from test_torch_kernels import PV_TOL
from test_torch_train_kernels import TOL

# the module, which the package's function of the same name hides
pv_module = importlib.import_module("sepreformer_torch.ops.kernels.softmax_pv")


def case(seed, b=2, h=2, lp=128, d=8):
    """Scores, bias, V and an output cotangent, drawn with numpy."""
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    bias = (rng.normal(size=(b, h, lp, lp)) * 2).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    dout = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    return scores, bias, v, dout


def leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("lp,d", [(128, 8), (256, 16)])
@pytest.mark.parametrize("lens", [None, (100, 57)])
def test_softmax_pv_plain_with_bias_matches_jax_kernel(lp, d, lens):
    scores, bias, v, _ = case(lp + d, lp=lp, d=d)
    length = lp - 28
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = jax_softmax_pv(jnp.asarray(scores), jnp.asarray(v), jl, length,
                         True, jnp.asarray(bias))
    tl = None if lens is None else torch.tensor(lens)
    got = softmax_pv_plain(torch.from_numpy(scores), torch.from_numpy(v), tl,
                           length, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PV_TOL)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(softmax_pv(torch.from_numpy(scores),
                                  torch.from_numpy(v), tl, length,
                                  bias=torch.from_numpy(bias)), got)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("lens", [None, (100, 57)])
def test_softmax_pv_gradient_matches_jax_vjp(with_bias, lens):
    """(dscores, dv[, dbias]) of K3 (K3b), as JAX's ``_bwd`` returns them,
    from the wrapper's CPU path and from the autograd function that CUDA
    tensors take, with ``softmax_pv_plain`` in the kernel's place."""
    scores, bias, v, dout = case(7 + with_bias)
    length = 100
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    args = [scores, v] + ([bias] if with_bias else [])

    def jax_fn(s, vv, *bb):
        return jax_softmax_pv(s, vv, jl, length, True, *bb)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
    refs = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tl = None if lens is None else torch.tensor(lens)
    key_len = _key_lens(2, length, tl, "cpu")
    for route in ("wrapper", "autograd function"):
        ts = leaves(*args)
        tb = ts[2] if with_bias else None
        if route == "wrapper":
            out = softmax_pv(ts[0], ts[1], tl, length, bias=tb)
        else:
            before = softmax_pv.launches, pv_module.softmax_pv_bias.launches
            out = pv_module._with_grad(softmax_pv_plain, ts[0], ts[1],
                                       key_len, length, tb)
            assert out.grad_fn is not None
            assert (softmax_pv.launches,
                    pv_module.softmax_pv_bias.launches) == before
        out.backward(torch.from_numpy(dout))
        for t, ref in zip(ts, refs):
            np.testing.assert_allclose(t.grad.numpy(), ref, **PV_TOL)


DROPOUT_CASES = [(p, lp, lens) for p in (0.0, 0.1) for lp, lens in
                 ((128, (100, 57)), (256, None))]


@pytest.mark.parametrize("p,lp,lens", DROPOUT_CASES)
def test_softmax_pv_dropout_with_bias_matches_jax(p, lp, lens):
    """Forward and ``jax.vjp`` (dscores, dv, dbias = dscores) of the JAX
    ``softmax_pv_dropout`` with ``bias`` (K9b and K10b in interpret mode)
    against the plain versions and the wrapper's CPU autograd."""
    scores, bias, v, dout = case(lp + int(p * 10), lp=lp, d=16)
    length = lp - 28
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    out_ref, vjp = jax.vjp(
        lambda s, vv, bb: jax_softmax_pv_dropout(s, vv, jnp.int32(31), jl,
                                                 length, p, True, bb),
        jnp.asarray(scores), jnp.asarray(v), jnp.asarray(bias))
    ds_ref, dv_ref, db_ref = (np.asarray(g) for g in vjp(jnp.asarray(dout)))
    np.testing.assert_array_equal(ds_ref, db_ref)
    tl = None if lens is None else torch.tensor(lens)
    s_t, v_t, b_t = map(torch.from_numpy, (scores, v, bias))
    got = softmax_pv_dropout_plain(s_t, v_t, 31, tl, length, p, b_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_ref), **TOL)
    ds, dv = softmax_pv_dropout_bwd_plain(s_t, v_t, 31, tl, length, p,
                                          torch.from_numpy(dout), b_t)
    np.testing.assert_allclose(ds.numpy(), ds_ref, **TOL)
    np.testing.assert_allclose(dv.numpy(), dv_ref, **TOL)
    ts = leaves(scores, v, bias)
    softmax_pv_dropout(ts[0], ts[1], 31, tl, length, p,
                       bias=ts[2]).backward(torch.from_numpy(dout))
    for t, ref in zip(ts, (ds_ref, dv_ref, db_ref)):
        np.testing.assert_allclose(t.grad.numpy(), ref, **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("wanted", ["all", "bias only"])
def test_dropout_autograd_function_on_plain_versions(monkeypatch, with_bias,
                                                     wanted):
    """The autograd function that CUDA tensors take (K9/K10, K9b/K10b),
    driven with the plain versions in the kernels' place: the gradients
    of the plain autograd, and a bias cotangent in storage of its own."""
    scores, bias, v, dout = case(11, d=16)
    length, p, seed = 100, 0.1, 9
    lens = torch.tensor([100, 57])
    key_len = _key_lens(2, length, lens, "cpu")

    def fwd(s, *rest):
        *bb, vv, sd, kl, ln, pp = rest
        out = softmax_pv_dropout_plain(s, vv, sd, kl, ln, pp, *bb)
        return out, torch.zeros(()), torch.zeros(())

    def bwd(s, *rest):
        *bb, vv, _, g, _, _, sd, kl, ln, pp = rest
        return softmax_pv_dropout_bwd_plain(s, vv, sd, kl, ln, pp, g, *bb)

    for name in ("softmax_pv_train_fwd", "softmax_pv_train_fwd_bias"):
        monkeypatch.setattr(train_module, name, fwd)
    for name in ("softmax_pv_train_bwd", "softmax_pv_train_bwd_bias"):
        monkeypatch.setattr(train_module, name, bwd)
    refs = leaves(scores, v, bias)
    softmax_pv_dropout_plain(refs[0], refs[1], seed, lens, length, p,
                             refs[2] if with_bias else None
                             ).backward(torch.from_numpy(dout))
    ts = leaves(scores, v, bias)
    if wanted == "bias only":
        ts[0].requires_grad_(False)
    out = train_module._SoftmaxPvDropout.apply(
        ts[0], ts[1], seed, key_len, length, p, ts[2] if with_bias else None)
    out.backward(torch.from_numpy(dout))
    for t, ref in zip(ts, refs):
        if not t.requires_grad or (t is ts[2] and not with_bias):
            assert t.grad is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), ref.grad.numpy(), **TOL)
    if with_bias and wanted == "all":
        assert ts[0].grad.data_ptr() != ts[2].grad.data_ptr()
