"""K6, the dw/db-only backward of the k65 depthwise conv, and the
``BWD_MODE = "conv"`` backward of ``depthwise_large``, against the JAX
package on the CPU.

``depthwise_bwd_w_plain`` is held against the Pallas kernel
``_impl_bwd_w`` in interpret mode and against ``jax.grad`` of
``depthwise_reference``; the port's ``depthwise_large`` under
``BWD_MODE = "conv"`` (dx from the library convolution of dy with the
flipped kernel, dw and db from K6's plain version) against the JAX
package's ``depthwise_large`` with its own ``BWD_MODE`` set to "conv" by
``monkeypatch`` (no JAX file changes).  Inputs come from numpy seeds; the
bar is ``test_torch_train_kernels.py``'s for K5 (float32 sums in another
order).  The CUDA kernel against its plain version is in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sepreformer_tpu.ops.pallas.depthwise as jax_depthwise
from sepreformer_torch.ops.kernels import (
    depthwise_bwd,
    depthwise_bwd_plain,
    depthwise_bwd_w,
    depthwise_bwd_w_plain,
    depthwise_large,
)
from sepreformer_torch.ops.kernels import depthwise as port_depthwise

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    b, t, c, k = 2, 600, 128, 65
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(k, c)) * 0.1).astype(np.float32)   # JAX [k, C]
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(b, t, c)).astype(np.float32)
    return x, w, bias, dy


def port_weight(w):
    return torch.from_numpy(np.ascontiguousarray(w.T[:, None, :]))


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_vjp"])
def test_bwd_w_plain_matches_jax(case, reference):
    x, w, bias, dy = case
    k = w.shape[0]
    if reference == "pallas_interpret":
        dw, db = jax_depthwise._impl_bwd_w(jnp.asarray(x), jnp.asarray(dy), k,
                                           interpret=True)
    else:
        _, vjp = jax.vjp(jax_depthwise.depthwise_reference, jnp.asarray(x),
                         jnp.asarray(w), jnp.asarray(bias))
        _, dw, db = vjp(jnp.asarray(dy))
    got_dw, got_db = depthwise_bwd_w_plain(torch.from_numpy(x),
                                           torch.from_numpy(dy), k)
    assert got_dw.shape == (128, 1, k)
    np.testing.assert_allclose(got_dw[:, 0, :].numpy().T, np.asarray(dw),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(db), rtol=1e-4,
                               atol=1e-4)
    before = depthwise_bwd_w.launches
    wrapped = depthwise_bwd_w(torch.from_numpy(x), torch.from_numpy(dy), k)
    assert depthwise_bwd_w.launches == before          # CPU: no kernel
    for a, r in zip(wrapped, (got_dw, got_db)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_bwd_w_plain_is_k5s_dw_and_db(case):
    x, w, _, dy = case
    tx, ty = torch.from_numpy(x), torch.from_numpy(dy)
    _, dw, db = depthwise_bwd_plain(tx, port_weight(w), ty)
    got = depthwise_bwd_w_plain(tx, ty, w.shape[0])
    torch.testing.assert_close(got[0], dw, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got[1], db, rtol=0, atol=0)


def test_conv_mode_gradients_match_jax_conv_mode(case, monkeypatch):
    """The whole ``BWD_MODE = "conv"`` backward in both packages: dx,
    dw and db of sum(depthwise_large(x, w, b) * dy)."""
    x, w, bias, dy = case
    monkeypatch.setattr(jax_depthwise, "BWD_MODE", "conv")
    monkeypatch.setattr(port_depthwise, "BWD_MODE", "conv")
    ref = jax.grad(
        lambda *a: jnp.sum(jax_depthwise.depthwise_large(*a, True)
                           * jnp.asarray(dy)),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    tx = torch.from_numpy(x).requires_grad_()
    tw = port_weight(w).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    fused_calls = depthwise_bwd.launches
    (depthwise_large(tx, tw, tb) * torch.from_numpy(dy)).sum().backward()
    assert depthwise_bwd.launches == fused_calls
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(tw.grad[:, 0, :].numpy().T, np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref[2]),
                               rtol=1e-4, atol=1e-4)


def test_conv_mode_takes_k6_and_fused_mode_k5(case, monkeypatch):
    """Which wrapper each mode's backward calls; an unknown mode
    raises."""
    x, w, bias, dy = case
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(port_depthwise, "depthwise_bwd",
                        spy("K5", depthwise_bwd))
    monkeypatch.setattr(port_depthwise, "depthwise_bwd_w",
                        spy("K6", depthwise_bwd_w))
    grads = {}
    for mode in ("fused", "conv", "nope"):
        monkeypatch.setattr(port_depthwise, "BWD_MODE", mode)
        tx = torch.from_numpy(x).requires_grad_()
        out = (depthwise_large(tx, port_weight(w), torch.from_numpy(bias))
               * torch.from_numpy(dy)).sum()
        if mode == "nope":
            with pytest.raises(ValueError, match="BWD_MODE"):
                out.backward()
        else:
            out.backward()
            grads[mode] = tx.grad
    assert calls == ["K5", "K6"]
    torch.testing.assert_close(grads["conv"], grads["fused"], **TOL)
