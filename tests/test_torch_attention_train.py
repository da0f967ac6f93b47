"""K13 and K14, the single-block train attention, against the JAX package
on the CPU.

The port's plain versions (``attention_train_plain`` and
``attention_train_bwd_plain``, and the wrapper, which takes the plain
version with PyTorch's autograd for CPU tensors) are held against the JAX
package's ``attention_train_reference`` and ``jax.grad`` of it at lengths
128, 300 and 500 (padded to 128, 512 and 512), dropout 0 and 0.1, and
maxlen 64 so that the rel-pos clamp is reached, and at one small shape
against the Pallas kernel in interpret mode.  The bars are the JAX
package's own (``tests/test_pallas_attention_train.py``): forward rtol
2e-5, atol 2e-5; gradients, the table's included, rtol 5e-4, atol 5e-5.
The CUDA kernels against the plain versions are in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.attention import pick_block as jax_pick_block
from sepreformer_tpu.ops.pallas.attention_train import (
    attention_train_reference,
    flash_relpos_attention_train as jax_flash_relpos_attention_train,
)
from sepreformer_tpu.ops.pallas.gcfn_train import keep_mask as jax_keep_mask
from sepreformer_torch.ops.kernels import (
    attention_train_bwd,
    attention_train_bwd_plain,
    attention_train_fwd,
    attention_train_plain,
    flash_relpos_attention_train,
)
from sepreformer_torch.ops.kernels.attention_train import (
    drop_scale,
    pick_block,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
MAXLEN, SEED = 64, 1234


def case(length, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, h, length, d)).astype(np.float32)
                     for _ in range(4))
    table = rng.normal(size=(2 * MAXLEN, d)).astype(np.float32)
    lens = np.array([length, length * 3 // 5], np.int32)[:b]
    return q, k, v, table, dout, lens


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("length", [128, 300, 500])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_plain_matches_jax_reference(length, p, masked):
    q, k, v, table, _, lens = case(length)
    ln = lens if masked else None
    ref = attention_train_reference(
        *map(jnp.asarray, (q, k, v, table)), MAXLEN, jnp.int32(SEED), p,
        None if ln is None else jnp.asarray(ln))
    tq, tk, tv, tt = torch_args(q, k, v, table)
    tl = None if ln is None else torch.from_numpy(ln)
    got = attention_train_plain(tq, tk, tv, tt, MAXLEN, SEED, p, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    before = attention_train_fwd.launches
    wrapped = flash_relpos_attention_train(tq, tk, tv, tt, SEED, MAXLEN, p,
                                           tl)
    assert attention_train_fwd.launches == before     # CPU: no kernel
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("length", [128, 300, 500])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_gradients_plain_match_jax_grad(length, p):
    """``attention_train_bwd_plain`` and the wrapper's CPU autograd
    against ``jax.grad`` of the reference, in q, k, v and the table."""
    q, k, v, table, dout, _ = case(length, seed=1)

    def loss(q, k, v, table):
        out = attention_train_reference(q, k, v, table, MAXLEN,
                                        jnp.int32(SEED), p)
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, table)))
    tq, tk, tv, tt, tg = torch_args(q, k, v, table, dout)
    plain = attention_train_bwd_plain(tq, tk, tv, tt, MAXLEN, SEED, p, None,
                                      tg)
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv, tt)]
    before = attention_train_bwd.launches
    (flash_relpos_attention_train(*leaves[:3], leaves[3], SEED, MAXLEN, p)
     * tg).sum().backward()
    assert attention_train_bwd.launches == before
    for name, r, a, b in zip(("dq", "dk", "dv", "dtable"), ref, plain,
                             (x.grad for x in leaves)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_gradients_with_key_lengths_match_jax_grad():
    """The eval route's key lengths through the backward (the JAX
    kernel's vjp takes them too)."""
    q, k, v, table, dout, lens = case(300, seed=2)

    def loss(q, k, v, table):
        out = attention_train_reference(q, k, v, table, MAXLEN,
                                        jnp.int32(0), 0.0, jnp.asarray(lens))
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, table)))
    got = attention_train_bwd_plain(*torch_args(q, k, v, table), MAXLEN, 0,
                                    0.0, torch.from_numpy(lens),
                                    torch.from_numpy(dout))
    for r, a in zip(ref, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("length", [100, 128, 300, 500])
def test_keep_mask_is_the_jax_kernels_at_its_row_index(length):
    """The mask at row bh * pick_block(L) + i (512 at L = 300, where
    K9/K10's 128-padded row stride would be 384), bit for bit."""
    b, h, p = 2, 2, 0.1
    block = pick_block(length)
    assert block == jax_pick_block(length)
    got = drop_scale(SEED, b, h, block, p, torch.device("cpu"))
    rows = (np.arange(b * h, dtype=np.int32).reshape(b, h, 1, 1) * block
            + np.arange(block, dtype=np.int32).reshape(1, 1, block, 1))
    cols = np.arange(block, dtype=np.int32).reshape(1, 1, 1, block)
    ref = jax_keep_mask(jnp.int32(SEED), 0, jnp.asarray(rows),
                        jnp.asarray(cols), p) / (1.0 - p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plain_matches_the_pallas_kernel_in_interpret_mode():
    q, k, v, table, dout, _ = case(128, b=1, seed=3)
    p = 0.1
    jargs = [jnp.asarray(a) for a in (q, k, v, table)]

    def loss(q, k, v, table):
        out = jax_flash_relpos_attention_train(q, k, v, table,
                                               jnp.int32(SEED), MAXLEN, p,
                                               True)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(*jargs)
    targs = torch_args(q, k, v, table)
    got = attention_train_plain(*targs, MAXLEN, SEED, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    plain = attention_train_bwd_plain(*targs, MAXLEN, SEED, p, None,
                                      torch.from_numpy(dout))
    for r, a in zip(grads, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


def test_longer_than_one_block_is_refused():
    q = torch.zeros(1, 1, 513, 16)
    with pytest.raises(NotImplementedError, match="dense"):
        flash_relpos_attention_train(q, q, q, torch.zeros(8, 16), 0, 4, 0.0)
