"""The plain versions of the T, S and M presets' eval kernels against the
JAX package's Pallas kernels in interpret mode, on the CPU, at the
presets' widths and the module bar (rtol 1e-4, atol 1e-5):

- K1 (``fused_gcfn``) at F 64, 96 and 160, with and without the u-row
  mask;
- K3 (``softmax_pv``) at head widths 8, 12 and 20, with ragged key
  lengths (one row with a single key) and a length below Lp;
- K12 (``flash_relpos_attention``) at head widths 8, 12 and 20, with and
  without key lengths, maxlen below L so that the clamp acts;
- K2's plain version bit-equal to the Pallas ``materialize_pos_kt`` at
  head widths 8, 12 and 20.

The CUDA instances at these widths are held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.attention import flash_relpos_attention \
    as jax_flash_relpos_attention
from sepreformer_tpu.ops.pallas.gcfn import _fused_gcfn_impl
from sepreformer_tpu.ops.pallas.relpos import (
    materialize_pos_kt as jax_materialize_pos_kt,
)
from sepreformer_tpu.ops.pallas.softmax_pv import softmax_pv as jax_softmax_pv
from sepreformer_torch.ops.kernels import (
    flash_relpos_attention_plain,
    gcfn_plain,
    materialize_pos_kt_plain,
    softmax_pv_plain,
)

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_kernels import gcfn_params, torch_layout

MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lens", [None, (48, 31)])
@pytest.mark.parametrize("f", [64, 96, 160])
def test_gcfn_plain_matches_pallas(f, lens):
    """K1 at the presets' widths: the single-shot Pallas body (t 48),
    with and without the u-row mask."""
    b, t = 2, 48
    rng = np.random.default_rng(f)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    params = gcfn_params(rng, f)
    mask = None
    if lens is not None:
        mask = jnp.asarray((np.arange(t)[None, :] < np.asarray(lens)[:, None])
                           [..., None], jnp.float32)
    ref = _fused_gcfn_impl(jnp.asarray(x), tuple(map(jnp.asarray, params)),
                           1e-5, interpret=True, mask=mask)
    got = gcfn_plain(torch.from_numpy(x), torch_layout(params), 1e-5,
                     None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODULE_TOL)


@pytest.mark.parametrize("d", [8, 12, 20])
def test_softmax_pv_plain_matches_pallas(d):
    """K3 at the presets' head widths, ragged key lengths (one row with a
    single key), length below Lp."""
    b, h, lp, length = 3, 2, 128, 100
    lens = (100, 57, 1)
    rng = np.random.default_rng(d)
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    ref = jax_softmax_pv(jnp.asarray(scores), jnp.asarray(v),
                         jnp.asarray(lens, jnp.int32), length, True)
    got = softmax_pv_plain(torch.from_numpy(scores), torch.from_numpy(v),
                           torch.tensor(lens), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODULE_TOL)


def to_heads(a, h):
    """[B, L, H*d] -> [B, H, L, d] (the Pallas kernel's layout)."""
    b, length, f = a.shape
    return a.reshape(b, length, h, f // h).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [8, 12, 20])
def test_flash_plain_matches_pallas(d, masked):
    """K12 at the presets' head widths: L 200 with maxlen 64, so most
    pairs clamp; the masked case has a row at 38 of 200 keys."""
    b, h, length, maxlen = 2, 2, 200, 64
    rng = np.random.default_rng(d + 1)
    q, k, v = (rng.normal(size=(b, length, h * d)).astype(np.float32)
               for _ in range(3))
    table = rng.normal(size=(2 * maxlen, d)).astype(np.float32)
    lens = np.array([length, 38], np.int32) if masked else None
    ref = jax_flash_relpos_attention(
        *(jnp.asarray(to_heads(a, h)) for a in (q, k, v)), jnp.asarray(table),
        maxlen, True, None if lens is None else jnp.asarray(lens))
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, length, h * d)
    got = flash_relpos_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, table)), maxlen,
        None if lens is None else torch.from_numpy(lens), block=64)
    np.testing.assert_allclose(got.numpy(), ref, **MODULE_TOL)


@pytest.mark.parametrize("d", [8, 12, 20])
def test_pos_kt_plain_is_the_pallas_copy(d):
    """K2 at the presets' head widths, at a padded length whose pairs
    clamp (maxlen 40 < 128)."""
    table = np.random.default_rng(d).normal(size=(80, d)).astype(np.float32)
    ref = jax_materialize_pos_kt(jnp.asarray(table), 128, 40, True)
    got = materialize_pos_kt_plain(torch.from_numpy(table), 128, 40)
    assert got.shape == (128, d, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
