"""K4, the k65 depthwise forward, on the CPU: the port's plain version
against the JAX package's Pallas forward in interpret mode, at the JAX
kernel tests' shapes, and the wrapper on CPU tensors.  Inputs come from
numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.depthwise import _impl_fwd
from sepreformer_torch.ops.kernels import depthwise_fwd, depthwise_fwd_plain


def case(b, t, c, k):
    rng = np.random.default_rng(b * t + c + k)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(k, c)) * 0.2).astype(np.float32)   # JAX [k, C]
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("b,t,c,k", [(2, 256, 128, 65), (1, 500, 256, 33),
                                     (2, 200, 128, 9)])
def test_depthwise_fwd_plain_matches_jax(b, t, c, k):
    x, w, bias = case(b, t, c, k)
    ref = _impl_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), True)
    weight = torch.from_numpy(np.ascontiguousarray(w.T)[:, None, :])
    got = depthwise_fwd_plain(torch.from_numpy(x), weight,
                              torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_depthwise_fwd_cpu_takes_plain():
    x, w, bias = case(1, 100, 32, 65)
    args = (torch.from_numpy(x),
            torch.from_numpy(np.ascontiguousarray(w.T)[:, None, :]),
            torch.from_numpy(bias))
    before = depthwise_fwd.launches
    np.testing.assert_array_equal(depthwise_fwd(*args).numpy(),
                                  depthwise_fwd_plain(*args).numpy())
    assert depthwise_fwd.launches == before
