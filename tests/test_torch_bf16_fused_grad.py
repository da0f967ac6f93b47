"""K15's gradient in bfloat16 on the CPU: ``fused_cla`` on a bfloat16 x
recomputes the reference's math (``cla_reference``: float32 throughout,
the result cast to bfloat16), as the JAX package's VJP of its
``cla_reference`` does, not the kernel's rounding.  Held against
``jax.vjp`` of the JAX ``fused_cla`` (its kernel in interpret mode) on the
same bfloat16 inputs: x's gradient in bfloat16 within the bar of
``tests/test_torch_bf16_fused.py`` (readings: max 0, mean 0 over
max|grad|), the parameters' in float32 within rtol 1e-3 and 1e-4 of each
one's largest entry.  A file of its own: the JAX VJP's compile takes
about 4 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import cla as jcla
from sepreformer_torch.ops.kernels import fused_cla

BF16 = torch.bfloat16
MAX_ULPS = 2 * 2.0 ** -7      # max |port - JAX| over max|out|
MEAN_LIMIT = 2e-5             # mean |port - JAX| over max|out|


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as in test_torch_engine.py: beside the
    other test workers torch's own pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def errors(got: torch.Tensor, ref) -> tuple:
    """(max, mean) of |got - ref| over max|ref|, both bfloat16."""
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    a = got.float().numpy().astype(np.float64)
    b = np.asarray(ref.astype(jnp.float32), np.float64)
    d = np.abs(a - b)
    scale = np.abs(b).max()
    return d.max() / scale, d.mean() / scale


def jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def cla_params(rng, f, k=65):
    """``cla_plain``'s params as float32 numpy (wdw [k, F]), LayerScale
    near 0.5."""
    h = 2 * f
    out = [rng.normal(size=(f,)), rng.normal(size=(f,)) * 0.1,
           rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
           rng.normal(size=(k, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
           rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
           1.0 + 0.1 * rng.normal(size=(h,)), rng.normal(size=(h,)) * 0.1,
           rng.normal(size=(h, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
           0.5 + 0.1 * rng.normal(size=(f,))]
    return [np.asarray(a, np.float32) for a in out]


def test_cla_bf16_gradient_matches_jax_vjp():
    """``fused_cla``'s gradient on a bfloat16 x recomputes the reference's
    math (float32 throughout, the result cast to bfloat16), as the JAX
    package's VJP of ``cla_reference`` does: x's gradient in bfloat16,
    the parameters' in float32, against ``jax.vjp`` of the JAX
    ``fused_cla`` (its kernel in interpret mode) on the same inputs."""
    rng = np.random.default_rng(15)
    t, f = 32, 64
    x = rng.normal(size=(1, t, f))
    params = cla_params(rng, f)
    g = rng.normal(size=(1, t, f))
    _, vjp = jax.vjp(lambda xx, pp: jcla.fused_cla(xx, pp, 1e-5, True),
                     jb(x), tuple(map(jnp.asarray, params)))
    ref_dx, ref_dp = vjp(jb(g))
    xt = tb(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in params]
    out = fused_cla(xt, pt, 1e-5)
    assert out.dtype == BF16
    out.backward(tb(g))
    assert xt.grad.dtype == BF16 and ref_dx.dtype == jnp.bfloat16
    err_max, err_mean = errors(xt.grad, ref_dx)
    assert err_max <= MAX_ULPS and err_mean <= MEAN_LIMIT, (err_max,
                                                            err_mean)
    for got, want in zip(pt, ref_dp):
        assert got.grad.dtype == torch.float32
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4 * float(
                                       np.abs(np.asarray(want)).max()))
