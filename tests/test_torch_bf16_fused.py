"""The bfloat16 form of K15 (the fused CLA) on the CPU: its plain version
against the JAX package's Pallas kernel in interpret mode on bfloat16
inputs, at Base's and Large's widths (its gradient:
``tests/test_torch_bf16_fused_grad.py``; K16, the EGA tail + GCFN:
``tests/test_torch_bf16_pair.py``, each file under 10 s alone here).

Both sides round at the same steps (the modules' docstrings name them),
so they agree to the bar of ``tests/test_torch_bf16_kernels.py``
(``PERF.md`` section 2): max |port - JAX| <= 2 bf16 ulps of max|out| and
mean |port - JAX| <= 2e-5 of max|out|, and the plain version with its
rounding steps left out (float32 throughout, the result rounded) must
exceed the mean limit.  Readings (max, mean over max|out|; the
control's mean): 3.0e-3 and 2.4e-6 (F 128, T 640), 2.8e-3 and 9.6e-7
(F 256; control 1.7e-4 and 5.1e-4; the JAX kernel's erf is Abramowitz
and Stegun's, the port's exact).  The
inputs are scaled so that the rounding shows: LayerScale near 0.5, where
the float32 tests' 0.01 would leave the output x's own rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import cla as jcla
from sepreformer_torch.ops.kernels import cla_plain

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


def assert_within(got, ref, control):
    err_max, err_mean = errors(got, ref)
    assert err_max <= MAX_ULPS, f"max {err_max:.3e}"
    assert err_mean <= MEAN_LIMIT, f"mean {err_mean:.3e}"
    # the limit sees the rounding steps
    assert errors(control, ref)[1] > MEAN_LIMIT


def jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


# ---- K15 ---------------------------------------------------------------

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


# Base's and Large's widths; T 640 takes five JAX blocks of 128 (the halo
# crosses block edges)
@pytest.mark.parametrize("t,f", [(640, 128), (64, 256)])
def test_cla_bf16_plain_matches_jax_kernel(t, f):
    rng = np.random.default_rng(t + f)
    x = rng.normal(size=(1, t, f))
    params = cla_params(rng, f)
    ref = jcla._fused_cla_impl(jb(x), tuple(map(jnp.asarray, params)), 1e-5,
                               interpret=True)
    tp = [torch.from_numpy(a) for a in params]
    got = cla_plain(tb(x), tp, 1e-5)
    assert got.dtype == BF16
    assert_within(got, ref, cla_plain(tb(x).float(), tp, 1e-5).to(BF16))
