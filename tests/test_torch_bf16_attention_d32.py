"""K13's and K14's plain bfloat16 versions at head width 32 (Large's)
against the JAX package's Pallas kernels in interpret mode, at p 0 with
key lengths (the "single" eval route's form), at the bar and with the
control of ``tests/test_torch_bf16_routes.py``, which holds head width 16
(this case has a file of its own so that each stays under 10 s alone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import attention_train as jattn
from sepreformer_torch.ops.kernels import (
    attention_train_bwd_plain,
    attention_train_plain,
)

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


# [1, 2, 64, 32] (the hash row stride 128)
@pytest.mark.parametrize("d,p,lens", [(32, 0.0, (37,))])
def test_attention_train_bf16_d32_plain_matches_jax_kernel(d, p, lens):
    """K13's and K14's plain bfloat16 versions against the JAX kernels
    ``_fwd_impl`` and ``_bwd_impl`` in interpret mode: the output and
    dq, dk, dv and the table's gradient, all bfloat16."""
    b, h, length, maxlen, seed = 1, 2, 64, 64, 7
    rng = np.random.default_rng(d)
    q, k, v, dout = (rng.normal(size=(b, h, length, d)) for _ in range(4))
    table = rng.normal(size=(2 * maxlen, d)) * 0.5
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens)
    args = [jb(a) for a in (q, k, v, table)]
    ref = jattn._fwd_impl(*args, seed, maxlen, p, True, lens=jl)
    ref_grads = jattn._bwd_impl(*args, seed, jb(dout), maxlen, p, True,
                                lens=jl)
    targs = [tb(a) for a in (q, k, v, table)]
    f32 = [a.float() for a in targs]
    got = attention_train_plain(*targs, maxlen, seed, p, tl)
    assert_within(got, ref, attention_train_plain(*f32, maxlen, seed, p,
                                                  tl).to(BF16))
    grads = attention_train_bwd_plain(*targs, maxlen, seed, p, tl, tb(dout))
    controls = attention_train_bwd_plain(*f32, maxlen, seed, p, tl,
                                         tb(dout).float())
    for g, r, c in zip(grads, ref_grads, controls):
        assert g.dtype == BF16
        assert_within(g, r, c.to(BF16))
