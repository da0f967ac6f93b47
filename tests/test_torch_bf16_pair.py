"""The bfloat16 form of K16 (the EGA tail fused with the GCFN) on the
CPU: its plain version against the JAX package's Pallas kernel in
interpret mode on bfloat16 inputs, at Base's and Large's widths, and its
missing gradient on both sides.

Both sides round at the same steps (``ops/kernels/ega_gcfn.py``'s
docstring names them), so they agree to the bar of
``tests/test_torch_bf16_kernels.py`` (``PERF.md`` section 2): max |port -
JAX| <= 2 bf16 ulps of max|out| and mean |port - JAX| <= 2e-5 of
max|out|, and the plain version with its rounding steps left out
(float32 throughout, the result rounded) must exceed the mean limit.
Readings (max, mean over max|out|; the control's mean): 2.7e-3 and
4.3e-7 (F 128, T 1024), 1.4e-3 and 2.1e-6 (F 256; control 1.5e-4 and
3.4e-4).  LayerScale near 0.5, where the float32 tests' 0.01 would leave
the output x's own rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import ega_gcfn as jpair
from sepreformer_torch.ops.kernels import (
    ega_tail_gcfn_plain,
    fused_ega_tail_gcfn,
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


# ---- K16 ---------------------------------------------------------------

def pair_inputs(rng, t, length, f):
    h = 6 * f
    x, xd = rng.normal(size=(1, t, f)), rng.normal(size=(1, length, f))
    gate = [rng.normal(size=(f,)), rng.normal(size=(f,)) * 0.1,
            rng.normal(size=(f, f)) * 0.1, rng.normal(size=(f,)) * 0.1]
    gcfn = [rng.normal(size=(f,)), rng.normal(size=(f,)) * 0.1,
            rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(3, h)) * 0.3, rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(h // 2, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
            0.5 + 0.1 * rng.normal(size=(f,))]
    gate = [np.asarray(a, np.float32) for a in gate]
    gcfn = [np.asarray(a, np.float32) for a in gcfn]
    return x, xd, gate, gcfn


def port_params(gate, gcfn):
    """The port's tensors: the GCFN's k3 weight as the Conv1d's [6F, 3]."""
    tg = [torch.from_numpy(a) for a in gate]
    tc = [torch.from_numpy(a) for a in gcfn]
    tc[4] = tc[4].t().contiguous()
    return tg, tc


# Base's and Large's widths; T 1024 takes two JAX blocks of 512 (r = 8)
@pytest.mark.parametrize("t,length,f", [(1024, 128, 128), (64, 16, 256)])
def test_pair_bf16_plain_matches_jax_kernel(t, length, f):
    rng = np.random.default_rng(t + f)
    x, xd, gate, gcfn = pair_inputs(rng, t, length, f)
    ref = jpair._impl(jb(x), jb(xd), tuple(map(jnp.asarray, gate)),
                      tuple(map(jnp.asarray, gcfn)), 1e-5, interpret=True)
    tg, tc = port_params(gate, gcfn)
    got = ega_tail_gcfn_plain(tb(x), tb(xd), tg, tc, 1e-5)
    assert got.dtype == BF16
    control = ega_tail_gcfn_plain(tb(x).float(), tb(xd).float(), tg, tc,
                                  1e-5).to(BF16)
    assert_within(got, ref, control)


def test_pair_bf16_has_no_gradient_on_either_side():
    """Under autograd a bfloat16 K16 raises, naming the JAX package's
    VJP; ``jax.grad`` through the JAX ``fused_ega_tail_gcfn`` on the same
    bfloat16 inputs raises too.  Without autograd the call runs."""
    rng = np.random.default_rng(16)
    x, xd, gate, gcfn = pair_inputs(rng, 64, 8, 128)
    jg, jc = tuple(map(jnp.asarray, gate)), tuple(map(jnp.asarray, gcfn))
    # traced alone (the raise comes in the VJP's trace, before any
    # compile)
    with pytest.raises(Exception, match="bfloat16"):
        jax.make_jaxpr(jax.grad(lambda xx: jpair.fused_ega_tail_gcfn(
            xx, jb(xd), jg, jc, 1e-5, True).astype(jnp.float32).sum()))(
                jb(x))
    tg, tc = port_params(gate, gcfn)
    with pytest.raises(NotImplementedError,
                       match="ega_gcfn.py::_bwd.*no bfloat16 gradient"):
        fused_ega_tail_gcfn(tb(x).requires_grad_(), tb(xd), tg, tc, 1e-5)
    with torch.no_grad():
        out = fused_ega_tail_gcfn(tb(x), tb(xd), tg, tc, 1e-5)
    assert out.dtype == BF16
