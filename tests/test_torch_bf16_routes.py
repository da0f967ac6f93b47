"""The bfloat16 forms of K13/K14 (the single-block attention) on the CPU,
and ``check_trainable`` on the routes off the default one.  K13's and
K14's plain versions against the JAX package's Pallas kernels in
interpret mode on bfloat16 inputs.  K15 and K16:
``tests/test_torch_bf16_fused.py`` and
``tests/test_torch_bf16_fused_grad.py``; the tiny model on these routes
against JAX's: ``tests/test_torch_bf16_routes_model.py`` (slow).

Both sides round at the same steps (``ops/kernels/attention_train.py``'s
docstring names them), so they agree to the bar of
``tests/test_torch_bf16_kernels.py`` (``PERF.md`` section 2): max |port -
JAX| <= 2 bf16 ulps of max|out| and mean |port - JAX| <= 2e-5 of
max|out|, and the plain version with its rounding steps left out
(float32 throughout, the result rounded) must exceed the mean limit.
Readings (max, mean over max|out|; the control's mean): K13 0 and 0 (d
16 at p 0.1, d 32 at p 0 with key lengths; control 2.6e-4 and 2.9e-4);
K14's dq, dk, dv and dtable 0 to 4.4e-8 and 0 to 1.1e-11 (control 9.5e-5
to 2.7e-4).  Each file here stays under 10 s alone on this CPU, about 4
of them the imports, so the head width 32 case has a file of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import attention_train as jattn
from sepreformer_torch import get_variant
from sepreformer_torch.config import apply_override
from sepreformer_torch.engine.train import check_trainable
from sepreformer_torch.ops.kernels import (
    attention_train_bwd_plain,
    attention_train_plain,
    flash_relpos_attention_train,
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


# ---- K13/K14 -----------------------------------------------------------

# [1, 2, 64, 16] (the hash row stride 128) at p 0.1 with every key; head
# width 32 at p 0 with key lengths (the "single" eval route's form):
# tests/test_torch_bf16_attention_d32.py, a file of its own for time
@pytest.mark.parametrize("d,p,lens", [(16, 0.1, None)])
def test_attention_train_bf16_plain_matches_jax_kernel(d, p, lens):
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


def test_attention_train_bf16_autograd_is_the_plain_backward():
    """On bfloat16 CPU tensors the autograd function's gradients are
    ``attention_train_bwd_plain``'s (an autograd through the rounding
    would round the gradients too), in bfloat16."""
    b, h, length, d, maxlen = 1, 2, 40, 16, 64
    rng = np.random.default_rng(3)
    q, k, v, dout = (tb(rng.normal(size=(b, h, length, d)))
                     for _ in range(4))
    table = tb(rng.normal(size=(2 * maxlen, d)))
    leaves = [a.clone().requires_grad_() for a in (q, k, v, table)]
    out = flash_relpos_attention_train(*leaves, 5, maxlen, 0.1)
    assert out.dtype == BF16
    out.backward(dout)
    want = attention_train_bwd_plain(q, k, v, table, maxlen, 5, 0.1, None,
                                     dout)
    for a, w in zip(leaves, want):
        assert a.grad.dtype == BF16 and torch.equal(a.grad, w)


# ---- the routes in training ---------------------------------------------

def bf16_variant(**fields):
    cfg = apply_override(get_variant("tiny"), "model.compute_dtype",
                         "bfloat16")
    for field, value in fields.items():
        cfg = apply_override(cfg, f"model.{field}", value)
    return cfg


@pytest.mark.parametrize("fields,refused", [
    (dict(attention_train_impl="pallas"), False),
    (dict(attention_impl="single"), False),
    (dict(fused_local="on", fused_pair="on"), False),
    (dict(fused_pair="on", dropout=0.0), True),
    (dict(fused_pair="on", dropout=0.0, compute_dtype="float32"), False)])
def test_check_trainable_refuses_k16_at_dropout_0_alone(fields, refused):
    """bfloat16 trains on every route; the one refusal is the fused pair
    at dropout 0, where the train step would take K16's gradient, which
    the JAX package cannot take in bfloat16 either."""
    cfg = bf16_variant(**fields)
    if refused:
        with pytest.raises(NotImplementedError,
                           match="ega_gcfn.py::_bwd.*no bfloat16 gradient"):
            check_trainable(cfg)
    else:
        check_trainable(cfg)
