"""The bfloat16 forms of K1, K3 and K12: their plain versions against the
JAX package's Pallas kernels in interpret mode; the refusals of the
kernels that have no bfloat16 instance, and of training in bfloat16.

Both sides take bfloat16 streams as the Pallas kernels do: bfloat16
operands, float32 sums, float32 statistics and softmax, the result in
the stream's dtype.  They round at the same steps, but sum in other
orders (K12's online softmax rounds its probabilities against each key
block's running max, the plain version against the row's max), so they
agree to a bfloat16 limit: max |port - JAX| <= 2 bf16 ulps of max|out|
(2 * 2^-7 * max|out|) and the mean |port - JAX| <= 2e-5 of max|out|.
Readings (max, mean over max|out|): K1 8.7e-4 and 4.0e-8, with lengths
and without; K3 with bf16 V 0 and 0 (f32 scores and bf16 scores); K12
2.0e-3 and 8.2e-7.  K3 with bf16 scores and f32 V is held at float32's
bar (rtol 1e-5).  A control, the plain version with the rounding steps
left out (float32 operands throughout, the result then rounded), must
exceed the mean limit, which shows that the limit sees the rounding:
it reads K1 1.1e-4 and 8.8e-5, K3 9.0e-5 and 1.0e-4, K12 2.5e-4.  (A
mean limit of 1e-3 of max|out| would not tell the control apart.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.attention import _flash_relpos_attention_impl
from sepreformer_tpu.ops.pallas.gcfn import _fused_gcfn_impl
from sepreformer_tpu.ops.pallas.softmax_pv import softmax_pv as jax_softmax_pv
from sepreformer_torch.ops.kernels import (
    _build,
    flash_relpos_attention_plain,
    flash_relpos_attention_train,
    fused_cla,
    fused_ega_tail_gcfn,
    fused_gcfn_train,
    gcfn_plain,
    softmax_pv,
    softmax_pv_dropout,
    softmax_pv_plain,
)
from sepreformer_torch import get_variant
from sepreformer_torch.config import apply_override
from sepreformer_torch.engine import Engine, train_step
from sepreformer_torch.ops.kernels import depthwise_bwd

from test_torch_kernels import gcfn_params, torch_layout

BF16 = torch.bfloat16
MAX_ULPS = 2 * 2.0 ** -7      # max |port - JAX| over max|out|
MEAN_LIMIT = 2e-5             # mean |port - JAX| over max|out|
ITEM = "queue B, bfloat16 streams"


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


def bf16_array(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def bf16_tensor(a):
    return torch.from_numpy(a).to(BF16)


@pytest.mark.parametrize("lens", [None, (256, 141)])
def test_gcfn_bf16_matches_jax_kernel(lens):
    """K1 at [2, 256, 64]: LN in f32, xn and g rounded to bf16 before the
    products (weights in bf16, f32 sums), the residual stored as bf16."""
    b, t, f = 2, 256, 64
    rng = np.random.default_rng(64)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    params = gcfn_params(rng, f)
    mask = None
    if lens is not None:
        mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None])
        mask = jnp.asarray(mask[..., None], jnp.float32)
    ref = _fused_gcfn_impl(bf16_array(x), tuple(map(jnp.asarray, params)),
                           1e-5, interpret=True, mask=mask)
    tl = None if lens is None else torch.tensor(lens)
    xb = bf16_tensor(x)
    got = gcfn_plain(xb, torch_layout(params), 1e-5, tl)
    control = gcfn_plain(xb.float(), torch_layout(params), 1e-5, tl).to(BF16)
    assert_within(got, ref, control)


@pytest.mark.parametrize("scores_bf16, v_bf16", [
    (False, True), (True, True), (True, False)])
def test_softmax_pv_bf16_matches_jax_kernel(scores_bf16, v_bf16):
    """K3 at [1, 2, 128, 128], d=16, ragged: the scores read in their
    dtype and upcast, p = exp(s - m) and l in f32, p rounded to V's dtype
    before ·V, / l after it, the result in V's dtype."""
    b, h, lp, d, length = 1, 2, 128, 16, 100
    rng = np.random.default_rng(16)
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    lens = (77,)
    js = bf16_array(scores) if scores_bf16 else jnp.asarray(scores)
    jv = bf16_array(v) if v_bf16 else jnp.asarray(v)
    ref = jax_softmax_pv(js, jv, jnp.asarray(lens, jnp.int32), length, True)
    ts = bf16_tensor(scores) if scores_bf16 else torch.from_numpy(scores)
    tv = bf16_tensor(v) if v_bf16 else torch.from_numpy(v)
    tl = torch.tensor(lens)
    got = softmax_pv_plain(ts, tv, tl, length)
    assert got.dtype == tv.dtype
    if not v_bf16:  # float32 out: compared as the JAX kernel stores it
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        return
    control = softmax_pv_plain(ts.float(), tv.float(), tl, length).to(BF16)
    assert_within(got, ref, control)


def test_flash_bf16_matches_jax_kernel():
    """K12 at [1, 2, 256, 32] (``test_pallas_bf16.py``'s shape), maxlen
    64: bf16 q, k, v and table, f32 sums of the products, the scale, mask
    and online softmax in f32, p rounded to bf16 before ·V, the output
    bf16."""
    b, h, length, d, maxlen = 1, 2, 256, 32, 64
    rng = np.random.default_rng(32)
    q, k, v = (rng.normal(size=(b, h, length, d)).astype(np.float32)
               for _ in range(3))
    pe = (rng.normal(size=(2 * maxlen, d)) * 0.1).astype(np.float32)
    ref = _flash_relpos_attention_impl(
        bf16_array(q), bf16_array(k), bf16_array(v), jnp.asarray(pe),
        maxlen, interpret=True)
    ref = ref.transpose(0, 2, 1, 3).reshape(b, length, h * d)

    def channels_last(a):
        return bf16_tensor(a.transpose(0, 2, 1, 3).reshape(b, length, -1)
                           .copy())

    args = [channels_last(a) for a in (q, k, v)] + [bf16_tensor(pe)]
    got = flash_relpos_attention_plain(*args, maxlen, block=64)
    control = flash_relpos_attention_plain(
        *(a.float() for a in args), maxlen).to(BF16)
    assert_within(got, ref, control)


def cpu_bf16(*shape):
    return torch.zeros(*shape, dtype=BF16)


# each kernel without a bf16 instance, called with a bf16 tensor on the
# CPU: it raises before the plain version runs, as it would on the card
REFUSALS = {
    "K3b": lambda: softmax_pv(cpu_bf16(1, 2, 128, 128), cpu_bf16(1, 128, 32),
                              bias=cpu_bf16(1, 2, 128, 128)),
    "K5": lambda: depthwise_bwd(cpu_bf16(1, 40, 8), torch.zeros(8, 1, 9),
                                cpu_bf16(1, 40, 8)),
    "K7/K8": lambda: fused_gcfn_train(cpu_bf16(1, 40, 16),
                                      torch_layout(gcfn_params(
                                          np.random.default_rng(0), 16)),
                                      1e-5, 1, 0.1),
    "K9/K10": lambda: softmax_pv_dropout(cpu_bf16(1, 2, 128, 128),
                                         cpu_bf16(1, 128, 32), 1, p=0.1),
    "K13/K14": lambda: flash_relpos_attention_train(
        *(cpu_bf16(1, 2, 64, 16) for _ in range(3)), cpu_bf16(128, 16), 1,
        64, 0.1),
    "K15": lambda: fused_cla(cpu_bf16(1, 64, 128), [], 1e-5),
    "K16": lambda: fused_ega_tail_gcfn(cpu_bf16(1, 64, 128),
                                       cpu_bf16(1, 8, 128), [], [], 1e-5),
}


@pytest.mark.parametrize("kernel", sorted(REFUSALS))
def test_kernels_without_bf16_refuse_it(kernel):
    with pytest.raises(ValueError, match=ITEM):
        REFUSALS[kernel]()


def test_dtype_checks_raise_without_launching():
    """``check_dtype`` names the item; ``check_tensor`` refuses a bf16
    tensor where float32 is expected, before any launch."""
    x = cpu_bf16(4, 4)
    with pytest.raises(ValueError, match=ITEM):
        _build.check_dtype("k", x)
    _build.check_dtype("k", x, (torch.float32, BF16))
    with pytest.raises(ValueError, match="dtype torch.bfloat16"):
        _build.check_tensor(x, "k x", (4, 4), x.device)


def test_training_refuses_bf16(tmp_path):
    """``train_step`` and the ``Engine``'s train mode raise on a bf16
    ``compute_dtype``, naming the ROADMAP item; nothing trains in float32
    instead."""
    cfg = apply_override(get_variant("tiny"), "model.compute_dtype",
                         "bfloat16")
    engine = Engine(cfg, str(tmp_path), device="cpu")
    state = engine.state
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(NotImplementedError, match="queue A, bf16 training"):
        engine.run("train")
    with pytest.raises(NotImplementedError, match="queue A, bf16 training"):
        train_step(state, torch.zeros(2, 800), torch.zeros(2, 2, 800), 1e-3,
                   0.4, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b)
               for a, b in zip(before, state.model.parameters()))
