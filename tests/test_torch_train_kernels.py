"""Train-path kernels of the PyTorch port against the JAX package on the
CPU: the dropout hash, K5 (k65 depthwise backward), K9 and K10 (masked
softmax·dropout·V and its backward), K11 (the uPIT SI-SNR table) and K2's
gradient.

Each plain version is held against the JAX package's Pallas kernel run
in interpret mode (or its vjp), on the same numpy-seeded inputs.  The
CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.depthwise import (
    _impl_bwd as jax_depthwise_bwd,
)
from sepreformer_tpu.ops.pallas.depthwise import depthwise_reference
from sepreformer_tpu.ops.pallas.gcfn_train import keep_mask as jax_keep_mask
from sepreformer_tpu.ops.pallas.pit import sisnr_pairwise_neg_fused as jax_pit
from sepreformer_tpu.ops.pallas.relpos import (
    materialize_pos_kt as jax_materialize_pos_kt,
)
from sepreformer_tpu.ops.pallas.softmax_pv_train import (
    softmax_pv_dropout as jax_softmax_pv_dropout,
)
from sepreformer_torch.ops.kernels import (
    depthwise_bwd_plain,
    depthwise_large,
    fused_gcfn,
    materialize_pos_kt,
    pos_kt,
    sisnr_pairwise_neg,
    sisnr_pairwise_neg_fused,
    softmax_pv,
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
)
from sepreformer_torch.ops.kernels.hash_dropout import keep_mask
from sepreformer_torch.ops.kernels.relpos import pos_kt_grad, relpos_index

# float32 sums in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2, 2 ** 31 - 1])
@pytest.mark.parametrize("p", [0.05, 0.1])
def test_keep_mask_is_bit_identical_to_jax(seed, p):
    rows = np.concatenate([np.arange(0, 2 ** 31 - 1, 2 ** 31 // 97),
                           np.arange(2 ** 24 - 3, 2 ** 24 + 40)])
    rows = rows.astype(np.int32)[:, None]
    cols = np.arange(700, dtype=np.int32)[None]
    ref = jax_keep_mask(jnp.int32(seed), 0, jnp.asarray(rows),
                        jnp.asarray(cols), p)
    got = keep_mask(seed, 0, torch.from_numpy(rows), torch.from_numpy(cols),
                    p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert abs(float(got.mean()) - (1 - p)) < 0.01


@pytest.fixture(scope="module")
def depthwise_case():
    rng = np.random.default_rng(5)
    b, t, c, k = 2, 600, 128, 65
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (rng.normal(size=(k, c)) * 0.1).astype(np.float32)   # JAX [k, C]
    dy = rng.normal(size=(b, t, c)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_vjp"])
def test_depthwise_bwd_plain_matches_jax(depthwise_case, reference):
    x, w, dy = depthwise_case
    if reference == "pallas_interpret":
        dx, dw, db = jax_depthwise_bwd(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(dy), interpret=True)
    else:
        _, vjp = jax.vjp(depthwise_reference, jnp.asarray(x), jnp.asarray(w),
                         jnp.zeros(w.shape[1], jnp.float32))
        dx, dw, db = vjp(jnp.asarray(dy))
    weight = torch.from_numpy(np.ascontiguousarray(w.T[:, None, :]))
    gx, gw, gb = depthwise_bwd_plain(torch.from_numpy(x), weight,
                                     torch.from_numpy(dy))
    assert gw.shape == (128, 1, 65)
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(gw[:, 0].numpy().T, np.asarray(dw),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(db), rtol=1e-5,
                               atol=1e-4)


def test_depthwise_large_gradient_is_the_conv_gradient():
    """The autograd function's backward (the plain tap loop on the CPU)
    equals autograd through ``F.conv1d``, for an odd k the model does not
    use and a width that is no multiple of 128."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 50, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 1, 11)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 50, 24)).astype(np.float32))
    grads = []
    for fn in (depthwise_large, lambda a, ww, bb: torch.nn.functional.conv1d(
            torch.nn.functional.pad(a.transpose(1, 2), (5, 5)), ww, bb,
            groups=24).transpose(1, 2)):
        leaves = [a.clone().requires_grad_() for a in (x, w, bias)]
        (fn(*leaves) * g).sum().backward()
        grads.append([a.grad for a in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def attention_case(lp, lens):
    rng = np.random.default_rng(lp + (0 if lens is None else 1))
    b, h, d = 2, 2, 16
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    dout = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    return scores, v, dout


ATTN_CASES = [(p, lp, lens) for p in (0.0, 0.1) for lp in (128, 256)
              for lens in (None, "ragged")]


def _lens(lp, lens):
    length = lp - 28
    return length, (None if lens is None else (length, length // 2))


@pytest.mark.parametrize("p,lp,lens", ATTN_CASES)
def test_softmax_pv_dropout_plain_matches_jax(p, lp, lens):
    scores, v, _ = attention_case(lp, lens)
    length, kl = _lens(lp, lens)
    ref = jax_softmax_pv_dropout(
        jnp.asarray(scores), jnp.asarray(v), jnp.int32(77),
        None if kl is None else jnp.asarray(kl, jnp.int32), length, p, True)
    got = softmax_pv_dropout_plain(
        torch.from_numpy(scores), torch.from_numpy(v), 77,
        None if kl is None else torch.tensor(kl), length, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("p,lens", [(0.0, None), (0.1, "ragged")])
def test_softmax_pv_dropout_backward_matches_jax_vjp(p, lens):
    lp = 256
    scores, v, dout = attention_case(lp, lens)
    length, kl = _lens(lp, lens)
    jl = None if kl is None else jnp.asarray(kl, jnp.int32)
    _, vjp = jax.vjp(
        lambda s, vv: jax_softmax_pv_dropout(s, vv, jnp.int32(5), jl, length,
                                             p, True),
        jnp.asarray(scores), jnp.asarray(v))
    ds_ref, dv_ref = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    tl = None if kl is None else torch.tensor(kl)
    ds, dv = softmax_pv_dropout_bwd_plain(
        torch.from_numpy(scores), torch.from_numpy(v), 5, tl, length, p,
        torch.from_numpy(dout))
    np.testing.assert_allclose(ds.numpy(), ds_ref, **TOL)
    np.testing.assert_allclose(dv.numpy(), dv_ref, **TOL)
    # the wrapper's gradient on the CPU is the plain version's autograd
    s_t = torch.from_numpy(scores).requires_grad_()
    v_t = torch.from_numpy(v).requires_grad_()
    out = softmax_pv_dropout(s_t, v_t, 5, tl, length, p)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(s_t.grad.numpy(), ds_ref, **TOL)
    np.testing.assert_allclose(v_t.grad.numpy(), dv_ref, **TOL)


def test_softmax_pv_dropout_refuses_lengths_past_512():
    with pytest.raises(NotImplementedError):
        softmax_pv_dropout(torch.zeros(1, 1, 640, 640),
                           torch.zeros(1, 640, 16), 0, None, 600, 0.1)


@pytest.mark.parametrize("spks,t", [(2, 4000), (3, 1000)])
def test_sisnr_table_and_gradient_match_jax(spks, t):
    rng = np.random.default_rng(spks)
    src = rng.normal(size=(spks, 2, t)).astype(np.float32)
    est = (src[::-1] + 0.3 * rng.normal(size=src.shape)).astype(np.float32)
    est[0, 1] = src[1, 1] + 1e-4 * est[0, 1]          # a high-SI-SNR pair
    g = rng.normal(size=(2, spks, spks)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda e, s: jax_pit(e, s, True, 1e-8, -30.0, True),
        jnp.asarray(est), jnp.asarray(src))
    de_ref, ds_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    e_t = torch.from_numpy(est.copy()).requires_grad_()
    s_t = torch.from_numpy(src.copy()).requires_grad_()
    table = sisnr_pairwise_neg_fused(e_t, s_t)
    np.testing.assert_allclose(
        sisnr_pairwise_neg(e_t, s_t).detach().numpy(), np.asarray(ref),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(table.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    table.backward(torch.from_numpy(g))
    # the high-SI-SNR pair's residual e - scale*s is 1e-4 of its signal,
    # so float32 roundoff in it shows in its gradient, which is 100x the
    # others: the JAX package's gradient bar, rtol 2e-3 and atol 1e-5 of
    # the largest gradient
    for got, ref in ((e_t.grad, de_ref), (s_t.grad, ds_ref)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("t,maxlen", [(128, 40), (256, 300)])
def test_pos_kt_gradient_matches_jax_vjp(t, maxlen):
    rng = np.random.default_rng(t)
    table = rng.normal(size=(2 * maxlen, 8)).astype(np.float32)
    g = rng.normal(size=(t, 8, t)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda tab: jax_materialize_pos_kt(tab, t, maxlen, True),
        jnp.asarray(table))
    ref, = vjp(jnp.asarray(g))
    tab = torch.from_numpy(table).requires_grad_()
    pos_kt(tab, t, maxlen).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("t,maxlen", [(7, 1), (9, 4), (4, 3), (5, 20)])
def test_pos_kt_gradient_is_the_scatter_add(t, maxlen):
    """The diagonal sums equal the gather's scatter-add into the table,
    where no offset clips, where one side clips and where both do."""
    g = torch.from_numpy(np.random.default_rng(t).normal(
        size=(t, 3, t)))
    idx = torch.from_numpy(relpos_index(t, maxlen)).reshape(-1)
    ref = torch.zeros(2 * maxlen, 3, dtype=g.dtype).index_add_(
        0, idx, g.permute(0, 2, 1).reshape(t * t, 3))
    torch.testing.assert_close(pos_kt_grad(g, t, maxlen), ref, rtol=1e-12,
                               atol=1e-12)


def test_eval_wrappers_refuse_autograd_off_the_cpu():
    """K2 has no backward: off the CPU, a call that autograd would record
    raises instead of returning a result with no gradient (meta tensors
    stand in for the card's here).  K1 and K3 have the gradient of their
    plain versions, as in the JAX package: under autograd as without it,
    the same call reaches the wrapper's device checks."""
    meta = torch.device("meta")
    x = torch.empty(1, 8, 128, device=meta, requires_grad=True)
    params = [torch.empty(s, device=meta) for s in
              [(128,), (128,), (128, 768), (768,), (768, 3), (768,),
               (384, 128), (128,), (128,)]]
    table = torch.empty(20, 4, device=meta, requires_grad=True)
    scores = torch.empty(1, 2, 16, 16, device=meta, requires_grad=True)
    v = torch.empty(1, 16, 32, device=meta)
    with pytest.raises(RuntimeError, match="no backward"):
        materialize_pos_kt(table, 12, 10)
    with torch.no_grad(), pytest.raises(ValueError):
        materialize_pos_kt(table, 12, 10)
    for call in (lambda: fused_gcfn(x, params, 1e-5),
                 lambda: softmax_pv(scores, v, None, 10),
                 lambda: softmax_pv(scores, v, None, 10, bias=scores)):
        with pytest.raises(ValueError):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()
