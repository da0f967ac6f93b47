"""Training in bfloat16 on the default train route, on the CPU: the
bfloat16 forms of K7/K8 and K9/K10 (their plain versions against the JAX
package's Pallas kernels in interpret mode), the k65 depthwise gradient
against ``jax.vjp``, the stream's dtypes through one train step, one
train step on each route off the default one, and one CLI epoch with a
resume.

The plain versions take a bfloat16 stream as the Pallas kernels do:
bfloat16 product operands, float32 sums, float32 statistics and
softmax, the outputs in the stream's dtype and the GCFN's parameter
gradients as float32 sums.  They round at the same steps but sum in
other orders, so they agree to a bfloat16 limit: max |port - JAX| <= 2
bf16 ulps of max|ref| (2 * 2^-7 * max|ref|) and mean |port - JAX| <=
2e-5 of max|ref|, each output on its own.  A control, the plain version
with the rounding steps left out (float32 operands throughout, the
outputs then rounded to the stream's dtype), must exceed the mean limit
on the outputs that carry the rounding, which shows that the limit sees
it.  Readings (max, mean over max|ref|) are in the tests' docstrings.

A whole bfloat16 train step against JAX's ``make_train_step`` takes
43-73 s cold on this CPU; it is ``tests/test_torch_bf16_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import depthwise as jax_depthwise
from sepreformer_tpu.ops.pallas.gcfn_train import (
    _bwd_train_impl,
    _fwd_train_impl,
)
from sepreformer_tpu.ops.pallas.softmax_pv_train import _bwd_impl, _fwd_impl
from sepreformer_torch import cli, get_variant
from sepreformer_torch.config import ModelConfig, VariantConfig, apply_override
from sepreformer_torch.data.synth import generate_corpus
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.engine.checkpoint import latest_epoch
from sepreformer_torch.engine.train import check_trainable
from sepreformer_torch.ops.kernels import (
    depthwise,
    depthwise_large,
    gcfn_train_bwd_plain,
    gcfn_train_plain,
    softmax_pv_dropout,
    softmax_pv_dropout_bwd_plain,
    softmax_pv_dropout_plain,
)

from test_torch_kernels import gcfn_params, torch_layout
from test_torch_train import STEP_MODEL, boosted_model

BF16 = torch.bfloat16
MAX_ULPS = 2 * 2.0 ** -7      # max |port - JAX| over max|ref|
MEAN_LIMIT = 2e-5             # mean |port - JAX| over max|ref|


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as the other training tests hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def errors(got: torch.Tensor, ref) -> tuple:
    """(max, mean) of |got - ref| over max|ref|."""
    a = got.float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    d = np.abs(a - b)
    scale = np.abs(b).max()
    return d.max() / scale, d.mean() / scale


def assert_within(got, ref, name):
    mx, mean = errors(got, ref)
    assert mx <= MAX_ULPS and mean <= MEAN_LIMIT, (
        f"{name}: max {mx:.2e}, mean {mean:.2e} of max|ref|")


def to_jax(a: torch.Tensor):
    return jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == BF16 else jnp.float32)


# ---- K7 and K8 ------------------------------------------------------------

GCFN_CASES = {"f64 t256": (64, 1, 256), "f128 t64": (128, 1, 64)}


def gcfn_case(name):
    f, b, t = GCFN_CASES[name]
    rng = np.random.default_rng(3)
    params = gcfn_params(rng, f)
    x = torch.from_numpy(rng.normal(size=(b, t, f)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(b, t, f)).astype(np.float32))
    return params, torch_layout(params), x.to(BF16), dout.to(BF16)


@pytest.mark.parametrize("case", sorted(GCFN_CASES))
def test_k7_plain_bf16_matches_pallas(case):
    """K7's plain version on a bfloat16 x at p 0.1 against
    ``_fwd_train_impl`` in interpret mode; the control (no rounding
    steps) exceeds the mean limit.  Readings: max 0.0 / 7.8e-3, mean
    0 / 1.6e-5 (f64 t256), and the controls' means 4.9e-4 and 4.6e-4."""
    params, tparams, x, _ = gcfn_case(case)
    ref = _fwd_train_impl(to_jax(x), params, jnp.int32(1234), 1e-5, 0.1,
                          interpret=True)
    got = gcfn_train_plain(x, tparams, 1e-5, 1234, 0.1)
    assert got.dtype == BF16
    assert_within(got, ref, "out")
    control = gcfn_train_plain(x.float(), tparams, 1e-5, 1234, 0.1).to(BF16)
    assert errors(control, ref)[1] > MEAN_LIMIT


@pytest.mark.parametrize("case", sorted(GCFN_CASES))
def test_k8_plain_bf16_matches_pallas(case):
    """K8's plain version (dx and the nine float32 parameter gradients)
    against ``_bwd_train_impl`` in interpret mode at p 0.1; the control,
    the float32 backward of the upcast x and dout, exceeds the mean
    limit on dx and on the products' gradients (d win, d wout)."""
    params, tparams, x, dout = gcfn_case(case)
    dx_ref, dp_ref = _bwd_train_impl(to_jax(x), params, jnp.int32(77),
                                     to_jax(dout), 1e-5, 0.1,
                                     interpret=True)
    dx, dp = gcfn_train_bwd_plain(x, tparams, 1e-5, 77, 0.1, dout)
    assert dx.dtype == BF16
    assert all(g.dtype == torch.float32 for g in dp)
    assert_within(dx, dx_ref, "dx")
    # the port's gradients in the JAX package's layouts (wdw [3, 6F])
    names = "lns lnb win bin wdw bdw wout bout ls".split()
    for name, g, r in zip(names, dp, dp_ref):
        g = g.t() if name == "wdw" else g
        assert_within(g, np.asarray(r).reshape(g.shape), f"d{name}")
    cdx, cdp = gcfn_train_bwd_plain(x.float(), tparams, 1e-5, 77, 0.1,
                                    dout.float())
    assert errors(cdx.to(BF16), dx_ref)[1] > MEAN_LIMIT
    for i in (2, 6):
        assert errors(cdp[i], dp_ref[i])[1] > MEAN_LIMIT, names[i]


# ---- K9 and K10 -------------------------------------------------------------

PAIRINGS = {"f32 scores, bf16 v": (torch.float32, BF16),
            "bf16 scores, bf16 v": (BF16, BF16),
            "bf16 scores, f32 v": (BF16, torch.float32)}


def pv_case(pairing, d=16):
    """The shapes of the JAX package's bf16 softmax_pv_dropout test: [2,
    4, 128, 128] scores, head width 16, a true length of 100, p 0.2."""
    sdt, vdt = PAIRINGS[pairing]
    rng = np.random.default_rng(11)
    b, h, lp = 2, 4, 128
    scores = torch.from_numpy(
        rng.normal(size=(b, h, lp, lp)).astype(np.float32)).to(sdt)
    v = torch.from_numpy(rng.normal(size=(b, lp, h * d)).astype(
        np.float32)).to(vdt)
    dout = torch.from_numpy(rng.normal(size=(b, lp, h * d)).astype(
        np.float32)).to(vdt)
    return scores, v, dout, 100, 5, 0.2


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_k9_plain_bf16_matches_pallas(pairing):
    """K9's plain version against ``_fwd_impl`` in interpret mode, one
    case per pairing of dtypes; with a bfloat16 V the control (weights
    not rounded) exceeds the mean limit."""
    scores, v, _, length, seed, p = pv_case(pairing)
    ref = _fwd_impl(to_jax(scores), to_jax(v), jnp.int32(seed), None,
                    length, p, interpret=True)
    got = softmax_pv_dropout_plain(scores, v, seed, None, length, p)
    assert got.dtype == v.dtype
    assert_within(got[:, :length], np.asarray(ref)[:, :length], "out")
    if v.dtype == BF16:
        control = softmax_pv_dropout_plain(scores.float(), v.float(), seed,
                                           None, length, p).to(BF16)
        assert errors(control[:, :length],
                      np.asarray(ref)[:, :length])[1] > MEAN_LIMIT


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_k10_plain_bf16_matches_pallas(pairing):
    """K10's plain version (dS in the scores' dtype, dV in V's) against
    ``_bwd_impl`` in interpret mode; with a bfloat16 V the control
    (float32 throughout, then rounded) exceeds the mean limit on dS or dV
    (bfloat16 scores with a float32 V round only dS's store, where the
    control rounds it too)."""
    scores, v, dout, length, seed, p = pv_case(pairing)
    ds_ref, dv_ref = _bwd_impl(to_jax(scores), to_jax(v), jnp.int32(seed),
                               None, to_jax(dout), length, p,
                               interpret=True)
    ds, dv = softmax_pv_dropout_bwd_plain(scores, v, seed, None, length, p,
                                          dout)
    assert ds.dtype == scores.dtype and dv.dtype == v.dtype
    assert_within(ds, ds_ref, "dS")
    assert_within(dv, dv_ref, "dV")
    if v.dtype == BF16:
        cds, cdv = softmax_pv_dropout_bwd_plain(
            scores.float(), v.float(), seed, None, length, p, dout.float())
        assert max(errors(cds.to(scores.dtype), ds_ref)[1],
                   errors(cdv.to(v.dtype), dv_ref)[1]) > MEAN_LIMIT


def test_softmax_pv_dropout_bf16_autograd_is_the_plain_backward():
    """On the CPU a bfloat16 pairing's gradient is
    ``softmax_pv_dropout_bwd_plain`` itself (an autograd through the
    rounding would round the cotangents)."""
    scores, v, dout, length, seed, p = pv_case("f32 scores, bf16 v")
    s = scores.clone().requires_grad_()
    vv = v.clone().requires_grad_()
    out = softmax_pv_dropout(s, vv, seed, None, length, p)
    out.backward(dout)
    ds, dv = softmax_pv_dropout_bwd_plain(scores, v, seed, None, length, p,
                                          dout)
    assert torch.equal(s.grad, ds) and torch.equal(vv.grad, dv)


# ---- the k65 depthwise gradient ---------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "conv"])
def test_depthwise_large_bf16_grad_matches_jax(mode, monkeypatch):
    """``depthwise_large``'s gradient on a bfloat16 stream against
    ``jax.vjp`` of the JAX package's ``depthwise_large`` in interpret
    mode, under both backward modes: dx, dw and db in bfloat16, rounded
    from float32 sums of the upcast operands."""
    monkeypatch.setattr(depthwise, "BWD_MODE", mode)
    monkeypatch.setattr(jax_depthwise, "BWD_MODE", mode)
    rng = np.random.default_rng(4)
    b, t, c, k = 2, 96, 128, 65     # the JAX kernel tiles C by 128
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)
                         ).to(BF16)
    w = torch.from_numpy(rng.normal(size=(c, 1, k)).astype(np.float32) / 8
                         ).to(BF16)
    bias = torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(BF16)
    dy = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32)
                          ).to(BF16)
    leaves = [a.clone().requires_grad_() for a in (x, w, bias)]
    depthwise_large(*leaves).backward(dy)
    _, vjp = jax.vjp(
        lambda xx, ww, bb: jax_depthwise.depthwise_large(xx, ww, bb, True),
        to_jax(x), to_jax(w)[:, 0, :].T, to_jax(bias))
    rdx, rdw, rdb = vjp(to_jax(dy))
    for got, ref, name in ((leaves[0].grad, rdx, "dx"),
                           (leaves[1].grad[:, 0, :].t(), rdw, "dw"),
                           (leaves[2].grad, rdb, "db")):
        assert got.dtype == BF16 and ref.dtype == jnp.bfloat16, name
        assert_within(got, ref, name)


# ---- one train step, port alone ---------------------------------------------

def step_state(compute_dtype="bfloat16", **model):
    cfg = VariantConfig("step", model=ModelConfig(
        **{**STEP_MODEL, "compute_dtype": compute_dtype, "dropout": 0.1,
           **model}))
    return create_train_state(cfg, model=boosted_model(cfg.model, seed=0))


def step_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(2, 2000)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, 2000)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(s)


def test_bf16_train_step_stream_dtypes():
    """One bfloat16 train step at dropout 0.1: every module of the train
    forward returns bfloat16 but the model (float32 audio and aux for the
    losses) and the rel-pos encoding; every parameter and every gradient
    is float32, and the metrics are finite."""
    state = step_state()
    model = state.model
    seen = {}

    def hook(name):
        def record(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] = {t.dtype for t in outs
                          if isinstance(t, torch.Tensor)
                          and t.is_floating_point()}
        return record

    handles = [mod.register_forward_hook(hook(name))
               for name, mod in model.named_modules()]
    grads = {}
    for name, prm in model.named_parameters():
        prm.register_hook(lambda g, name=name: grads.__setitem__(name, g))
    try:
        metrics = train_step(state, *step_batch(), 1e-3, 0.4,
                             torch.Generator().manual_seed(1))
    finally:
        for h in handles:
            h.remove()
    assert seen[""] == {torch.float32}
    f32 = {n for n, d in seen.items() if n and d != {BF16}}
    assert f32 == {"separator.pos_emb"}, f32
    assert len(seen) > 50
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(grads) == len(list(model.parameters()))
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_bf16_gradient_rounding_by_group():
    """Each group's gradient is rounded where JAX rounds it: the GCFN's
    nine parameters reach K7/K8 in float32, so their gradients are float32
    sums (not bfloat16-exact); the k65 weight's and bias's come back from
    K5 rounded to bfloat16; a Linear's flows through ``stream_param``'s
    cast, so it is the float32 sum of bfloat16 cotangents, not rounded."""
    state = step_state(dropout=0.0)
    grads = {}    # before the clip scales them
    for name, prm in state.model.named_parameters():
        prm.register_hook(lambda g, name=name: grads.__setitem__(name, g))
    train_step(state, *step_batch(), 1e-3, 0.0,
               torch.Generator().manual_seed(1))

    def exact(g):
        return torch.equal(g, g.to(BF16).float())

    k65 = [n for n in grads if ".dw_conv_1d." in n]
    gcfn = [n for n in grads if ".gcfn." in n]
    assert k65 and gcfn
    assert all(exact(grads[n]) for n in k65), k65
    assert not any(exact(grads[n]) for n in gcfn
                   if grads[n].abs().max() > 0 and grads[n].numel() > 8)


# ---- the routes off the default one ----------------------------------------

OFF_DEFAULT = {
    "pallas": ("model.attention_train_impl", "pallas"),
    "fused_pair": ("model.fused_pair", "on"),
    "fused_local": ("model.fused_local", "on"),
    "single": ("model.attention_impl", "single"),
}


@pytest.mark.parametrize("route", sorted(OFF_DEFAULT))
def test_bf16_trains_off_the_default_route(route):
    """bfloat16 trains on the routes off the default one (these cases
    were refusals until K13/K14, K15 and K16 had bfloat16 instances):
    "pallas" through K13/K14's plain versions, "single" at the tiny
    variant's dropout 0.05 (its train attention stays on K9/K10), and the
    fused routes, which a train step at dropout > 0 does not take (they
    serve validation).  ``check_trainable`` passes, one ``train_step``
    changes the float32 parameters, every gradient float32 and finite.
    (The one refusal left, the fused pair at dropout 0:
    ``tests/test_torch_bf16_kernels.py::test_training_refuses_bf16``.)"""
    cfg = apply_override(get_variant("tiny"), "model.compute_dtype",
                         "bfloat16")
    cfg = apply_override(cfg, *OFF_DEFAULT[route])
    assert cfg.model.dropout > 0.0
    check_trainable(cfg)
    state = create_train_state(cfg, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    m = train_step(state, *[a[..., :800] for a in step_batch()], 1e-3, 0.4,
                   torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in state.model.parameters())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state.model.parameters()))


def test_default_route_trains_in_bf16():
    """The default route (K9/K10, K7/K8, K5 under either ``BWD_MODE``)
    passes ``check_trainable`` and one ``train_step`` of the tiny
    variant changes its float32 parameters."""
    cfg = apply_override(get_variant("tiny"), "model.compute_dtype",
                         "bfloat16")
    state = create_train_state(cfg, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    m = train_step(state, *[a[..., :800] for a in step_batch()], 1e-3, 0.4,
                   torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state.model.parameters()))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


# ---- the CLI -------------------------------------------------------------

def test_cli_trains_bf16_and_resumes(tmp_path):
    """One CLI epoch of the tiny model with ``--set
    model.compute_dtype=bfloat16`` on the synthetic corpus, then a
    resume: finite losses, float32 checkpoints.  (The card's CLI runs in
    ``chip_smoke.py`` phase 14 also test.)"""
    corpus = tmp_path / "corpus"
    generate_corpus(str(corpus), n_train=2, n_valid=1, n_test=1,
                    utt_seconds=(0.5, 1.0), seed=0)
    work = tmp_path / "work"
    args = ["--model", "tiny", "--device", "cpu", "--scp-root", str(corpus),
            "--scp-dir", "scp", "--workdir", str(work), "--batch-size", "2",
            "--set", "dataset.max_len=4000", "--set",
            "dataset.num_workers=1", "--set", "engine.test_epochs=", "--set",
            "model.num_stages=1", "--set", "model.compute_dtype=bfloat16"]
    ckpts = work / "log" / "scratch_weights"
    assert cli.main(args + ["--max-epoch", "2"]) == 0
    assert latest_epoch(str(ckpts)) == 1
    assert cli.main(args + ["--max-epoch", "3"]) == 0
    assert latest_epoch(str(ckpts)) == 2
    payload = torch.load(ckpts / "epoch.0002.pth", weights_only=True)
    assert np.isfinite(payload["extra"]["valid_loss"])
    tensors = [v for v in payload["model_state_dict"].values()
               if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert tensors and all(v.dtype == torch.float32 for v in tensors)
