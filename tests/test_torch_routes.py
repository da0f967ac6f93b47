"""The JAX package's other attention and depthwise routes in the port, and
the gradient clip, on the CPU.

- ``model.attention_impl`` and ``model.attention_train_impl`` reach the
  port's config through ``apply_override`` (the CLI's ``--set``) as they
  reach the JAX package's; values the port does not take raise.
- ``blocks.attention_route`` decides, for the attention and for the
  rel-pos encoding alike, which kernels a forward reaches: with
  ``attention_train_impl="pallas"`` a train forward at a bottleneck length
  up to 512 runs K13/K14 and no K2, K9 or K10; ``attention_impl="single"``
  serves eval through K13 with no K2 or K3.
- ``apply_gradients`` clips as ``optax.clip_by_global_norm`` does.

- The two-stage F=16 eval forward with ``attention_impl="single"`` and
  ragged lengths against JAX's "single_interpret", at the parity bar
  (rtol 1e-3, atol 1e-4).

The whole train step on these routes against the JAX package is in
``test_torch_routes_jax.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.config import apply_override as jax_apply_override
from sepreformer_tpu.config import get_variant as jax_get_variant
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_tpu.models import blocks as jb
from sepreformer_torch import cli
from sepreformer_torch.config import (
    ModelConfig,
    OptimConfig,
    VariantConfig,
    apply_override,
    get_variant,
)
from sepreformer_torch.data.audio import write_wav
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.engine.train import apply_gradients
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import build_model, convert, from_jax_params
from sepreformer_torch.models import sepreformer as tsep
from test_torch_modules import boost_layer_scale, load_port
from test_torch_slice import LENGTHS, PARITY, T, flax_trees
from test_torch_train import STEP_MODEL, boosted_model

GLOBAL_ATTENTIONS_TINY = 12   # two stages: 2 x 2 + 2 + 2 x 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (see ``test_torch_engine.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl,train_impl,length,train_p,has_lens,route", [
    # eval
    ("auto", "auto", 500, None, False, "fused_pv"),
    ("auto", "auto", 8193, None, True, "flash"),
    ("fused_pv", "auto", 9000, None, False, "fused_pv"),
    ("pallas", "auto", 100, None, True, "flash"),
    ("single", "auto", 512, None, True, "single"),
    ("single", "auto", 513, None, True, "dense"),
    ("xla", "pallas", 100, None, False, "dense"),
    # train
    ("auto", "auto", 512, 0.1, False, "fused_pv"),
    ("auto", "auto", 513, 0.1, False, "dense"),
    ("auto", "fused_pv", 300, 0.1, True, "fused_pv"),
    ("auto", "pallas", 500, 0.1, False, "single"),
    ("auto", "pallas", 513, 0.1, False, "dense"),
    ("auto", "pallas", 500, 0.1, True, "dense"),
    ("auto", "xla", 100, 0.0, False, "dense"),
    ("single", "auto", 300, 0.0, False, "fused_pv"),
    ("single", "auto", 300, 0.0, True, "single"),
    ("single", "xla", 300, 0.0, False, "single"),
    ("single", "xla", 300, 0.1, False, "dense"),
    ("pallas", "xla", 300, 0.0, False, "dense"),
])
def test_attention_route(impl, train_impl, length, train_p, has_lens, route):
    assert tb.attention_route(impl, train_impl, length, train_p,
                              has_lens) == route


def test_override_reaches_both_fields_as_in_jax():
    cfg = get_variant("SepReformer_Base_WSJ0")
    jcfg = jax_get_variant("SepReformer_Base_WSJ0")
    assert (cfg.model.attention_impl, cfg.model.attention_train_impl) == (
        jcfg.model.attention_impl, jcfg.model.attention_train_impl)
    for dotted, raw in (("model.attention_train_impl", "pallas"),
                        ("model.attention_impl", "single")):
        cfg = apply_override(cfg, dotted, raw)
        jcfg = jax_apply_override(jcfg, dotted, raw)
        key = dotted.split(".")[1]
        assert getattr(cfg.model, key) == getattr(jcfg.model, key) == raw


@pytest.mark.parametrize("dotted,raw", [
    ("model.attention_train_impl", "pallas_interpret"),
    ("model.attention_train_impl", "single"),
    ("model.attention_impl", "single_interpret"),
    ("model.attention_impl", "flash"),
])
def test_values_the_port_does_not_take_raise(dotted, raw):
    with pytest.raises(ValueError, match=raw):
        apply_override(get_variant("tiny"), dotted, raw)


def spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def refuse(monkeypatch, module, *names):
    def make(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} called on this route")
        return fn

    for name in names:
        monkeypatch.setattr(module, name, make(name))


def pos_kts(model):
    built = []
    model.separator.pos_emb.register_forward_hook(
        lambda module, args, out: built.append(out.pos_kt))
    return built


def test_pallas_train_route_runs_k13_k14_and_no_k2_k9_k10(monkeypatch):
    """A train step of the tiny variant at bottleneck length 125: every
    global attention takes the single-block kernel's route, RelPos holds
    no pos_kt, and the rel-pos table's gradient comes from that route."""
    cfg = apply_override(get_variant("tiny"), "model.attention_train_impl",
                         "pallas")
    cfg = dataclasses.replace(cfg, optim=OptimConfig(clip_norm=1e9))
    state = create_train_state(cfg, model=build_model(
        cfg.model, device="cpu", generator=torch.Generator().manual_seed(0)))
    calls = []
    spy(monkeypatch, tb, "flash_relpos_attention_train", calls)
    refuse(monkeypatch, tb, "softmax_pv_dropout", "softmax_pv")
    refuse(monkeypatch, tsep, "pos_kt")
    built = pos_kts(state.model)
    s = torch.zeros(2, 2, 8000).normal_(
        generator=torch.Generator().manual_seed(5)) * 0.1
    metrics = train_step(state, s.sum(0), s, 1e-3, 0.4,
                         torch.Generator().manual_seed(6))
    assert np.isfinite(float(metrics["total_loss"]))
    assert calls == ["flash_relpos_attention_train"] * GLOBAL_ATTENTIONS_TINY
    assert built == [None]
    assert state.model.separator.pos_emb.pe_k.weight.grad.abs().sum() > 0


def test_pallas_train_route_past_512_takes_the_dense_attention(monkeypatch):
    """At t = 600 both packages' "pallas" train routes fall to the dense
    attention (dropout 0, where both are deterministic)."""
    f, h, t, maxlen = 16, 2, 600, 700
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    table = rng.normal(size=(2 * maxlen, f // h)).astype(np.float32)
    pos = jb.RelPos(table=jnp.asarray(table), length=t, maxlen=maxlen,
                    impl="xla", train_impl="pallas_interpret",
                    pos_kt=jb.gather_pos_kt(jnp.asarray(table), t, maxlen))
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(7), jnp.asarray(x), pos)["params"])
    ref = model.apply({"params": params}, jnp.asarray(x), pos, train=True)
    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    relpos = tsep.RelativePositionalEncoding(ModelConfig(
        feat_dim=f, num_heads=h, pos_maxlen=maxlen,
        attention_train_impl="pallas"))
    relpos.pe_k.weight.data = torch.from_numpy(table)
    refuse(monkeypatch, tb, "flash_relpos_attention_train")
    tpos = relpos(t, train=True)
    assert tpos.pos_kt is not None
    got = port(torch.from_numpy(x), tpos, train=tb.TrainMode(
        0.0, torch.Generator(), torch.Generator()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_single_route_serves_eval_without_k2_k3(monkeypatch):
    cfg = apply_override(get_variant("tiny"), "model.attention_impl",
                         "single")
    model = build_model(cfg.model, device="cpu")
    calls = []
    spy(monkeypatch, tb, "flash_relpos_attention_train", calls)
    refuse(monkeypatch, tb, "softmax_pv", "flash_relpos_attention")
    refuse(monkeypatch, tsep, "pos_kt")
    built = pos_kts(model)
    x = torch.zeros(2, 4000).normal_(
        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        audio, _ = model(x, torch.tensor([4000, 3100]))
    assert torch.isfinite(audio).all()
    assert calls == ["flash_relpos_attention_train"] * GLOBAL_ATTENTIONS_TINY
    assert built == [None]


def test_cli_set_single_serves_through_k13(tmp_path, monkeypatch, capsys):
    """``--set model.attention_impl=single`` reaches the served model
    through ``cli.main``; a value the port does not take raises."""
    calls = []
    spy(monkeypatch, tb, "flash_relpos_attention_train", calls)
    refuse(monkeypatch, tb, "softmax_pv")
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, 0.3 * np.random.default_rng(2).uniform(-1, 1, 3000), 8000)
    args = ["--model", "tiny", "--device", "cpu", "--engine-mode",
            "infer_sample", "--sample-file", wav, "--workdir",
            str(tmp_path / "w"), "--set"]
    assert cli.main(args + ["model.attention_impl=single"]) == 0
    assert calls == ["flash_relpos_attention_train"] * GLOBAL_ATTENTIONS_TINY
    assert len(capsys.readouterr().out.split()) == 2
    with pytest.raises(ValueError, match="single_interpret"):
        cli.main(args + ["model.attention_impl=single_interpret"])


def test_cli_set_pallas_trains_through_k13(tmp_path, monkeypatch):
    """``--set model.attention_train_impl=pallas`` reaches the trained
    model through ``cli.main``."""
    from sepreformer_torch.data.synth import generate_corpus

    generate_corpus(str(tmp_path / "c"), n_train=2, n_valid=2, n_test=1,
                    utt_seconds=(0.5, 1.0), seed=0)
    calls = []
    spy(monkeypatch, tb, "flash_relpos_attention_train", calls)
    refuse(monkeypatch, tb, "softmax_pv_dropout")
    assert cli.main([
        "--model", "tiny", "--device", "cpu", "--scp-root",
        str(tmp_path / "c"), "--scp-dir", "scp", "--workdir",
        str(tmp_path / "t"), "--batch-size", "2", "--max-epoch", "2",
        "--set", "dataset.max_len=4000", "--set", "dataset.num_workers=1",
        "--set", "engine.test_epochs=", "--set", "model.num_stages=1",
        "--set", "model.attention_train_impl=pallas"]) == 0
    # one epoch of one step (two utterances at batch 2); one stage has
    # 2 + 2 + 3 global attentions; validation takes the eval route (K3)
    assert calls == ["flash_relpos_attention_train"] * 7


def test_single_eval_forward_matches_jax(monkeypatch):
    """The two-stage F=16 eval forward on ``attention_impl="single"``
    with ragged lengths: K13's plain version with key lengths in every
    global attention, against JAX's Pallas kernel in interpret mode."""
    cfg = dataclasses.replace(get_variant("tiny").model,
                              attention_impl="single")
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, attention_impl="single_interpret")
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    port = from_jax_params(params, stats, cfg, device="cpu")
    x = np.random.default_rng(4).normal(size=(2, T)).astype(np.float32)
    lengths = np.asarray(LENGTHS)
    ref_audio, ref_aux = jax.jit(JaxSepReformer(jcfg).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        lengths=jnp.asarray(lengths, jnp.int32))
    calls = []
    spy(monkeypatch, tb, "flash_relpos_attention_train", calls)
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x), torch.from_numpy(lengths))
    assert calls == ["flash_relpos_attention_train"] * GLOBAL_ATTENTIONS_TINY
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(audio[:, b, :n].numpy(),
                                   np.asarray(ref_audio)[:, b, :n], **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)


@pytest.mark.parametrize("scale", [0.1, 1e-5])
def test_apply_gradients_clips_as_optax(scale):
    """At a clip of 1e-3: a global norm above it (3e-3 at scale 0.1)
    scales every gradient by clip / norm, one below it (scale 1e-5)
    leaves them as they are; the norm returned is the one before the
    clip, rtol 1e-6.  optax runs on the gradients raveled into one vector
    (the norm is global), so that JAX compiles one shape."""
    cfg = VariantConfig("clip", model=ModelConfig(**STEP_MODEL),
                        optim=OptimConfig(clip_norm=1e-3))
    state = create_train_state(cfg, model=boosted_model(cfg.model, seed=3))
    named = dict(state.model.named_parameters())
    keys = sorted(named)
    rng = np.random.default_rng(12)
    grads = {k: (rng.normal(size=named[k].shape) * scale
                 / np.sqrt(named[k].numel())).astype(np.float32)
             for k in keys}
    for k in keys:
        named[k].grad = torch.tensor(grads[k])   # a copy: the clip is in place
    norm = float(apply_gradients(state, 0.0))
    flat = jnp.asarray(np.concatenate([grads[k].reshape(-1) for k in keys]))
    np.testing.assert_allclose(norm, float(optax.global_norm(flat)),
                               rtol=1e-6)
    assert (norm > 1e-3) == (scale == 0.1)
    ref, _ = optax.clip_by_global_norm(1e-3).update(flat, None)
    got = np.concatenate([named[k].grad.numpy().reshape(-1) for k in keys])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=0)
