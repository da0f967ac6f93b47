"""The fused eval blocks' routes on the CPU: the rule (``blocks.
fused_route``) as a table, the config fields, and a two-stage eval
forward with ``fused_local="on"`` and ``fused_pair="on"`` against the
JAX package's forward with both on "interpret", at a length where some
stages take the kernels and some fall back.  Spies count the calls of
the two wrappers that the rule predicts; with ragged lengths neither is
called.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_torch import build_model, get_variant
from sepreformer_torch.config import ModelConfig, apply_override
from sepreformer_torch.models import blocks, from_jax_params
from test_torch_slice import flax_trees

PARITY = dict(rtol=1e-3, atol=1e-4)
# 2076 samples: 516 frames; stage 0 (516 = 4 x 129) has no block, stage 1
# (258) and the bottleneck (129) fit one
SAMPLES = 2076


# a 3.3 s request padded to 6608 frames: stages 0, 1 and 4 (6608, 3304,
# 413) have a block, stages 2 and 3 (1652, 826) none
@pytest.mark.parametrize("length,fits", [(6608, True), (3304, True),
                                         (1652, False), (826, False),
                                         (413, True)])
@pytest.mark.parametrize("train_p", [None, 0.0, 0.05])
@pytest.mark.parametrize("has_seq_lens", [False, True])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_route_table(mode, has_seq_lens, train_p, length, fits):
    local = blocks.fused_route(mode, length, train_p, has_seq_lens,
                               train_ok=False)
    pair = blocks.fused_route(mode, length, train_p, has_seq_lens,
                              train_ok=True)
    on = mode == "on" and not has_seq_lens and fits
    assert local == (on and train_p is None)
    assert pair == (on and train_p in (None, 0.0))


@pytest.mark.parametrize("field", ["fused_local", "fused_pair"])
def test_config_fields(field):
    assert getattr(ModelConfig(), field) == "auto"
    with pytest.raises(ValueError, match=field):
        ModelConfig(**{field: "interpret"})
    with pytest.raises(ValueError, match=field):
        ModelConfig(**{field: "yes"})
    base = get_variant("SepReformer_Base_WSJ0")
    assert getattr(apply_override(base, f"model.{field}", "on").model,
                   field) == "on"


def expected_calls(frames, num_stages, takes):
    """Calls per forward of one fused wrapper: five blocks of each kind at
    every scale (two in the encoder stage, three in the decoder stage)
    and two at the bottleneck, each where ``takes(stage length)``."""
    calls = sum(5 * takes(frames >> s) for s in range(num_stages))
    return calls + 2 * takes(frames >> num_stages)


@pytest.fixture(scope="module")
def models():
    tiny = get_variant("tiny").model
    cfg = dataclasses.replace(tiny, fused_local="on", fused_pair="on")
    jcfg = JaxModelConfig(**{k: getattr(tiny, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, fused_local="interpret",
        fused_pair="interpret")
    params, stats = flax_trees(build_model(tiny, device="cpu"), tiny)
    # running statistics away from their 0/1 start, so that the folded
    # BatchNorm of K15 is not the identity
    rng = np.random.default_rng(20)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                 else rng.normal(size=v.shape) * 0.1).astype(np.float32)
                for k, v in tree.items()}

    stats = perturb(stats)
    port = from_jax_params(params, stats, cfg, device="cpu")
    return JaxSepReformer(jcfg), {"params": params, "batch_stats": stats}, \
        port, cfg


def spy(monkeypatch):
    calls = {"fused_cla": 0, "fused_ega_tail_gcfn": 0}
    for name in calls:
        real = getattr(blocks, name)

        def counted(*args, real=real, name=name):
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(blocks, name, counted)
    return calls


def test_forward_matches_jax(models, monkeypatch):
    jmodel, variables, port, cfg = models
    x = np.random.default_rng(21).normal(size=(2, SAMPLES)).astype(
        np.float32)
    ref_audio, ref_aux = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    calls = spy(monkeypatch)
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x))
    frames = cfg.padded_frames((SAMPLES - cfg.enc_kernel) // cfg.enc_stride
                               + 1)
    assert frames == 516
    assert calls == {
        "fused_cla": expected_calls(
            frames, cfg.num_stages,
            lambda t: blocks.fused_route("on", t, None, False, False)),
        "fused_ega_tail_gcfn": expected_calls(
            frames, cfg.num_stages,
            lambda t: blocks.fused_route("on", t, None, False, True))}
    assert calls["fused_cla"] == calls["fused_ega_tail_gcfn"] == 7
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio),
                               **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)


def test_ragged_lengths_take_no_fused_block(models, monkeypatch):
    _, _, port, _ = models
    x = np.random.default_rng(22).normal(size=(2, SAMPLES)).astype(
        np.float32)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        port(torch.from_numpy(x), torch.tensor([SAMPLES, 1500]))
    assert calls == {"fused_cla": 0, "fused_ega_tail_gcfn": 0}
