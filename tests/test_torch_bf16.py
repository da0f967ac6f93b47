"""The port's bfloat16 serving forward against the JAX package's, on the
CPU.

``ModelConfig.compute_dtype="bfloat16"`` runs the stream in bfloat16 with
float32 parameters, as the JAX package's policy does.  The ``tiny`` model
(two stages, F=16), its seeded weights written out as flax trees with
every LayerScale at 0.5 (``test_torch_slice.flax_trees``), goes through
the port (the kernels' plain versions, in bfloat16) and through the JAX
package's jitted bfloat16 ``apply`` (its dense XLA paths on the CPU), with
and without true lengths.  The two round at other places (JAX's XLA
modules round each op's result to bfloat16, the port's kernels follow
the Pallas kernels' rounding steps), so they agree to a bfloat16 limit:
max |port - JAX| <= 2e-2 of max|out|.  Readings: audio 1.64e-2 without
lengths and 1.45e-2 with them, aux heads 1.01e-2 and 6.5e-3; each side is
about 1e-2 from its own float32 forward (the port 1.01e-2 and 1.06e-2,
JAX 1.07e-2 and 1.30e-2), and their rounding errors add.  One JAX
program is compiled, with lengths over a full row and a ragged one; the
forward without lengths is held against the full row.  Every other case
runs the port alone.  Forward hooks hold the stream to bfloat16 exactly:
each module returns bfloat16 (the limits above could not tell a module
left in float32 from one in bfloat16).
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
from sepreformer_torch.models import from_jax_params

from test_torch_slice import flax_trees

T = 800
LENGTHS = (800, 613)
# max |port - JAX| over max|out|, both in bfloat16 (see the docstring)
JAX_LIMIT = 2e-2
# bfloat16 against float32 in the port: the JAX package's own bar
# (tests/test_bf16.py)
F32_LIMIT = 0.1


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def models():
    """(JAX bf16 model, its variables, port bf16 model, port f32 model)
    on the same weights, LayerScale 0.5."""
    cfg = get_variant("tiny").model
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, compute_dtype="bfloat16")
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    port16 = from_jax_params(params, stats, cfg16, device="cpu")
    port32 = from_jax_params(params, stats, cfg, device="cpu")
    return (JaxSepReformer(jcfg), {"params": params, "batch_stats": stats},
            port16, port32)


def inputs(masked):
    x = np.random.default_rng(0).normal(size=(2, T)).astype(np.float32)
    return x, (np.asarray(LENGTHS) if masked else None)


@pytest.fixture(scope="module")
def jax_outputs(models):
    """(audio, aux) of JAX's jitted bf16 ``apply`` with ``LENGTHS``: row 0
    is full, so it is also the reference of the forward without them."""
    jmodel, variables, _, _ = models
    x, lengths = inputs(True)
    return jax.jit(jmodel.apply)(variables, jnp.asarray(x),
                                 lengths=jnp.asarray(lengths, jnp.int32))


def port_forward(model, x, lengths):
    with torch.inference_mode():
        return model(torch.from_numpy(x), None if lengths is None
                     else torch.from_numpy(lengths))


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_forward_matches_jax(models, jax_outputs, masked):
    """The tiny bf16 forward, port against JAX's jitted bf16 ``apply``:
    float32 outputs on both sides, within ``JAX_LIMIT`` of max|out|;
    without lengths, the full row."""
    _, _, port16, _ = models
    x, lengths = inputs(masked)
    ref_audio, ref_aux = jax_outputs
    audio, aux = port_forward(port16, x, lengths)
    assert audio.dtype == aux.dtype == torch.float32
    assert ref_audio.dtype == jnp.float32
    assert audio.shape == ref_audio.shape == (2, 2, T)
    assert aux.shape == ref_aux.shape == (2, 2, 2, T)
    rows = slice(None) if masked else slice(0, 1)
    for got, ref in ((audio, ref_audio), (aux, ref_aux)):
        err = rel(got.numpy()[..., rows, :], np.asarray(ref)[..., rows, :])
        assert err <= JAX_LIMIT, f"max |port - JAX| / max|out| {err:.3e}"


def test_bf16_stream_dtypes(models):
    """Every module of the bf16 forward returns bfloat16, but the model
    itself (float32 audio and aux) and the rel-pos encoding (the float32
    table and pos_kt, as the JAX package keeps them)."""
    _, _, port16, _ = models
    seen = {}

    def hook(name):
        def record(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            seen[name] = {t.dtype for t in outs
                          if isinstance(t, torch.Tensor)
                          and t.is_floating_point()}
        return record

    handles = [mod.register_forward_hook(hook(name))
               for name, mod in port16.named_modules()]
    try:
        port_forward(port16, *inputs(True))
    finally:
        for h in handles:
            h.remove()
    assert seen[""] == {torch.float32}
    f32 = {n for n, d in seen.items() if n and d != {torch.bfloat16}}
    assert f32 == {"separator.pos_emb"}, f32
    assert len(seen) > 100


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_against_f32(models, masked):
    """bf16 against float32 in the port, within the JAX package's bar;
    the parameters stay float32 after the bf16 forward."""
    _, _, port16, port32 = models
    x, lengths = inputs(masked)
    audio16, _ = port_forward(port16, x, lengths)
    audio32, _ = port_forward(port32, x, lengths)
    err = rel(audio16.numpy(), audio32.numpy())
    assert 0 < err < F32_LIMIT, err
    assert {p.dtype for p in port16.parameters()} == {torch.float32}


def test_bf16_scores(models, monkeypatch):
    """``scores_dtype="bfloat16"`` with float32 compute, in the port
    alone: the scores that reach K3 are bf16, and the forward matches the
    float32-scores forward within the bf16 limit."""
    from sepreformer_torch.models import blocks

    _, variables, _, port32 = models
    cfg = dataclasses.replace(port32.cfg, scores_dtype="bfloat16")
    port = from_jax_params(variables["params"], variables["batch_stats"],
                           cfg, device="cpu")
    seen = []
    softmax_pv = blocks.softmax_pv

    def spy(scores, v, *args):
        seen.append((scores.dtype, v.dtype))
        return softmax_pv(scores, v, *args)

    x, lengths = inputs(True)
    ref, _ = port_forward(port32, x, lengths)
    monkeypatch.setattr(blocks, "softmax_pv", spy)
    audio, _ = port_forward(port, x, lengths)
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    assert audio.dtype == torch.float32
    assert 0 < rel(audio.numpy(), ref.numpy()) <= JAX_LIMIT


@pytest.mark.parametrize("field, good, bad", [
    ("compute_dtype", ("float32", "bfloat16"), ("float16", "bf16")),
    ("scores_dtype", ("auto", "float32", "bfloat16"), ("float16",)),
])
def test_config_fields(field, good, bad):
    """Both fields parse from ``--set`` with JAX's values and defaults
    ("auto" scores resolve to float32); other values raise."""
    assert getattr(ModelConfig(), field) == good[0]
    base = get_variant("SepReformer_Base_WSJ0")
    for value in good:
        cfg = apply_override(base, f"model.{field}", value)
        assert getattr(cfg.model, field) == value
    for value in bad:
        with pytest.raises(ValueError, match=field):
            apply_override(base, f"model.{field}", value)
    assert ModelConfig().torch_dtype("scores_dtype") == torch.float32
    assert (ModelConfig(compute_dtype="bfloat16").torch_dtype()
            == torch.bfloat16)
