"""The T, S and M presets against the JAX package on the CPU: presets,
weights and ``embed_v``.

- ``SepReformer_T``, ``_S`` and ``_M`` equal the JAX presets of the same
  name on every field the port's dataclasses have: F 64, 96 and 160 in
  8 heads of 8, 12 and 20, enc_dim 256, 4 stages, Base's other fields.
- ``from_jax_params`` carries seeded weights at each preset's full width
  and depth, loaded strictly; at S's the flax trees have the shapes the
  JAX model's ``init`` gives (traced with ``jax.eval_shape``; T's and M's
  in ``tests/test_torch_tsm_slow.py``).
- ``ModelConfig.embed_v``: the value table ``pe_v`` exists, converts
  under the JAX package's key, and changes no output
  (``tests/test_torch_engine.py`` holds ``from_reference_yaml``'s
  reading of it against the JAX reader's).

The kernels at these widths: ``tests/test_torch_tsm_kernels.py``; the
whole forward: ``tests/test_torch_tsm_slice.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu import config as jax_config
from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_tpu.models.convert import export_torch_state_dict
from sepreformer_torch import build_model, get_variant
from sepreformer_torch.models import from_jax_params
from sepreformer_torch.models.convert import jax_state_dict

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_large import assert_fields_equal
from test_torch_slice import flax_trees

# preset -> (F, head width)
TSM = {"SepReformer_T": (64, 8), "SepReformer_S": (96, 12),
       "SepReformer_M": (160, 20)}


@pytest.mark.parametrize("name", sorted(TSM))
def test_preset_matches_jax(name):
    port, ref = get_variant(name), jax_config.get_variant(name)
    assert_fields_equal(port, ref, name)
    m = port.model
    assert (m.feat_dim, m.head_dim) == TSM[name]
    assert (m.num_heads, m.enc_dim, m.num_stages) == (8, 256, 4)


def jax_model_config(cfg):
    """The JAX ModelConfig of the port's ``cfg`` (the fields both have)."""
    names = {f.name for f in dataclasses.fields(JaxModelConfig)}
    return JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)
                             if f.name in names})


def leaf_shapes(tree):
    """{path: shape} of a tree's leaves."""
    return {jax.tree_util.keystr(path): tuple(np.shape(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def check_jax_shapes(cfg, params, stats):
    """The flax trees have the leaves and shapes of the JAX model's own
    parameters and statistics at ``cfg`` (its ``init``, traced)."""
    shapes = jax.eval_shape(JaxSepReformer(jax_model_config(cfg)).init,
                            jax.random.key(0), jnp.zeros((1, 1600)))
    assert leaf_shapes(shapes) == leaf_shapes({"params": params,
                                              "batch_stats": stats})


@pytest.mark.parametrize("name", sorted(TSM))
def test_from_jax_params_carries_seeded_weights(name):
    """Flax trees of a seeded model at the preset's full width (at S's
    with the JAX model's shapes) load strictly into ``from_jax_params``,
    bit for bit."""
    cfg = get_variant(name).model
    seeded = build_model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    params, stats = flax_trees(seeded, cfg)
    if name == "SepReformer_S":
        check_jax_shapes(cfg, params, stats)
    port = from_jax_params(params, stats, cfg, device="cpu")
    ref = seeded.state_dict()
    for key, value in port.state_dict().items():
        if key.endswith("layer_scale"):   # flax_trees sets them to 0.5
            assert torch.all(value == 0.5), key
        else:
            assert torch.equal(value, ref[key]), key


def test_embed_v_converts_and_is_never_read():
    """A narrow model with ``embed_v``: its converted state dict has the
    JAX package's keys (``separator.pos_emb.pe_v.weight`` among them),
    and its forward, with and without lengths, is the forward of the same
    weights with ``embed_v`` off."""
    cfg = dataclasses.replace(get_variant("tiny").model, embed_v=True)
    plain_cfg = dataclasses.replace(cfg, embed_v=False)
    params, stats = flax_trees(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2)), cfg)
    assert params["separator"]["pos_emb"]["pe_v"].shape == (
        2 * cfg.pos_maxlen, cfg.head_dim)
    sd = jax_state_dict(params, stats, cfg)
    jax_keys = set(export_torch_state_dict(
        {"params": params, "batch_stats": stats}, jax_model_config(cfg)))
    assert set(sd) == jax_keys
    assert "separator.pos_emb.pe_v.weight" in jax_keys
    with_v = from_jax_params(params, stats, cfg, device="cpu")
    pruned = {**params, "separator": {**params["separator"], "pos_emb": {
        "pe_k": params["separator"]["pos_emb"]["pe_k"]}}}
    without = from_jax_params(pruned, stats, plain_cfg, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(2, 800)).astype(np.float32))
    for lens in (None, torch.tensor([800, 613])):
        with torch.inference_mode():
            a, b = with_v(x, lens, aux=False), without(x, lens, aux=False)
        assert torch.equal(a, b)
