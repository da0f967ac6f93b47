"""The port's whole eval forward against the JAX package on the CPU.

A Base-structured model at a test width and depth (two stages, F=16)
has seeded weights written out as flax trees (the inverse of the port's
mapping table, kept here); ``from_jax_params`` loads those trees into a
second port model, and both
packages run the same numpy-seeded waveforms, with and without true
``lengths``, and the separated audio and the per-stage aux outputs must
agree at the repo's parity bar (rtol 1e-3, atol 1e-4).  LayerScale is
raised to 0.5 in both, so that the attention and feed-forward branches
show in the output instead of vanishing under the 1e-5 init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_torch import build_model, get_variant, load_separator
from sepreformer_torch.models import from_jax_params
from sepreformer_torch.models.convert import jax_state_dict, mapping_entries

PARITY = dict(rtol=1e-3, atol=1e-4)
T = 800
LENGTHS = (800, 613)


# torch layout -> flax layout, the inverse of convert.TO_TORCH
TO_FLAX = {
    "identity": lambda a: a,
    "linear_w": lambda a: a.T,
    "conv1x1_w": lambda a: a[:, :, 0].T,
    "depthwise_w": lambda a: a.transpose(2, 1, 0),
    "enc_conv_w": lambda a: a[:, 0, :].T,
    "dec_conv_w": lambda a: a[:, 0, :],
    "layer_scale": lambda a: np.full(a.size, 0.5, np.float32),
}


def flax_trees(model, cfg):
    """(params, batch_stats) of a port model as flax trees, LayerScale 0.5."""
    trees = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for kind, coll, path, key in mapping_entries(cfg):
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(TO_FLAX[kind](sd[key].numpy()))
    return trees["params"], trees["batch_stats"]


@pytest.fixture(scope="module")
def models():
    cfg = get_variant("tiny").model
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0)
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    port = from_jax_params(params, stats, cfg, device="cpu")
    variables = {"params": params, "batch_stats": stats}
    return JaxSepReformer(jcfg), variables, port, cfg


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(models, masked):
    jmodel, variables, port, _ = models
    x = np.random.default_rng(0).normal(size=(2, T)).astype(np.float32)
    lengths = np.asarray(LENGTHS) if masked else None
    ref_audio, ref_aux = jax.jit(jmodel.apply)(
        variables, jnp.asarray(x),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32))
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x), None if lengths is None
                          else torch.from_numpy(lengths))
    assert audio.shape == ref_audio.shape == (2, 2, T)
    assert aux.shape == ref_aux.shape == (2, 2, 2, T)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)


def test_state_dict_covers_every_weight(models):
    """The mapping table names every parameter and buffer of the port, and
    a missing entry is refused by the strict load."""
    _, variables, port, cfg = models
    sd = jax_state_dict(variables["params"], variables["batch_stats"], cfg)
    assert set(sd) == set(port.state_dict())
    n_flax = sum(np.size(a) for a in jax.tree.leaves(variables["params"]))
    assert n_flax == sum(p.numel() for p in port.parameters())
    broken = dict(variables["params"])
    del broken["out_layer"]
    with pytest.raises(KeyError):
        from_jax_params(broken, variables["batch_stats"], cfg, device="cpu")


def test_separator_call_equals_masked_forward(models, tmp_path):
    """``Separator.__call__`` pads to the bucket and masks the padding: its
    output is the true-length forward.  A reference-format checkpoint
    loads strictly."""
    _, _, port, cfg = models
    path = tmp_path / "epoch.0001.pth"
    torch.save({"model_state_dict": port.state_dict()}, path)
    sep = load_separator("tiny", checkpoint=str(path), device="cpu")
    wav = np.random.default_rng(1).normal(size=(612,)).astype(np.float32)
    got = sep(wav)
    assert [g.shape for g in got] == [(612,), (612,)]
    x = torch.from_numpy(wav[None])
    with torch.inference_mode():
        alone, _ = port(x)
    np.testing.assert_allclose(np.stack(got), alone[:, 0].numpy(),
                               rtol=1e-4, atol=1e-5)
