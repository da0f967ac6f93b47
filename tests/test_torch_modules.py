"""Modules of the PyTorch port that hold a kernel, against their flax
counterparts on the CPU: GCFN (K1), MultiHeadAttention on the fused_pv
path (K2's pos_kt feeding K3) and RelativePositionalEncoding (K2).

Weights come from the flax init and reach the port through the port's
own mapping table; LayerScale is raised to 0.5 so that each branch, and
not just the residual, shows in the output.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.models import blocks as jb
from sepreformer_tpu.models.sepreformer import (
    RelativePositionalEncoding as JaxRelPosEncoding,
)
from sepreformer_torch.config import ModelConfig
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import convert
from sepreformer_torch.models.sepreformer import RelativePositionalEncoding
from sepreformer_torch.ops.kernels import materialize_pos_kt

TOL = dict(rtol=1e-4, atol=1e-5)


def boost_layer_scale(tree, value=0.5):
    """Copy of a flax param tree as numpy with every LayerScale at value."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = boost_layer_scale(v, value)
            if k == "layer_scale":
                out[k] = {"scale": np.full_like(out[k]["scale"], value)}
        else:
            out[k] = np.asarray(v)
    return out


def load_port(module, add_entries, params):
    """Load flax ``params`` into a port submodule through the mapping table
    (``add_entries(out, path, key)`` is one of convert's builders)."""
    entries = []
    add_entries(entries, (), "m")
    sd = {e.key[2:]: torch.from_numpy(np.ascontiguousarray(
        convert.TO_TORCH[e.kind](convert._get(params, e.path))))
        for e in entries}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("lens", [None, (40, 23)])
def test_gcfn_module_matches_flax(lens):
    f, t = 16, 40
    x = np.random.default_rng(0).normal(size=(2, t, f)).astype(np.float32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    model = jb.GCFN(f, 0.0, fused="off")
    params = boost_layer_scale(
        model.init(jax.random.key(0), jnp.asarray(x))["params"])
    ref = model.apply({"params": params}, jnp.asarray(x), seq_lens=jl)
    port = load_port(tb.GCFN(f), convert._gcfn, params)
    tl = None if lens is None else torch.tensor(lens)
    got = port(torch.from_numpy(x), tl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_gcfn_weights_stay_in_the_kernels_layout():
    """K1 takes the products' weights as [in, out] without a copy: the
    GCFN stores them so under nn.Linear's [out, in] shape, and in-place
    loads, deepcopy and .to() keep the strides."""
    f = 16
    x = jnp.zeros((1, 8, f), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jb.GCFN(f, 0.0, fused="off").init(
            jax.random.key(1), x)["params"])
    port = load_port(tb.GCFN(f), convert._gcfn, params)
    for module in (port, copy.deepcopy(port),
                   copy.deepcopy(port).to(torch.float64)):
        for lin, shape in ((module.net1[1], (6 * f, f)),
                           (module.net2[2], (f, 3 * f))):
            assert tuple(lin.weight.shape) == shape
            assert lin.weight.t().is_contiguous()
    for name, lin in (("proj_in", port.net1[1]), ("proj_out", port.net2[2])):
        np.testing.assert_array_equal(lin.weight.t().detach().numpy(),
                                      params[name]["kernel"])


def _jax_relpos(table, t, maxlen):
    return jb.RelPos(table=jnp.asarray(table), length=t, maxlen=maxlen,
                     impl="xla", pos_kt=jb.gather_pos_kt(
                         jnp.asarray(table), t, maxlen))


@pytest.mark.parametrize("lens", [None, (40, 23)])
def test_mha_fused_pv_matches_flax(lens):
    """The port pads to 128, adds Q·pos_kt from the K2 tensor and runs K3;
    the flax module's XLA path attends at the true length."""
    f, h, t, maxlen = 16, 2, 40, 24
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    table = rng.normal(size=(2 * maxlen, f // h)).astype(np.float32)
    pos = _jax_relpos(table, t, maxlen)
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(1), jnp.asarray(x), pos)["params"])
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = model.apply({"params": params}, jnp.asarray(x), pos, key_lens=jl)

    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    tt = torch.from_numpy(table)
    tpos = tb.RelPos(length=t, pos_kt=materialize_pos_kt(tt, 128, maxlen))
    tl = None if lens is None else torch.tensor(lens)
    got = port(torch.from_numpy(x), tpos, key_lens=tl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("spks", [2, 3])
def test_speaker_axis_attention_matches_flax(spks):
    """Two speakers take the sigmoid form, more the softmax over S."""
    f, h = 16, 2
    x = np.random.default_rng(2).normal(size=(2, spks, 24, f))
    x = x.astype(np.float32)
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(2), jnp.asarray(x))["params"])
    ref = model.apply({"params": params}, jnp.asarray(x))
    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_relative_positional_encoding_matches_flax():
    """At the bottleneck length 40 the port materializes pos_kt at 128
    (the padded length of fused_pv), as the JAX module does on that path
    with its Pallas materializer."""
    kw = dict(feat_dim=16, num_heads=2, pos_maxlen=24)
    jcfg = JaxModelConfig(attention_impl="fused_pv_interpret",
                          relpos_materializer="pallas_interpret", **kw)
    module = JaxRelPosEncoding(jcfg)
    variables = module.init(jax.random.key(3), 40)
    ref = module.apply(variables, 40)
    port = RelativePositionalEncoding(ModelConfig(**kw))
    port.load_state_dict({"pe_k.weight": torch.from_numpy(
        np.array(variables["params"]["pe_k"]))}, strict=True)
    got = port(40)
    assert got.length == ref.length == 40
    assert got.pos_kt.shape == (128, 8, 128)
    np.testing.assert_array_equal(got.pos_kt.detach().numpy(),
                                  np.asarray(ref.pos_kt))
