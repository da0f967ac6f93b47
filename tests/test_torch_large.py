"""The Large family against the JAX package on the CPU: presets and
head width 32.

- Every preset the port adds (``SepReformer_Large_DM_WSJ0``,
  ``_Large_DM_WHAM``, ``_Large_DM_WHAMR``, ``SepReformer_L``,
  ``SepReformer_Base_Libri2Mix``) equals the JAX preset of the same name
  on every field the port's dataclasses have.
- Head width 32 (F=64 in two heads) through one global attention on each
  eval route the Large model takes: K2's plain version against the
  Pallas ``materialize_pos_kt`` in interpret mode (bit-equal), then the
  K2/K3 route (the port's default at this length) against the flax block
  on ``attention_impl="fused_pv_interpret"`` with the Pallas pos_kt, and
  the K12 route (the port's switch ``blocks.FUSED_PV_MAX_LENGTH`` at 0)
  against it on ``"pallas_interpret"``, the Pallas kernels in interpret
  mode as the JAX package's own tests run them; with and without key
  lengths, maxlen 24 < L 40 so that the rel-pos clamp acts, at the
  module tests' bar (rtol 1e-4, atol 1e-5).
- ``tests/test_torch_large_split.py`` holds the whole forward of a
  two-stage model with Large's head width and ``per_stage_spk_split``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu import config as jax_config
from sepreformer_tpu.models import blocks as jb
from sepreformer_tpu.ops.pallas.relpos import (
    materialize_pos_kt as jax_materialize_pos_kt,
)
from sepreformer_torch import get_variant
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import convert
from sepreformer_torch.ops.kernels import materialize_pos_kt_plain, pos_kt

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_modules import boost_layer_scale, load_port

NEW_PRESETS = ("SepReformer_Large_DM_WSJ0", "SepReformer_Large_DM_WHAM",
               "SepReformer_Large_DM_WHAMR", "SepReformer_L",
               "SepReformer_Base_Libri2Mix")
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


def assert_fields_equal(port, ref, where):
    """Every field of the port's dataclass ``port`` equals ``ref``'s."""
    for field in dataclasses.fields(port):
        a, b = getattr(port, field.name), getattr(ref, field.name)
        name = f"{where}.{field.name}"
        if dataclasses.is_dataclass(a):
            assert_fields_equal(a, b, name)
        else:
            assert a == (tuple(b) if isinstance(b, list) else b), name


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_matches_jax(name):
    port, ref = get_variant(name), jax_config.get_variant(name)
    assert_fields_equal(port, ref, name)


def test_large_presets_are_large():
    """F=256 in 8 heads of 32 (the widths K1, K3 and K12 are built for),
    and only ``Large_DM_WHAM`` splits per stage."""
    for name in NEW_PRESETS[:4]:
        model = get_variant(name).model
        assert (model.feat_dim, model.num_heads, model.head_dim) == (256, 8,
                                                                     32)
        assert model.per_stage_spk_split == (name.endswith("WHAM"))


def test_pos_kt_at_head_width_32_matches_pallas():
    """K2's plain version at d 32 is the Pallas materializer's copy, at the
    route's padded length and with the clamp acting."""
    table = np.random.default_rng(2).normal(size=(48, 32)).astype(np.float32)
    ref = jax_materialize_pos_kt(jnp.asarray(table), 128, 24, True)
    got = materialize_pos_kt_plain(torch.from_numpy(table), 128, 24)
    assert got.shape == (128, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lens", [None, (40, 23)])
@pytest.mark.parametrize("route", ["fused_pv", "flash"])
def test_head_width_32_attention_matches_flax(route, lens, monkeypatch):
    """One eval attention at head width 32 on the port's K2/K3 route (its
    "auto" at L 40) or K12 route (switch at 0), against the flax block on
    the Pallas kernels in interpret mode."""
    if route == "flash":
        monkeypatch.setattr(tb, "FUSED_PV_MAX_LENGTH", 0)
    f, h, t, maxlen = 64, 2, 40, 24
    assert tb.attention_route("auto", "auto", t, None,
                              lens is not None) == route
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    table = rng.normal(size=(2 * maxlen, f // h)).astype(np.float32)
    jtable = jnp.asarray(table)
    if route == "fused_pv":
        jpos = jb.RelPos(table=jtable, length=t, maxlen=maxlen,
                         impl="fused_pv_interpret",
                         pos_kt=jax_materialize_pos_kt(jtable, 128, maxlen,
                                                       True))
    else:
        jpos = jb.RelPos(table=jtable, length=t, maxlen=maxlen,
                         impl="pallas_interpret", pos_kt=None)
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(3), jnp.asarray(x), jpos)["params"])
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = model.apply({"params": params}, jnp.asarray(x), jpos, key_lens=jl)

    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    ttable = torch.from_numpy(table)
    tpos = tb.RelPos(length=t, table=ttable, maxlen=maxlen,
                     pos_kt=(pos_kt(ttable, 128, maxlen)
                             if route == "fused_pv" else None))
    tl = None if lens is None else torch.tensor(lens)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), tpos, key_lens=tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODULE_TOL)
