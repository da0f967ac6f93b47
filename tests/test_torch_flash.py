"""K12, the flash rel-pos attention, and the route that reaches it, against
the JAX package on the CPU.

- ``flash_relpos_attention_plain`` against the Pallas kernel
  ``_flash_relpos_attention_impl`` in interpret mode, at the bar of
  ``tests/test_pallas_attention.py`` (rtol 2e-5, atol 2e-5), with
  maxlen 64 so that the rel-pos clamp applies, with and without key
  lengths.
- One ``MultiHeadAttention`` in eval with the switch
  ``blocks.FUSED_PV_MAX_LENGTH`` at 0, so that it takes K12, against the
  flax block on its "pallas_interpret" path.
- The whole eval forward at the test width of ``test_torch_slice.py``
  with the switch at 0 against the JAX model with
  ``attention_impl="pallas_interpret"``, at the parity bar (rtol 1e-3,
  atol 1e-4), with and without lengths; no pos_kt is built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_tpu.models import blocks as jb
from sepreformer_tpu.ops.pallas.attention import _flash_relpos_attention_impl
from sepreformer_torch import build_model, get_variant
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import convert, from_jax_params
from sepreformer_torch.ops.kernels import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_modules import boost_layer_scale, load_port
from test_torch_slice import PARITY, T, flax_trees

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def to_heads(a, h):
    """[B, L, H*d] -> [B, H, L, d] (the Pallas kernel's layout)."""
    b, length, f = a.shape
    return a.reshape(b, length, h, f // h).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("length,block", [(200, None), (300, 128)])
def test_plain_matches_pallas_kernel(length, block, masked):
    """L 200 in one Pallas block, L 300 in three of 128; maxlen 64 < L, so
    most pairs clamp; the masked case has a row at 57 of 300 keys."""
    b, h, d, maxlen = 2, 2, 16, 64
    rng = np.random.default_rng(length)
    q, k, v = (rng.normal(size=(b, length, h * d)).astype(np.float32)
               for _ in range(3))
    table = rng.normal(size=(2 * maxlen, d)).astype(np.float32)
    lens = np.array([length, length * 19 // 100], np.int32) if masked else None
    ref = _flash_relpos_attention_impl(
        *(jnp.asarray(to_heads(a, h)) for a in (q, k, v)), jnp.asarray(table),
        maxlen, interpret=True, block=block,
        lens=None if lens is None else jnp.asarray(lens))
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, length, h * d)
    args = [torch.from_numpy(a) for a in (q, k, v, table)]
    tl = None if lens is None else torch.from_numpy(lens)
    got = flash_relpos_attention_plain(*args, maxlen, tl, block=64)
    np.testing.assert_allclose(got.numpy(), ref, **KERNEL_TOL)
    before = flash_relpos_attention.launches
    wrapped = flash_relpos_attention(*args, maxlen, tl)
    assert flash_relpos_attention.launches == before   # CPU: no kernel
    np.testing.assert_allclose(wrapped.numpy(), ref, **KERNEL_TOL)


@pytest.mark.parametrize("lens", [None, (40, 23)])
def test_mha_flash_route_matches_flax(lens, monkeypatch):
    """With the switch at 0 the port's block attends through K12's plain
    version on the raw table; the flax block through its Pallas kernel."""
    monkeypatch.setattr(tb, "FUSED_PV_MAX_LENGTH", 0)
    f, h, t, maxlen = 32, 2, 40, 24
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, t, f)).astype(np.float32)
    table = rng.normal(size=(2 * maxlen, f // h)).astype(np.float32)
    pos = jb.RelPos(table=jnp.asarray(table), length=t, maxlen=maxlen,
                    impl="pallas_interpret", pos_kt=None)
    model = jb.MultiHeadAttention(f, h, 0.0)
    params = boost_layer_scale(
        model.init(jax.random.key(1), jnp.asarray(x), pos)["params"])
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = model.apply({"params": params}, jnp.asarray(x), pos, key_lens=jl)

    port = load_port(tb.MultiHeadAttention(f, h), convert._mha, params)
    tpos = tb.RelPos(length=t, pos_kt=None, table=torch.from_numpy(table),
                     maxlen=maxlen)
    tl = None if lens is None else torch.tensor(lens)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), tpos, key_lens=tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_pos_kt_only_where_read(monkeypatch):
    """Past the switch the eval encoding builds no pos_kt; train, and eval
    at or below the switch, build it."""
    module = get_variant("tiny").model
    port = build_model(module, device="cpu").separator.pos_emb
    assert port(40).pos_kt.shape == (128, 8, 128)
    monkeypatch.setattr(tb, "FUSED_PV_MAX_LENGTH", 39)
    assert port(40).pos_kt is None
    assert port(39).pos_kt is not None
    assert port(40, train=True).pos_kt is not None
    assert port(40).table is port.pe_k.weight and port(40).maxlen == 64


@pytest.fixture(scope="module")
def models():
    cfg = get_variant("tiny").model
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, attention_impl="pallas_interpret")
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    port = from_jax_params(params, stats, cfg, device="cpu")
    variables = {"params": params, "batch_stats": stats}
    return JaxSepReformer(jcfg), variables, port


@pytest.mark.parametrize("masked", [False, True])
def test_forward_through_flash_matches_jax(models, masked, monkeypatch):
    monkeypatch.setattr(tb, "FUSED_PV_MAX_LENGTH", 0)
    jmodel, variables, port = models
    x = np.random.default_rng(3).normal(size=(2, T)).astype(np.float32)
    lengths = np.array([T, 555]) if masked else None
    ref_audio, ref_aux = jax.jit(jmodel.apply)(
        variables, jnp.asarray(x),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32))
    built = []
    hook = port.separator.pos_emb.register_forward_hook(
        lambda module, args, out: built.append(out.pos_kt))
    try:
        with torch.inference_mode():
            audio, aux = port(torch.from_numpy(x), None if lengths is None
                              else torch.from_numpy(lengths))
    finally:
        hook.remove()
    assert built == [None]
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)
