"""The port's whole eval forward at the S preset's widths against the
JAX package on the CPU.

A one-stage model at ``SepReformer_S``'s widths (F 96 in 8 heads of 12,
enc_dim 256, the k65 local blocks, maxlen 2000) has seeded weights
written out as flax trees; ``from_jax_params`` loads them into a second
port model, and both packages run the same numpy-seeded waveforms, with
and without true ``lengths``: the separated audio and the per-stage aux
outputs agree at the repo's parity bar (rtol 1e-3, atol 1e-4), as
``tests/test_torch_slice.py`` holds Base's structure.  The port on the
CPU runs its kernels' plain versions on the K2/K3 route (the head width
12 that the card's K3 and K12 take on their padded plan), JAX its XLA
route.  T's and M's widths: ``tests/test_torch_tsm_slow.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_torch import build_model, get_variant
from sepreformer_torch.models import from_jax_params

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_slice import LENGTHS, PARITY, T, flax_trees
from test_torch_tsm import jax_model_config


def one_stage(name):
    """(JAX model, variables, port model) at preset ``name``'s widths, one
    stage deep, dropout 0, seeded weights with LayerScale 0.5."""
    cfg = dataclasses.replace(get_variant(name).model, num_stages=1,
                              dropout=0.0)
    params, stats = flax_trees(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7)), cfg)
    port = from_jax_params(params, stats, cfg, device="cpu")
    return (JaxSepReformer(jax_model_config(cfg)),
            {"params": params, "batch_stats": stats}, port)


def check_forward(models, masked):
    jmodel, variables, port = models
    x = np.random.default_rng(0).normal(size=(2, T)).astype(np.float32)
    lengths = np.asarray(LENGTHS) if masked else None
    ref_audio, ref_aux = jax.jit(jmodel.apply)(
        variables, jnp.asarray(x),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32))
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x), None if lengths is None
                          else torch.from_numpy(lengths))
    assert audio.shape == ref_audio.shape == (2, 2, T)
    assert aux.shape == ref_aux.shape == (1, 2, 2, T)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)


@pytest.fixture(scope="module")
def s_models():
    return one_stage("SepReformer_S")


@pytest.mark.parametrize("masked", [False, True])
def test_s_forward_matches_jax(s_models, masked):
    check_forward(s_models, masked)
