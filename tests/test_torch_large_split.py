"""``per_stage_spk_split`` against the JAX package on the CPU.

``SepReformer_Large_DM_WHAM`` splits the speakers with one block per
encoder stage and one at the bottleneck (its reference module.py:181-
184) instead of one shared block.  A narrow model with Large's head width
(two stages, F=64, two heads of 32) gets seeded weights written out as
flax trees (every LayerScale at 0.5, so that the branches show) and
carried into the port by ``from_jax_params``; both packages run the same
numpy-seeded waveforms through the eval forward, with and without true
``lengths``, and the separated audio and the aux outputs must agree at
the parity bar (rtol 1e-3, atol 1e-4).  The mapping table names the
blocks as the JAX converter does (``separator.spk_split_block.{s}``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu import config as jax_config
from sepreformer_tpu.models import SepReformer as JaxSepReformer
from sepreformer_torch import build_model
from sepreformer_torch.config import ModelConfig
from sepreformer_torch.models import from_jax_params
from sepreformer_torch.models.convert import jax_state_dict

from test_torch_slice import PARITY, flax_trees

NARROW = dict(num_stages=2, num_spks=2, enc_dim=16, enc_kernel=16,
              enc_stride=4, feat_dim=64, num_heads=2, pos_maxlen=32,
              local_kernel=9, down_kernel=5)
T = 800                  # 197 frames, padded to 200: bottleneck length 50
LENGTHS = (800, 613)


@pytest.fixture(scope="module")
def models():
    cfg = ModelConfig(**NARROW, per_stage_spk_split=True)
    jcfg = jax_config.ModelConfig(**NARROW, dropout=0.0,
                                  per_stage_spk_split=True)
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    port = from_jax_params(params, stats, cfg, device="cpu")
    return (JaxSepReformer(jcfg), {"params": params, "batch_stats": stats},
            port, cfg)


@pytest.mark.parametrize("masked", [False, True])
def test_per_stage_spk_split_matches_jax(models, masked):
    jmodel, variables, port, _ = models
    x = np.random.default_rng(7).normal(size=(2, T)).astype(np.float32)
    lengths = np.asarray(LENGTHS) if masked else None
    ref_audio, ref_aux = jax.jit(jmodel.apply)(
        variables, jnp.asarray(x),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32))
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x), None if lengths is None
                          else torch.from_numpy(lengths))
    assert audio.shape == ref_audio.shape == (2, 2, T)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), **PARITY)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), **PARITY)


def test_per_stage_spk_split_weights(models):
    """num_stages + 1 blocks under the JAX converter's names, each with its
    own weights; the table names every weight of the port."""
    _, variables, port, cfg = models
    sd = jax_state_dict(variables["params"], variables["batch_stats"], cfg)
    assert set(sd) == set(port.state_dict())
    assert len(port.separator.spk_split_block) == cfg.num_stages + 1
    keys = [f"separator.spk_split_block.{s}.linear.0.weight"
            for s in range(cfg.num_stages + 1)]
    assert all(k in sd for k in keys)
    assert not torch.equal(sd[keys[0]], sd[keys[-1]])
