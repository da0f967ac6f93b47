"""Large's widths on the fused block routes, on the CPU: a shallow model
with ``SepReformer_Large_DM_WSJ0``'s widths (F 256, 8 heads of 32, its
k65 CLA and its encoder) cut to one stage, with ``fused_local="on"`` and
``fused_pair="on"``, against the JAX package's forward with both on
"interpret" (its Pallas kernels in interpret mode) at the same weights,
LayerScale 0.5 and BatchNorm statistics away from 0/1.  Spies count the
calls of K15 and K16 that ``blocks.fused_route`` predicts; with ragged
lengths neither is called.
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
from sepreformer_torch.models import blocks, from_jax_params
from test_torch_fused_routes import PARITY, expected_calls, spy
from test_torch_slice import flax_trees

# 600 samples: 147 frames, padded to 148; stage 0 (148) and the
# bottleneck (74) each take one block of the JAX kernels
SAMPLES = 600


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as in test_torch_engine.py: beside the
    other test workers torch's own pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    large = get_variant("SepReformer_Large_DM_WSJ0").model
    cfg = dataclasses.replace(large, num_stages=1, fused_local="on",
                              fused_pair="on")
    assert (cfg.feat_dim, cfg.num_heads, cfg.head_dim,
            cfg.local_kernel) == (256, 8, 32, 65)
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, fused_local="interpret",
        fused_pair="interpret")
    torch.manual_seed(23)
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    rng = np.random.default_rng(24)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                 else rng.normal(size=v.shape) * 0.1).astype(np.float32)
                for k, v in tree.items()}

    stats = perturb(stats)
    port = from_jax_params(params, stats, cfg, device="cpu")
    return JaxSepReformer(jcfg), {"params": params, "batch_stats": stats}, \
        port, cfg


def test_large_width_forward_matches_jax(models, monkeypatch):
    jmodel, variables, port, cfg = models
    x = np.random.default_rng(25).normal(size=(2, SAMPLES)).astype(
        np.float32)
    ref_audio, ref_aux = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    calls = spy(monkeypatch)
    with torch.inference_mode():
        audio, aux = port(torch.from_numpy(x))
    frames = cfg.padded_frames((SAMPLES - cfg.enc_kernel) // cfg.enc_stride
                               + 1)
    assert frames == 148
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


def test_large_width_ragged_lengths_take_no_fused_block(models,
                                                       monkeypatch):
    _, _, port, _ = models
    x = np.random.default_rng(26).normal(size=(2, SAMPLES)).astype(
        np.float32)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        port(torch.from_numpy(x), torch.tensor([SAMPLES, 400]))
    assert calls == {"fused_cla": 0, "fused_ega_tail_gcfn": 0}
