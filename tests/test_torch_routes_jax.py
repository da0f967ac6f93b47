"""The port's train step on the JAX package's other train routes against
the JAX package on the CPU: one whole step (one stage, F=16, dropout 0)
with ``attention_train_impl="pallas"`` and the depthwise module's
``BWD_MODE = "conv"`` against the JAX package's ``make_train_step`` with
"pallas_interpret" and "conv", at ``test_torch_train_step.py``'s bars
(metrics, every gradient, the BatchNorm statistics).  Weights and inputs
come from numpy seeds, with every LayerScale at 0.5.  (The "single" eval
forward against JAX's is in ``test_torch_routes.py``.)
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sepreformer_tpu.ops.pallas.depthwise as jax_depthwise
from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.config import OptimConfig as JaxOptimConfig
from sepreformer_tpu.config import VariantConfig as JaxVariantConfig
from sepreformer_tpu.engine.train import TrainState as JaxTrainState
from sepreformer_tpu.engine.train import make_optimizer as jax_make_optimizer
from sepreformer_tpu.engine.train import make_train_step
from sepreformer_torch.config import ModelConfig, VariantConfig
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import from_jax_params
from sepreformer_torch.ops.kernels import depthwise as port_depthwise
from test_torch_routes import spy
from test_torch_train import STEP_MODEL, boosted_model, port_layout, to_flax


@contextlib.contextmanager
def conv_mode():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_depthwise, "BWD_MODE", "conv")
        m.setattr(port_depthwise, "BWD_MODE", "conv")
        yield


@pytest.fixture(scope="module")
def step_case():
    """One train step of each package from the same weights and batch,
    on the "pallas" train attention and the "conv" depthwise backward.
    (At F=16 the CLA's conv has 32 channels, under the JAX kernel's
    C % 128 rule, so JAX takes XLA's gradient there; the conv route's own
    parity with JAX's is ``test_torch_depthwise_w.py``'s.)"""
    cfg = VariantConfig("step", model=ModelConfig(
        **STEP_MODEL, attention_train_impl="pallas"))
    jcfg = JaxVariantConfig(name="step", model=JaxModelConfig(
        **STEP_MODEL, attention_train_impl="pallas_interpret"),
        optim=JaxOptimConfig(lr=1e-3))
    model = boosted_model(cfg.model, seed=0)
    sd = model.state_dict()
    params = to_flax(sd, cfg.model)
    stats = to_flax(sd, cfg.model, "batch_stats")
    t = 2000
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(2, t)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, t)).astype(np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # see test_torch_engine.py
    calls = []
    try:
        with conv_mode(), pytest.MonkeyPatch.context() as m:
            jstate = JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=params,
                batch_stats=stats,
                opt_state=jax_make_optimizer(jcfg).init(params))
            new_jstate, jm = make_train_step(
                jcfg, donate=False, debug_grads=True)(
                jstate, jnp.asarray(x), jnp.asarray(s), jnp.float32(1e-3),
                jnp.float32(0.4), jax.random.key(1))
            state = create_train_state(cfg, model=from_jax_params(
                params, stats, cfg.model, device="cpu"))
            spy(m, tb, "flash_relpos_attention_train", calls)
            spy(m, port_depthwise, "depthwise_bwd_w", calls)
            metrics = train_step(state, torch.from_numpy(x),
                                 torch.from_numpy(s), 1e-3, 0.4,
                                 torch.Generator().manual_seed(1))
    finally:
        torch.set_num_threads(threads)
    return cfg, state, metrics, new_jstate, jm, calls


def test_pallas_conv_train_step_takes_its_routes(step_case):
    calls = step_case[5]
    # one stage: 2 + 2 + 3 global attentions, as many CLAs
    assert calls.count("flash_relpos_attention_train") == 7
    assert calls.count("depthwise_bwd_w") == 7


def test_pallas_conv_train_step_metrics_match_jax(step_case):
    _, _, metrics, _, jm, _ = step_case
    for name in ("total_loss", "time_loss", "mag_loss_0", "mag_loss_mean",
                 "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)


def test_pallas_conv_train_step_gradients_match_jax(step_case):
    """Every gradient, the rel-pos table's included, at the JAX package's
    bar (rtol 2e-3, atol 1e-5 x the gradient norm), after the clip."""
    cfg, state, _, _, jm, _ = step_case
    norm = float(jm["grad_norm"])
    clip = min(1.0, cfg.optim.clip_norm / norm)
    ref = port_layout(jax.tree.map(np.asarray, jm["grads"]), cfg.model)
    named = dict(state.model.named_parameters())
    assert set(ref) == set(named)
    for key, g in ref.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g * clip,
                                   rtol=2e-3, atol=1e-5 * norm * clip,
                                   err_msg=key)


def test_pallas_conv_train_step_batch_statistics_match_jax(step_case):
    cfg, state, _, new_jstate, _, _ = step_case
    stats = to_flax(state.model.state_dict(), cfg.model, "batch_stats")
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, new_jstate.batch_stats))
    assert flat
    for path, value in flat:
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, value, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))
