"""One whole train step in bfloat16: the port against the JAX package's
``make_train_step`` with ``compute_dtype="bfloat16"`` and against its
float32 step, on the CPU.

The configuration is ``tests/test_torch_train_step.py``'s (one stage,
F=16, two heads, k9, T=2000, dropout 0, every LayerScale at 0.5), on the
same weights and batch.  Both packages run the stream in bfloat16 with
float32 parameters, norms, softmaxes and losses, but not with the same
rounding points: on the CPU the JAX package takes its modules' plain
composition (each module's output and each cotangent rounded to
bfloat16, the dense attention), where the port takes the JAX kernels'
steps (K7/K8 and K9/K10 keep u, y, e and the sums in float32).  So the
two bfloat16 steps are as far from each other as each is from float32:
their forwards' audio differs by 1.6e-2 of max|audio| (each 1.3e-2 and
1.4e-2 from float32), their gradients by 0.111 of the largest gradient,
and the port's float32 step reads 0.093 from JAX's bfloat16 one, so no
gradient limit between the two bfloat16 steps can tell a float32
control apart.  What holds, and is checked:
- the losses of the two bfloat16 steps agree within ``LOSS_RTOL``
  (readings: 6.0e-3 time loss, 4.3e-3 total, 1.6e-4 magnitude loss);
- the port's bfloat16 gradients lie within ``GRAD_LIMIT`` of the
  largest gradient of JAX's float32 step (reading 2.8e-2; JAX's own
  bfloat16 step reads 9.0e-2 on the same measure), and farther than
  float32's bar (``F32_BAR``: the float32 step reads 3.7e-6), which
  shows that the stream is bfloat16.

The JAX steps take about two minutes to trace and compile on this CPU,
so the file is marked ``slow`` (run by hand:
``JAX_PLATFORMS=cpu python -m pytest -m slow -n 0 -s
tests/test_torch_bf16_train_step.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.config import OptimConfig as JaxOptimConfig
from sepreformer_tpu.config import VariantConfig as JaxVariantConfig
from sepreformer_tpu.engine.train import TrainState as JaxTrainState
from sepreformer_tpu.engine.train import make_optimizer as jax_make_optimizer
from sepreformer_tpu.engine.train import make_train_step
from sepreformer_torch.config import ModelConfig, VariantConfig
from sepreformer_torch.engine import create_train_state, train_step
from sepreformer_torch.models import from_jax_params
from test_torch_train import STEP_MODEL, boosted_model, port_layout, to_flax

pytestmark = pytest.mark.slow

LOSS_RTOL = 1e-2     # |port - JAX| / |JAX| of each loss, both bfloat16
GRAD_LIMIT = 5e-2    # max |port bf16 - JAX f32| of a gradient over the
                     # largest
F32_BAR = 1e-3       # the same of a float32 step stays under this


@pytest.fixture(scope="module")
def steps():
    """JAX's bfloat16 and float32 steps and the port's bfloat16 step from
    the same weights and batch: metrics, and the gradients before the
    clip in the port's layout."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(2, 2000)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, 2000)).astype(np.float32)
    cfg = ModelConfig(**dict(STEP_MODEL, compute_dtype="bfloat16"))
    model = boosted_model(cfg, seed=0)
    sd = model.state_dict()
    params = to_flax(sd, cfg)
    stats = to_flax(sd, cfg, "batch_stats")

    def jax_step(dtype):
        jcfg = JaxVariantConfig(
            name="step", model=JaxModelConfig(**dict(STEP_MODEL,
                                                     compute_dtype=dtype)),
            optim=JaxOptimConfig(lr=1e-3))
        jstate = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jax_make_optimizer(jcfg).init(params))
        _, jm = make_train_step(jcfg, donate=False, debug_grads=True)(
            jstate, jnp.asarray(x), jnp.asarray(s), jnp.float32(1e-3),
            jnp.float32(0.4), jax.random.key(1))
        grads = port_layout(jax.tree.map(np.asarray, jm["grads"]), cfg)
        return {k: float(v) for k, v in jm.items() if k != "grads"}, grads

    state = create_train_state(
        VariantConfig("step", model=cfg),
        model=from_jax_params(params, stats, cfg, device="cpu"))
    grads = {}
    for name, prm in state.model.named_parameters():
        prm.register_hook(
            lambda g, name=name: grads.__setitem__(name, g.clone()))
    metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(s),
                         1e-3, 0.4, torch.Generator().manual_seed(1))
    port = ({k: float(v) for k, v in metrics.items()},
            {k: g.numpy() for k, g in grads.items()}, grads)
    return jax_step("bfloat16"), jax_step("float32"), port


def grad_distance(grads, ref):
    """max over parameters of max |grads - ref| over the largest |ref|."""
    assert set(grads) == set(ref)
    top = max(np.abs(g).max() for g in ref.values())
    return max(np.abs(grads[k] - g).max() for k, g in ref.items()) / top


def test_bf16_step_losses_match_jax_bf16(steps):
    (jm, _), _, (metrics, _, _) = steps
    for name in ("total_loss", "time_loss", "mag_loss_0", "mag_loss_mean"):
        np.testing.assert_allclose(metrics[name], jm[name], rtol=LOSS_RTOL,
                                   err_msg=name)


def test_bf16_step_gradients_near_float32(steps):
    """Every gradient float32; the port's bfloat16 gradients within
    ``GRAD_LIMIT`` of JAX's float32 step and farther than ``F32_BAR``."""
    (_, jgrads16), (_, jgrads32), (_, grads, tensors) = steps
    assert all(g.dtype == torch.float32 for g in tensors.values())
    dist = grad_distance(grads, jgrads32)
    print(f"port bf16 vs JAX f32: {dist:.3e} of the largest gradient; "
          f"JAX bf16 vs JAX f32 {grad_distance(jgrads16, jgrads32):.3e}; "
          f"port bf16 vs JAX bf16 {grad_distance(grads, jgrads16):.3e}")
    assert F32_BAR < dist <= GRAD_LIMIT
