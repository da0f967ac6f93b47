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

The JAX package can also run its Pallas kernels on the CPU, in
interpret mode (``fused_ffn``, ``fused_depthwise`` = "interpret",
``attention_train_impl`` = "fused_pv_interpret" or "pallas_interpret"),
and then rounds at the kernels' points, which are the port's.  Its GCFN
takes its train kernel (K7/K8) only at a dropout above 0: at 0 it takes
the eval kernel K1, whose VJP raises on a bfloat16 stream as K16's does
(``gcfn.py:414``, a bfloat16 cotangent for a float32 reference).  So
these steps run at dropout 0.1 with the kernels' hash masks on a fixed
seed in both packages (every kernel site draws 7) and the plain dropout
sites (flax's ``nn.Dropout``, the port's ``TrainMode.dropout``) off on
both sides, whose random streams differ.  Against those steps the port
is held per route (the default route: K7/K8, K5, K9/K10; the "pallas"
route: K7/K8, K5, K13/K14).  Readings (default, "pallas"): the total
losses 3.7e-4 and 4.2e-3 apart (the time loss 4.0e-4, 5.9e-3; the
magnitude loss 2.6e-4, 2.1e-4); the gradients 8.9e-2 and 8.5e-2 of the largest apart, where
JAX's plain-composition bfloat16 step (the control) reads 0.361 and
0.357.  By module: the GCFNs' (K7/K8) 1.14e-2, 1.27e-2; the attentions'
(K9/K10, K13/K14, and the speaker-axis ones) 1.14e-2, 1.30e-2; the
CLAs' (K5 and plain modules) 1.6e-2, 2.6e-2; the 27 parameters of the
plain modules away from every kernel (the encoder, the speaker split,
the fusions, the output layer and decoder) 8.9e-2, 8.5e-2, the largest
the speaker split's last bias.  Those are bfloat16 rounding in plain
modules, not in the kernels: against JAX's float32 step on the same
kernels and masks the port's bfloat16 step reads 7.4e-2 and 4.3e-2 and
JAX's own bfloat16 step 5.4e-2 and 9.3e-2, on the same parameters, and
the two bfloat16 forwards' audio is 1.7e-2 of max|audio| apart on both
routes, each 1.2e-2 to 1.5e-2 from float32.  So the whole-step limits
of 2e-2 (gradients) and 2e-3 (losses) hold for the kernels' modules and
for the default route's losses, not for the whole step; what is held:
the GCFNs' and attentions' gradients within ``KERNEL_GRAD_LIMIT``, every
gradient within ``STEP_GRAD_LIMIT`` and under a third of the control's
distance, the losses within ``LOSS_RTOL``.

The JAX steps take about two minutes each to trace and compile on this
CPU, so the file is marked ``slow`` (run by hand:
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
# the port's bfloat16 step against JAX's on its interpret-mode kernels:
# the gradients of the modules that run the kernels (the GCFNs', the
# attentions'), and every gradient (the docstring)
KERNEL_GRAD_LIMIT = 2e-2
STEP_GRAD_LIMIT = 0.1
# the JAX package's kernel selectors that round where the port's kernels
# do, by the port's train route
INTERPRET = {"default": dict(fused_ffn="interpret",
                             fused_depthwise="interpret",
                             attention_train_impl="fused_pv_interpret"),
             "pallas": dict(fused_ffn="interpret",
                            fused_depthwise="interpret",
                            attention_train_impl="pallas_interpret")}
PORT_ROUTE = {"default": {}, "pallas": dict(attention_train_impl="pallas")}


@pytest.fixture(scope="module")
def runner():
    """(jax_step, port_step) on the same weights and batch: each returns
    the metrics and the gradients before the clip in the port's layout
    (the port's also as tensors), JAX's for a compute dtype and model
    fields, the port's (bfloat16) for model fields."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(2, 2000)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, 2000)).astype(np.float32)
    cfg = ModelConfig(**dict(STEP_MODEL, compute_dtype="bfloat16"))
    model = boosted_model(cfg, seed=0)
    sd = model.state_dict()
    params = to_flax(sd, cfg)
    stats = to_flax(sd, cfg, "batch_stats")

    def jax_step(dtype, **fields):
        # (the kernel sites' seeds and the plain dropout sites as the
        # caller patches them)
        jcfg = JaxVariantConfig(
            name="step", model=JaxModelConfig(**dict(
                STEP_MODEL, compute_dtype=dtype, **fields)),
            optim=JaxOptimConfig(lr=1e-3))
        jstate = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jax_make_optimizer(jcfg).init(params))
        _, jm = make_train_step(jcfg, donate=False, debug_grads=True)(
            jstate, jnp.asarray(x), jnp.asarray(s), jnp.float32(1e-3),
            jnp.float32(0.4), jax.random.key(1))
        grads = port_layout(jax.tree.map(np.asarray, jm["grads"]), cfg)
        return {k: float(v) for k, v in jm.items() if k != "grads"}, grads

    def port_step(**fields):
        pcfg = ModelConfig(**dict(STEP_MODEL, compute_dtype="bfloat16",
                                  **fields))
        state = create_train_state(
            VariantConfig("step", model=pcfg),
            model=from_jax_params(params, stats, pcfg, device="cpu"))
        grads = {}
        for name, prm in state.model.named_parameters():
            prm.register_hook(
                lambda g, name=name: grads.__setitem__(name, g.clone()))
        metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(s),
                             1e-3, 0.4, torch.Generator().manual_seed(1))
        return ({k: float(v) for k, v in metrics.items()},
                {k: g.numpy() for k, g in grads.items()}, grads)

    return jax_step, port_step


@pytest.fixture(scope="module")
def steps(runner):
    """JAX's bfloat16 and float32 steps (its plain composition) and the
    port's bfloat16 step on the default route."""
    jax_step, port_step = runner
    return jax_step("bfloat16"), jax_step("float32"), port_step()


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


KERNEL_DROPOUT = 0.1
KERNEL_SEED = 7


@pytest.fixture
def kernel_masks(monkeypatch):
    """Both packages' kernel sites on one fixed hash seed, and their plain
    dropout sites off (the module docstring says why)."""
    import flax.linen as nn

    from sepreformer_torch.models.blocks import TrainMode

    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.int32(KERNEL_SEED))
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(TrainMode, "kernel_seed", lambda self: KERNEL_SEED)
    monkeypatch.setattr(TrainMode, "dropout", lambda self, x: x)


@pytest.fixture(scope="module")
def control(runner):
    """JAX's plain-composition bfloat16 step at ``KERNEL_DROPOUT`` with
    its plain dropout sites off (no kernel site)."""
    import flax.linen as nn

    jax_step, _ = runner
    saved = nn.Dropout.__call__
    nn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    try:
        return jax_step("bfloat16", dropout=KERNEL_DROPOUT)
    finally:
        nn.Dropout.__call__ = saved


@pytest.mark.parametrize("route", sorted(INTERPRET))
def test_bf16_step_matches_jax_kernels(runner, control, kernel_masks,
                                       route):
    """The port's bfloat16 step on ``route`` against JAX's bfloat16 step on
    its kernels in interpret mode (``INTERPRET[route]``), which round
    where the port's kernels do, both at ``KERNEL_DROPOUT`` with the
    masks of ``kernel_masks``: each loss within ``LOSS_RTOL``, the
    GCFNs' and attentions' gradients within ``KERNEL_GRAD_LIMIT`` of the
    largest, every gradient within ``STEP_GRAD_LIMIT`` and under a third
    of the distance of JAX's plain-composition bfloat16 step (the
    control) from the same reference."""
    jax_step, port_step = runner
    _, control = control
    jm, jgrads = jax_step("bfloat16", dropout=KERNEL_DROPOUT,
                          **INTERPRET[route])
    metrics, grads, tensors = port_step(dropout=KERNEL_DROPOUT,
                                        **PORT_ROUTE[route])
    assert all(g.dtype == torch.float32 for g in tensors.values())
    losses = {name: abs(metrics[name] - jm[name]) / abs(jm[name])
              for name in ("total_loss", "time_loss", "mag_loss_0",
                           "mag_loss_mean")}
    dist, ctl = grad_distance(grads, jgrads), grad_distance(control, jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    kernel_modules = max(
        np.abs(grads[k] - g).max() for k, g in jgrads.items()
        if ".gcfn." in k or "feed_forward" in k or "self_attn" in k
        or ".ega." in k) / top
    print(f"{route}: port bf16 vs JAX bf16 on its kernels: losses "
          f"{ {k: f'{v:.2e}' for k, v in losses.items()} }, gradients "
          f"{dist:.3e} of the largest (the GCFNs' and attentions' "
          f"{kernel_modules:.3e}); JAX's plain composition (control) "
          f"{ctl:.3e}")
    assert all(v <= LOSS_RTOL for v in losses.values()), losses
    assert kernel_modules <= KERNEL_GRAD_LIMIT, kernel_modules
    assert dist <= STEP_GRAD_LIMIT and 3 * dist < ctl, (dist, ctl)
