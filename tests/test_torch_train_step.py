"""The port's whole train step against the JAX package on the CPU, and
the step's own rules: dropout follows the caller's generator, and the
train path reaches no eval kernel (K1 and K3 have no backward).

The JAX package's ``make_train_step(..., debug_grads=True)`` runs at the
configuration of its own ``tests/test_pallas_softmax_pv_train.py`` (one
stage, F=16, two heads, k9, T=2000, dropout 0) on the same weights and
batch as the port, with every LayerScale at 0.5 so that each branch
carries gradient.  Weights and inputs come from numpy seeds.
"""

import dataclasses

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
from sepreformer_torch.config import ModelConfig, OptimConfig, VariantConfig
from sepreformer_torch.engine import create_train_state, eval_step, train_step
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import build_model, from_jax_params
from test_torch_train import (
    STEP_MODEL,
    boosted_model,
    port_layout,
    to_flax,
)


@pytest.fixture(scope="module")
def step_case():
    """One train step of the port and of the JAX package from the same
    weights and batch."""
    cfg = VariantConfig("step", model=ModelConfig(**STEP_MODEL))
    jcfg = JaxVariantConfig(name="step",
                            model=JaxModelConfig(**STEP_MODEL),
                            optim=JaxOptimConfig(lr=1e-3))
    model = boosted_model(cfg.model, seed=0)
    sd = model.state_dict()
    params = to_flax(sd, cfg.model)
    stats = to_flax(sd, cfg.model, "batch_stats")
    t = 2000
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.1, size=(2, t)).astype(np.float32)
    s = rng.normal(scale=0.05, size=(2, 2, t)).astype(np.float32)

    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats,
                           opt_state=jax_make_optimizer(jcfg).init(params))
    new_jstate, jm = make_train_step(jcfg, donate=False, debug_grads=True)(
        jstate, jnp.asarray(x), jnp.asarray(s), jnp.float32(1e-3),
        jnp.float32(0.4), jax.random.key(1))

    state = create_train_state(
        cfg, model=from_jax_params(params, stats, cfg.model, device="cpu"))
    metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(s),
                         1e-3, 0.4, torch.Generator().manual_seed(1))
    return cfg, state, metrics, new_jstate, jm


def test_train_step_metrics_match_jax(step_case):
    _, _, metrics, _, jm = step_case
    names = {"total_loss", "time_loss", "mag_loss_0", "mag_loss_mean",
             "grad_norm"}
    assert set(metrics) == names
    for name in names:
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)


def test_train_step_gradients_match_jax(step_case):
    """Every parameter's gradient, at the JAX package's own bar (rtol 2e-3,
    atol 1e-5 x the gradient norm).  The port's gradients are read after
    the step's in-place clip, so the JAX gradients take the same clip."""
    cfg, state, _, _, jm = step_case
    norm = float(jm["grad_norm"])
    clip = min(1.0, cfg.optim.clip_norm / norm)
    ref = port_layout(jax.tree.map(np.asarray, jm["grads"]), cfg.model)
    named = dict(state.model.named_parameters())
    assert set(ref) == set(named)
    for key, g in ref.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g * clip,
                                   rtol=2e-3, atol=1e-5 * norm * clip,
                                   err_msg=key)


def test_train_step_batch_statistics_match_jax(step_case):
    cfg, state, _, new_jstate, _ = step_case
    sd = state.model.state_dict()
    stats = to_flax(sd, cfg.model, "batch_stats")
    ref = jax.tree.map(np.asarray, new_jstate.batch_stats)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert flat
    for path, value in flat:
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, value, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


def _tiny_step(seed, dropout=0.1):
    cfg = VariantConfig("tiny", model=dataclasses.replace(
        ModelConfig(**STEP_MODEL), dropout=dropout))
    state = create_train_state(cfg, model=build_model(
        cfg.model, device="cpu", generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.normal(scale=0.1, size=(2, 2, 1000)).astype(
        np.float32))
    return float(train_step(state, s.sum(0), s, 1e-3, 0.4,
                            torch.Generator().manual_seed(seed))[
        "total_loss"])


def test_dropout_follows_the_generator():
    """The same generator seed gives the same loss; another seed drops
    other elements and gives another loss."""
    assert _tiny_step(1) == _tiny_step(1)
    assert _tiny_step(1) != _tiny_step(2)
    assert _tiny_step(1, dropout=0.0) == _tiny_step(2, dropout=0.0)


def test_train_path_reaches_no_eval_kernel(monkeypatch):
    """K1 and K3 have no backward: the train step must not call them (on
    the card they raise under autograd).  The eval step does."""
    calls = []

    def refuse(name):
        def fn(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} called on the train path")
        return fn

    cfg = VariantConfig("tiny", model=ModelConfig(**STEP_MODEL))
    state = create_train_state(cfg, model=build_model(
        cfg.model, device="cpu", generator=torch.Generator().manual_seed(0)))
    s = torch.zeros(2, 2, 1000).normal_(
        generator=torch.Generator().manual_seed(3)) * 0.1
    with monkeypatch.context() as m:
        m.setattr(tb, "fused_gcfn", refuse("fused_gcfn"))
        m.setattr(tb, "softmax_pv", refuse("softmax_pv"))
        metrics = train_step(state, s.sum(0), s, 1e-3, 0.4,
                             torch.Generator().manual_seed(4))
    assert not calls and np.isfinite(float(metrics["total_loss"]))
    with monkeypatch.context() as m:
        m.setattr(tb, "fused_gcfn", refuse("fused_gcfn"))
        with pytest.raises(AssertionError):
            eval_step(state, s.sum(0), s)
    assert calls == ["fused_gcfn"]


def test_accum_steps_average_sequential_micro_batches():
    """``accum_steps`` 2 on a batch of two: the mean of the gradients and
    metrics of the two one-row steps taken in order, and BatchNorm's
    running statistics updated by each (lr 0 and no clip, so the one-row
    steps leave the weights as they are)."""
    cfg = VariantConfig("tiny", model=ModelConfig(**STEP_MODEL),
                        optim=OptimConfig(clip_norm=1e9))
    rng = np.random.default_rng(9)
    s = torch.from_numpy(rng.normal(scale=0.1, size=(2, 2, 1000)).astype(
        np.float32))

    def fresh(accum):
        c = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, accum_steps=accum))
        return create_train_state(c, model=build_model(
            c.model, device="cpu", generator=torch.Generator().manual_seed(0)))

    whole = fresh(2)
    got = train_step(whole, s.sum(0), s, 0.0, 0.4,
                     torch.Generator().manual_seed(0))
    rows = fresh(1)
    parts = []
    for b in range(2):
        m = train_step(rows, s[:, b].sum(0)[None], s[:, b:b + 1], 0.0, 0.4,
                       torch.Generator().manual_seed(0))
        parts.append((m, {n: p.grad.clone()
                          for n, p in rows.model.named_parameters()}))
    for name, value in got.items():
        if name != "grad_norm":
            torch.testing.assert_close(
                value, (parts[0][0][name] + parts[1][0][name]) / 2)
    for n, p in whole.model.named_parameters():
        torch.testing.assert_close(p.grad, (parts[0][1][n] + parts[1][1][n])
                                   / 2, rtol=1e-5, atol=1e-7, msg=n)
    for (n, a), (_, b) in zip(whole.model.named_buffers(),
                              rows.model.named_buffers()):
        torch.testing.assert_close(a, b, msg=n)
