"""Train-mode modules of the PyTorch port against the JAX package on the
CPU: BatchNorm on batch statistics with its running update, the STFT and
the uPIT losses with their gradients, and the optimizer (global-norm clip
+ AdamW) on the same gradients as optax.  Inputs and gradients come from
numpy seeds.  The whole train step is in ``test_torch_train_step.py``,
which shares this file's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from sepreformer_tpu import losses as jlosses
from sepreformer_tpu.config import ModelConfig as JaxModelConfig
from sepreformer_tpu.config import VariantConfig as JaxVariantConfig
from sepreformer_tpu.engine.train import make_optimizer as jax_make_optimizer
from sepreformer_tpu.models import blocks as jb
from sepreformer_tpu.ops import stft as jstft
from sepreformer_torch import losses
from sepreformer_torch.config import ModelConfig, VariantConfig
from sepreformer_torch.engine import apply_gradients, create_train_state
from sepreformer_torch.models import blocks as tb
from sepreformer_torch.models import build_model
from sepreformer_torch.models.convert import TO_TORCH, mapping_entries
from sepreformer_torch.ops import stft

# torch layout -> flax layout, the inverse of convert.TO_TORCH
TO_FLAX = {
    "identity": lambda a: a,
    "linear_w": lambda a: a.T,
    "conv1x1_w": lambda a: a[:, :, 0].T,
    "depthwise_w": lambda a: a.transpose(2, 1, 0),
    "enc_conv_w": lambda a: a[:, 0, :].T,
    "dec_conv_w": lambda a: a[:, 0, :],
    "layer_scale": lambda a: a.reshape(-1),
}
STEP_MODEL = dict(num_stages=1, num_spks=2, enc_dim=16, enc_kernel=16,
                  enc_stride=4, feat_dim=16, num_heads=2, pos_maxlen=64,
                  local_kernel=9, down_kernel=5, dropout=0.0)


def to_flax(arrays, cfg, collection="params"):
    """A flax tree of ``collection`` from port tensors keyed by
    state_dict name."""
    tree = {}
    for kind, coll, path, key in mapping_entries(cfg):
        if coll != collection:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(      # a copy, not a view of the tensor
            TO_FLAX[kind](arrays[key].detach().numpy()))
    return tree


def port_layout(tree, cfg):
    """The port's tensors keyed by state_dict name from a flax tree."""
    out = {}
    for kind, coll, path, key in mapping_entries(cfg):
        if coll != "params":
            continue
        node = tree
        for p in path:
            node = node[p]
        out[key] = TO_TORCH[kind](np.asarray(node))
    return out


def boosted_model(cfg, seed):
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
    return model


@pytest.mark.parametrize("flax_bn", ["FoldableBatchNorm", "BatchNorm"])
def test_batchnorm_train_matches_flax(flax_bn):
    """Batch statistics, the running update and the input gradient of the
    CLA's FoldableBatchNorm and the down-conv's flax BatchNorm."""
    c = 32
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 50, c)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=c).astype(np.float32)}
    if flax_bn == "FoldableBatchNorm":
        module = jb.FoldableBatchNorm(c, momentum=0.9, epsilon=1e-5)
        kw = dict(use_running_average=False)
    else:
        module = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=1e-5)
        kw = {}

    def run(xx):
        return module.apply({"params": params, "batch_stats": stats}, xx,
                            mutable=["batch_stats"], **kw)

    ref, new_stats = run(jnp.asarray(x))
    _, vjp = jax.vjp(lambda xx: run(xx)[0], jnp.asarray(x))
    dx_ref, = vjp(jnp.asarray(g))

    port = tb.BatchNorm(c, eps=1e-5)
    port.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"]),
        "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    gen = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt, tb.TrainMode(0.0, gen, gen))
    y.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), **tol)
    bs = new_stats["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(bs["mean"]), **tol)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(bs["var"]), **tol)


def test_stft_constants_match_jax():
    np.testing.assert_array_equal(stft.make_stft_kernel(512, 128),
                                  jstft.make_stft_kernel(512, 128))
    np.testing.assert_array_equal(stft.make_mel_filterbank(257),
                                  jstft.make_mel_filterbank(257))
    x = np.random.default_rng(4).normal(size=(3, 2000)).astype(np.float32)
    kernel = stft.make_stft_kernel(512, 128)
    ref = jstft.stft_magnitude(jnp.asarray(x), kernel, 128)
    got = stft.stft_magnitude(torch.from_numpy(x), torch.from_numpy(kernel),
                              128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("loss", ["time", "mag", "mag_mel"])
def test_losses_and_gradients_match_jax(loss):
    rng = np.random.default_rng(5)
    src = (rng.normal(size=(2, 2, 2000)) * 0.1).astype(np.float32)
    est = (src[::-1] + 0.05 * rng.normal(size=src.shape)).astype(np.float32)
    kernel = stft.make_stft_kernel(512, 128)
    mel = stft.make_mel_filterbank(257) if loss == "mag_mel" else None

    def jax_loss(e):
        if loss == "time":
            return jlosses.pit_sisnr_time(e, jnp.asarray(src), impl="xla")
        return jlosses.pit_sisnr_mag(e, jnp.asarray(src), kernel, 128,
                                     mel_fb=mel)

    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(est))
    e_t = torch.from_numpy(est.copy()).requires_grad_()
    if loss == "time":
        got = losses.pit_sisnr_time(e_t, torch.from_numpy(src))
    else:
        got = losses.pit_sisnr_mag(
            e_t, torch.from_numpy(src), torch.from_numpy(kernel), 128,
            mel_fb=None if mel is None else torch.from_numpy(mel))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(e_t.grad.numpy(), ref_grad, rtol=1e-3,
                               atol=1e-5 * np.abs(ref_grad).max())


def test_permutation_totals_and_alpha_match_jax():
    pair = np.random.default_rng(6).normal(size=(4, 3, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        losses._gather_perm_totals(torch.from_numpy(pair)).numpy(),
        np.asarray(jlosses._gather_perm_totals(jnp.asarray(pair))),
        rtol=1e-6)
    for epoch in (1, 100, 101, 105, 106, 150):
        assert losses.progressive_alpha(epoch) == jlosses.progressive_alpha(
            epoch)


def test_optimizer_matches_optax():
    """Global-norm clip + AdamW on the same numpy gradients for 3 steps (the
    first with a norm above the clip), apart from the model: Adam's first
    update is g/|g|, so a gradient difference near 0 would show as a full
    lr step.  The optax chain runs on the parameters raveled into one
    vector (its operations are elementwise or global norms), so that JAX
    compiles one shape and not one per tensor."""
    cfg = VariantConfig("opt", model=ModelConfig(**STEP_MODEL))
    jcfg = JaxVariantConfig(name="opt", model=JaxModelConfig(**STEP_MODEL))
    state = create_train_state(cfg, model=boosted_model(cfg.model, seed=2))
    named = dict(state.model.named_parameters())
    keys = sorted(named)

    def flat(arrays):
        return jnp.asarray(np.concatenate(
            [np.asarray(arrays[k], np.float32).reshape(-1) for k in keys]))

    params = flat({k: p.detach().numpy() for k, p in named.items()})
    tx = jax_make_optimizer(jcfg)
    opt_state = tx.init(params)
    rng = np.random.default_rng(7)
    for step, (lr, scale) in enumerate(((1e-3, 1.0), (5e-4, 0.003),
                                        (1e-3, 0.01))):
        grads = {k: (rng.normal(size=p.shape) * scale).astype(np.float32)
                 for k, p in named.items()}
        for k, p in named.items():
            p.grad = torch.tensor(grads[k])      # a copy: the clip is in place
        norm = float(apply_gradients(state, lr))
        jgrads = flat(grads)
        np.testing.assert_allclose(norm, float(optax.global_norm(jgrads)),
                                   rtol=1e-6)
        assert (norm > cfg.optim.clip_norm) == (step == 0)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, lr * updates)
    # rtol 1e-6; an element near 0 carries the float32 rounding of its
    # tensor's larger values, so atol is 1e-6 of the tensor's largest
    ref = np.asarray(params)
    start = 0
    for k in keys:
        got = named[k].detach().numpy().reshape(-1)
        want = ref[start:start + got.size]
        start += got.size
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
