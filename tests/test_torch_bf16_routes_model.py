"""The tiny model's bfloat16 forward off the default route, port against
the JAX package, on the CPU: ``attention_impl="single"`` (K13),
``fused_local="on"`` (K15) and ``fused_pair="on"`` (K16) together, against
the JAX package's jitted bfloat16 ``apply`` with ``single_interpret``,
``fused_local="interpret"`` and ``fused_pair="interpret"`` (its Pallas
kernels in interpret mode), at the same weights, every LayerScale at 0.5
and the BatchNorm statistics away from 0/1.  The tiny variant is cut to
one stage.  Marked ``slow`` (Tier-1 deselects it): the JAX program alone
takes 8 to 11 s to compile on this CPU, with or without the interpret
kernels, so the file cannot run in under 10 s; run it by hand with
``python -m pytest -m slow -n 0 -s tests/test_torch_bf16_routes_model.py``
(about 16 s).

The kernels' plain versions round where the Pallas kernels do
(``tests/test_torch_bf16_routes.py`` holds each to 2e-5 of max|out|),
but the plain modules between them do not: the JAX package's XLA
modules round each op's result to bfloat16, the port's modules follow
the JAX policy's casts.  So the model agrees to the bfloat16 limit of
``tests/test_torch_bf16.py``, ``JAX_LIMIT`` = 2e-2 of max|out|.
Readings: audio 1.38e-2, aux 1.06e-2; the default route, compared the
same way on the same weights, reads 1.59e-2 and 1.06e-2, so the routes
off it add no difference of their own.  The float32 control (the port's
float32 forward on the same routes against JAX's bfloat16 one) reads
1.17e-2 and 1.29e-2: at the model level the limit does not tell it
apart, for the reason above, and the test prints it without holding it.
Spies count the calls of the three kernels' wrappers that the routes
predict, each on a bfloat16 stream.
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
from test_torch_slice import flax_trees

# 600 samples: 147 frames, padded to 148; stage 0 (148) and the
# bottleneck (74) each take one block of the JAX kernels, and every
# attention's length is under K13's 512
SAMPLES = 600
# max |port - JAX| over max|out|, both bfloat16 streams (the docstring)
JAX_LIMIT = 2e-2

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as in test_torch_engine.py: beside the
    other test workers torch's own pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def models():
    """(JAX bf16 model, its variables, port bf16 model, port f32 model)
    on the same weights, every route off the default one."""
    tiny = get_variant("tiny").model
    cfg = dataclasses.replace(tiny, num_stages=1, attention_impl="single",
                              fused_local="on", fused_pair="on")
    jcfg = JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "num_stages", "num_spks", "enc_dim", "enc_kernel", "enc_stride",
        "feat_dim", "num_heads", "pos_maxlen", "local_kernel",
        "down_kernel")}, dropout=0.0, attention_impl="single_interpret",
        fused_local="interpret", fused_pair="interpret",
        compute_dtype="bfloat16")
    torch.manual_seed(27)
    params, stats = flax_trees(build_model(cfg, device="cpu"), cfg)
    rng = np.random.default_rng(28)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                 else rng.normal(size=v.shape) * 0.1).astype(np.float32)
                for k, v in tree.items()}

    stats = perturb(stats)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    port16 = from_jax_params(params, stats, cfg16, device="cpu")
    port32 = from_jax_params(params, stats, cfg, device="cpu")
    return (JaxSepReformer(jcfg), {"params": params, "batch_stats": stats},
            port16, port32)


def test_bf16_off_default_routes_match_jax(models, monkeypatch):
    jmodel, variables, port16, port32 = models
    x = np.random.default_rng(29).normal(size=(2, SAMPLES)).astype(
        np.float32)
    ref_audio, ref_aux = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    calls = {"flash_relpos_attention_train": 0, "fused_cla": 0,
             "fused_ega_tail_gcfn": 0}
    for name in calls:
        real = getattr(blocks, name)

        def counted(*args, real=real, name=name):
            assert args[0].dtype == torch.bfloat16, name
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(blocks, name, counted)
    with torch.inference_mode():
        audio, aux = port16(torch.from_numpy(x))
    # one stage: two LocalBlocks and two GlobalBlocks in the encoder stage,
    # three of each in the decoder stage, two at the bottleneck; every
    # GlobalBlock's attention on "single", as K16's pair needs the
    # attention's output
    assert calls == {"flash_relpos_attention_train": 7, "fused_cla": 7,
                     "fused_ega_tail_gcfn": 7}
    assert audio.dtype == aux.dtype == torch.float32
    monkeypatch.undo()
    with torch.inference_mode():
        audio32, aux32 = port32(torch.from_numpy(x))
    readings = [(rel(got.numpy(), ref), rel(f32.numpy(), ref))
                for got, f32, ref in ((audio, audio32, ref_audio),
                                      (aux, aux32, ref_aux))]
    print(f"max |port - JAX| / max|out| and the float32 control: "
          f"audio {readings[0]}, aux {readings[1]}")
    for err, _ in readings:
        assert err <= JAX_LIMIT, err
