"""The T and M presets' widths against the JAX package on the CPU, as
``tests/test_torch_tsm_slice.py`` holds S's: a one-stage model at
``SepReformer_T``'s widths (F 64, heads of 8) and at ``SepReformer_M``'s
(F 160, heads of 20), its whole eval forward against the JAX forward with
and without ``lengths`` at the parity bar (rtol 1e-3, atol 1e-4); and the
flax trees of each preset at full width and depth with the leaves and
shapes of the JAX model's ``init``.  Marked ``slow`` (JAX traces and
compiles each model; about 30 s alone): run by hand with
``JAX_PLATFORMS=cpu python -m pytest -m slow -n 0
tests/test_torch_tsm_slow.py``.
"""

import pytest
import torch

from sepreformer_torch import build_model, get_variant

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_slice import flax_trees
from test_torch_tsm import check_jax_shapes
from test_torch_tsm_slice import check_forward, one_stage

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", params=["SepReformer_T", "SepReformer_M"])
def models(request):
    return one_stage(request.param)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(models, masked):
    check_forward(models, masked)


@pytest.mark.parametrize("name", ["SepReformer_T", "SepReformer_M"])
def test_flax_trees_have_the_jax_shapes(name):
    cfg = get_variant(name).model
    params, stats = flax_trees(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3)), cfg)
    check_jax_shapes(cfg, params, stats)
