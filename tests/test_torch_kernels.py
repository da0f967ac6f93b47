"""Kernels of the PyTorch port: K1 GCFN, K2 rel-pos materializer, K3
masked softmax·V.

On the CPU each plain version is held against the JAX package's Pallas
kernel run in interpret mode, on the same numpy-seeded inputs.  The CUDA
kernels against their plain versions are in ``test_torch_cuda.py``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.gcfn import _fused_gcfn_impl
from sepreformer_tpu.ops.pallas.relpos import (
    materialize_pos_kt as jax_materialize_pos_kt,
)
from sepreformer_tpu.ops.pallas.softmax_pv import softmax_pv as jax_softmax_pv
from sepreformer_torch.ops.kernels import (
    _build,
    fused_gcfn,
    gcfn_plain,
    materialize_pos_kt,
    materialize_pos_kt_plain,
    softmax_pv,
    softmax_pv_plain,
)

# float32 arithmetic in another order than XLA's
GCFN_TOL = dict(rtol=2e-5, atol=2e-5)
PV_TOL = dict(rtol=1e-5, atol=1e-6)


def gcfn_params(rng, f):
    h = 6 * f
    shapes_scales = [((f,), 1.0), ((f,), 1.0), ((f, h), 0.1), ((h,), 0.1),
                     ((3, h), 0.3), ((h,), 0.1), ((h // 2, f), 0.1),
                     ((f,), 0.1), ((f,), 0.5)]
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in shapes_scales]


def as_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def torch_layout(params):
    """The JAX kernel's GCFN parameters in the port's layout: the same,
    but the k3 weight [3, 6F] as the Conv1d weight's [6F, 3]."""
    lns, lnb, win, bin_, wdw, bdw, wout, bout, ls = params
    return as_torch([lns, lnb, win, bin_, np.ascontiguousarray(wdw.T), bdw,
                     wout, bout, ls])


# (b, t, f, lens): t=48 runs the single-shot Pallas body, t=256 the
# software-pipelined one
GCFN_CASES = [(2, 48, 16, None), (2, 48, 16, (48, 31)),
              (2, 256, 32, (256, 100))]


@pytest.mark.parametrize("b,t,f,lens", GCFN_CASES)
def test_gcfn_plain_matches_jax_kernel(b, t, f, lens):
    rng = np.random.default_rng(t + f)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    params = gcfn_params(rng, f)
    mask = None
    if lens is not None:
        mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None])
        mask = jnp.asarray(mask[..., None], jnp.float32)
    ref = _fused_gcfn_impl(jnp.asarray(x), tuple(map(jnp.asarray, params)),
                           1e-5, interpret=True, mask=mask)
    got = gcfn_plain(torch.from_numpy(x), torch_layout(params), 1e-5,
                     None if lens is None else torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GCFN_TOL)


def test_gcfn_mask_zeroes_u_rows_past_length():
    """The k3 conv at the last valid frame reads u = 0 past the length, so
    the output up to the length equals the run on the cut sequence."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 40, 16)).astype(np.float32))
    params = torch_layout(gcfn_params(rng, 16))
    masked = gcfn_plain(x, params, 1e-5, torch.tensor([25]))
    cut = gcfn_plain(x[:, :25].contiguous(), params, 1e-5)
    torch.testing.assert_close(masked[:, :25], cut, rtol=0, atol=0)


@pytest.mark.parametrize("t,maxlen", [(128, 40), (256, 300)])
def test_relpos_plain_matches_jax_kernel(t, maxlen):
    rng = np.random.default_rng(t)
    table = rng.normal(size=(2 * maxlen, 8)).astype(np.float32)
    ref = jax_materialize_pos_kt(jnp.asarray(table), t, maxlen, True)
    got = materialize_pos_kt_plain(torch.from_numpy(table), t, maxlen)
    assert got.shape == (t, 8, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lens", [None, (100, 57)])
def test_softmax_pv_plain_matches_jax_kernel(lens):
    b, h, lp, d, length = 2, 2, 128, 8, 100
    rng = np.random.default_rng(3)
    scores = (rng.normal(size=(b, h, lp, lp)) * 3).astype(np.float32)
    v = rng.normal(size=(b, lp, h * d)).astype(np.float32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = jax_softmax_pv(jnp.asarray(scores), jnp.asarray(v), jl, length,
                         True)
    tl = None if lens is None else torch.tensor(lens)
    got = softmax_pv_plain(torch.from_numpy(scores), torch.from_numpy(v), tl,
                           length)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PV_TOL)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 8, 16)).astype(np.float32))
    params = torch_layout(gcfn_params(rng, 16))
    before = fused_gcfn.launches
    assert torch.equal(fused_gcfn(x, params, 1e-5),
                       gcfn_plain(x, params, 1e-5))
    table = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    assert torch.equal(materialize_pos_kt(table, 12, 10),
                       materialize_pos_kt_plain(table, 12, 10))
    s = torch.randn(1, 2, 16, 16)
    v = torch.randn(1, 16, 8)
    assert torch.equal(softmax_pv(s, v, None, 10),
                       softmax_pv_plain(s, v, None, 10))
    assert fused_gcfn.launches == before  # the CPU path launches nothing


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card is refused: the plain
    version is taken only for CPU tensors."""
    meta = torch.device("meta")
    x = torch.empty(1, 8, 128, device=meta)
    params = [torch.empty(s, device=meta) for s in
              [(128,), (128,), (128, 768), (768,), (768, 3), (768,),
               (384, 128), (128,), (128,)]]
    with pytest.raises(ValueError):
        fused_gcfn(x, params, 1e-5)
    with pytest.raises(ValueError):
        materialize_pos_kt(torch.empty(20, 4, device=meta), 12, 10)
    with pytest.raises(ValueError):
        softmax_pv(torch.empty(1, 2, 16, 16, device=meta),
                   torch.empty(1, 16, 32, device=meta), None, 10)


def test_build_names_library_by_source_hash():
    srcs = [p.name for p in _build.sources()]
    assert srcs == ["attention_train.cu", "cla.cu", "depthwise.cu",
                    "ega_gcfn.cu", "flash_relpos.cu", "gcfn.cu",
                    "gcfn_train.cu", "pit.cu", "relpos.cu", "softmax_pv.cu",
                    "softmax_pv_train.cu"]
    assert [p.name for p in _build.headers()] == ["flash_relpos_tile.cuh",
                                                  "gcfn_tile_mma.cuh",
                                                  "hash_dropout.cuh",
                                                  "mma_tf32x3.cuh",
                                                  "softmax_pv_tile.cuh"]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libsepkernels-") and path.suffix == ".so"
    c_types = {ctypes.c_int: "int", ctypes.c_longlong: "long long"}
    for name in _build.SIGNATURES:
        ret = c_types[_build.RESTYPES.get(name, ctypes.c_int)]
        for src in _build.sources():
            if f'"C" {ret} {name}(' in src.read_text():
                break
        else:
            raise AssertionError(f"no extern C launcher {name}")
