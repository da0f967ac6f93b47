"""K13 and K14 at Large's head width 32 (the "pallas" train route and the
"single" eval route of ``SepReformer_Large_*``) on the CPU.

- The plain versions (``attention_train_plain``, ``attention_train_bwd_plain``
  and the wrapper's CPU autograd) against the JAX package's
  ``attention_train_reference`` and ``jax.grad`` of it at d = 32, L 128
  and 300, dropout 0 and 0.1, with and without key lengths; and one case
  against the Pallas kernel in interpret mode ([1, 2, 128, 32], p 0.1).
  The bars are ``test_torch_attention_train.py``'s (the JAX package's).
- A numpy plan of the CUDA launches at d = 32
  (``csrc/flash_relpos_tile.cuh``, ``csrc/attention_train.cu``): each
  block's shared memory, K13's split at Large's train shapes, and every
  accumulator fragment, staged element and frame row of K14 owned once.

The kernels against the plain versions on a card are in
``test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas.attention_train import (
    attention_train_reference,
    flash_relpos_attention_train as jax_flash_relpos_attention_train,
)
from sepreformer_torch.ops.kernels import (
    attention_train_bwd_plain,
    attention_train_plain,
    flash_relpos_attention_train,
)
from test_torch_attention_train import (
    FWD_TOL,
    GRAD_TOL,
    MAXLEN,
    SEED,
    case,
    torch_args,
)

D = 32
CSRC = Path(__file__).resolve().parents[1] / "sepreformer_torch" / "csrc"
TILE = (CSRC / "flash_relpos_tile.cuh").read_text()
ATTENTION_TRAIN = (CSRC / "attention_train.cu").read_text()
BLOCK_MAX = 227 * 1024         # a block's shared memory on the H100
SM_BYTES = 228 * 1024          # an SM's, 1 KB of it reserved per block
SMS = 132


@pytest.mark.parametrize("length", [128, 300])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_d32_matches_jax_reference_and_grad(length, p, masked):
    """The forward (``attention_train_plain`` and the wrapper) against
    the reference, and ``attention_train_bwd_plain`` and the wrapper's CPU
    autograd against ``jax.grad`` of it, in q, k, v and the table."""
    q, k, v, table, dout, lens = case(length, d=D, seed=10)
    ln = lens if masked else None

    def loss(q, k, v, table):
        out = attention_train_reference(
            q, k, v, table, MAXLEN, jnp.int32(SEED), p,
            None if ln is None else jnp.asarray(ln))
        return jnp.sum(out * jnp.asarray(dout)), out

    # one compile of the whole function (op by op, the reference compiles
    # each operation at each new shape)
    (_, ref), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (q, k, v, table)))
    targs = torch_args(q, k, v, table)
    tl = None if ln is None else torch.from_numpy(ln)
    got = attention_train_plain(*targs, MAXLEN, SEED, p, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    plain = attention_train_bwd_plain(*targs, MAXLEN, SEED, p, tl,
                                      torch.from_numpy(dout))
    leaves = [a.clone().requires_grad_() for a in targs]
    wrapped = flash_relpos_attention_train(*leaves, SEED, MAXLEN, p, tl)
    torch.testing.assert_close(wrapped.detach(), got, rtol=0, atol=0)
    (wrapped * torch.from_numpy(dout)).sum().backward()
    for name, r, a, b in zip(("dq", "dk", "dv", "dtable"), grads, plain,
                             (x.grad for x in leaves)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_d32_plain_matches_the_pallas_kernel_in_interpret_mode():
    q, k, v, table, dout, _ = case(128, b=1, d=D, seed=12)
    p = 0.1

    def loss(q, k, v, table):
        out = jax_flash_relpos_attention_train(q, k, v, table,
                                               jnp.int32(SEED), MAXLEN, p,
                                               True)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v, table)))
    targs = torch_args(q, k, v, table)
    got = attention_train_plain(*targs, MAXLEN, SEED, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    plain = attention_train_bwd_plain(*targs, MAXLEN, SEED, p, None,
                                      torch.from_numpy(dout))
    for r, a in zip(grads, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


# ---------------------------------------------------------------- the plan

def k13_shape(split, d):
    """``relpos_flash::Shape<SPLIT, D>``: threads, stages, shared bytes and
    blocks per SM."""
    ks, vs = (d if d == 16 else d + 4), d + 4
    warps, step_keys = 4 * split, 64 * split
    band = 64 + step_keys
    stage = step_keys * (ks + vs) + band * ks
    bias = 4 * warps * 16 * 80
    stages = 2 if 4 * 2 * stage + bias <= BLOCK_MAX else 1
    smem = 4 * stages * stage + bias
    return dict(threads=32 * warps, stages=stages, smem=smem,
                blocks=min(4 // split, SM_BYTES // (smem + 1024)),
                xch=(split - 1) * 4 * 32 * (4 + 4 * (d // 8)),
                stage=stage)


def k13_split(bh, length, d, sms=SMS):
    """``split_for<D>`` of ``csrc/attention_train.cu``."""
    blocks = -(-length // 64) * bh
    tiles = -(-length // 64)
    per4, per2 = k13_shape(4, d)["blocks"], k13_shape(2, d)["blocks"]
    fit = 4 if blocks <= per4 * sms else 2 if blocks <= per2 * sms else 1
    return min(fit, 4 if tiles >= 4 else 2 if tiles >= 2 else 1)


def test_k13_d32_plan():
    """D = 16 keeps its shapes (54, 100 and 196 KB, 16 warps per SM at
    every split, two stages); D = 32 takes 92 KB at SPLIT 1 (two blocks
    per SM), 166 KB at 2 and, with one stage, 197 KB at 4 (one block);
    the split warps' states fit over the stages."""
    base = [k13_shape(s, 16) for s in (1, 2, 4)]
    assert [b["smem"] for b in base] == [55296, 102400, 196608]
    assert all(b["stages"] == 2 for b in base)
    assert [b["blocks"] * b["threads"] for b in base] == [512] * 3
    large = [k13_shape(s, D) for s in (1, 2, 4)]
    assert [b["smem"] for b in large] == [94208, 169984, 201728]
    assert [b["stages"] for b in large] == [2, 2, 1]
    assert [b["blocks"] for b in large] == [2, 1, 1]
    for shape in base + large:
        assert shape["smem"] <= BLOCK_MAX
        assert shape["xch"] <= shape["stages"] * shape["stage"]
    assert "kStages =" in TILE and "S::kStages == 2 ? step & 1 : 0" in TILE


@pytest.mark.parametrize("b,d,split", [
    (2, 32, 4), (4, 32, 1), (8, 32, 1),       # Large's train, single
    (2, 16, 4), (4, 16, 2), (8, 16, 1)])      # Base's, as before
def test_k13_split_rule(b, d, split):
    """The warps per row tile at [B, 8, 500, d]: Large's encoder (128
    blocks, one wave of one block per SM) takes SPLIT 4; its decoder (256
    blocks) SPLIT 1, two blocks per SM in one wave."""
    assert k13_split(8 * b, 500, d) == split
    assert "Shape<4, D>::kMinBlocks" in ATTENTION_TRAIN


def k14_dims(d):
    """``bwd::Dims<D>``: strides, shared floats and blocks per SM."""
    tile, band = 64, 128
    gs, qb = band + 8, band + 3
    s, q = d + 4, d + 8
    dq = 2 * (2 * tile * s + band * s) + tile * gs + tile * q
    kv = 2 * tile * s + band * s + 3 * tile + tile * qb
    return dict(s=s, q=q, dq=4 * dq, kv=4 * kv,
                dq_blocks=SM_BYTES // (4 * dq + 1024),
                kv_fit=SM_BYTES // (4 * kv + 1024))


def test_k14_d32_plan():
    """The dq launch takes 80 KB at D = 16 (two blocks per SM) and 116 KB
    at 32 (one); the dk/dv launch 53.5 KB (four) and 69.5 KB, where three
    would fit but two run (their accumulators spill at three blocks'
    registers); the table launch kParts * D = 512 threads at 32."""
    assert (k14_dims(16)["dq"], k14_dims(16)["dq_blocks"]) == (81920, 2)
    assert (k14_dims(16)["kv"], k14_dims(16)["kv_fit"]) == (54784, 4)
    assert (k14_dims(D)["dq"], k14_dims(D)["dq_blocks"]) == (118784, 1)
    assert (k14_dims(D)["kv"], k14_dims(D)["kv_fit"]) == (71168, 3)
    assert "kKvBlocks = D == 16 ? 4 : 2" in ATTENTION_TRAIN
    assert 16 * D <= 1024
    assert re.search(r"__launch_bounds__\(kParts \* D\)", ATTENTION_TRAIN)


@pytest.mark.parametrize("d", [16, D])
def test_k14_strides_miss_no_bank(d):
    """A lane (g, t)'s loads of rows g, columns t (fragments of K, V, Q,
    dO and the band), rows 2t, columns g (the C-as-A products' B
    operands) at stride D + 4, and of rows t, columns g of the query tile
    at stride D + 8, fall in 32 distinct banks."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    s, q = k14_dims(d)["s"], k14_dims(d)["q"]
    for banks in ((g * s + t) % 32, (2 * t * s + g) % 32, (t * q + g) % 32):
        assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("d", [16, D])
def test_k14_fragments_have_one_owner(d):
    """dq's (dk's, dv's) accumulator of warp w, lane (g, t), n-tile nn,
    element e is row 16 w + g + 8 (e // 2), column 8 nn + 2 t + e % 2 of
    the block's 64 rows: every element of the [64, d] tile once; and the
    staged rows (thread tid: 16 bytes at column 4 (tid % (d / 4)) of rows
    tid // (d / 4) + (128 / (d / 4)) it) cover a [64, d] tile once."""
    own = np.zeros((64, d), int)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for nn in range(d // 8):
                for e in range(4):
                    own[16 * w + g + 8 * (e // 2), 8 * nn + 2 * t + e % 2] += 1
    assert (own == 1).all()
    staged = np.zeros((64, d), int)
    per_row = d // 4
    for tid in range(128):
        for rr in range(tid // per_row, 64, 128 // per_row):
            c4 = (tid % per_row) * 4
            staged[rr, c4:c4 + 4] += 1
    assert (staged == 1).all()


@pytest.mark.parametrize("length,lim", [(500, 500), (300, 131), (77, 30)])
def test_k14_frame_rows_written_once(length, lim):
    """The dq launch's frame of a query tile (frame_rows(L) rows of d
    columns): per key tile the band m-tiles warp + 4 of every warp are
    stored (with the carried m-tile of the tile before), after the walk
    each warp's carried m-tile, and the rows below it are zeroed: every
    row once, whatever the valid keys."""
    tile = 64
    nqt = -(-length // tile)
    lk = nqt * tile
    nframe = lk + tile
    nkt = -(-lim // tile)
    written = np.zeros(nframe, int)
    for n in range(nkt):
        f = (lk - tile - n * tile) // 16
        for w in range(4):
            written[16 * (f + w + 4):16 * (f + w + 5)] += 1
    f = (lk - nkt * tile) // 16
    for w in range(4):
        written[16 * (f + w):16 * (f + w + 1)] += 1
    written[:16 * f] += 1
    assert (written == 1).all()
