"""K16, the EGA tail fused with the GCFN, on the CPU: the port's plain
version against the JAX package's reference and its Pallas kernel in
interpret mode, the autograd function's gradients against ``jax.grad``
of the JAX wrapper, the route condition's ``pick_block``, and the port's
GlobalBlock on the pair route against EGA then GCFN, in eval and in a
train forward at dropout 0.  Inputs come from numpy seeds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sepreformer_tpu.ops.pallas import ega_gcfn as jpair
from sepreformer_tpu.ops.pallas import gcfn as jgcfn
from sepreformer_torch.models.blocks import GlobalBlock, RelPos, TrainMode
from sepreformer_torch.ops.kernels import ega_gcfn as tpair
from sepreformer_torch.ops.kernels import pos_kt
from sepreformer_torch.ops.kernels.gcfn import pick_block

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as in test_torch_engine.py: beside the
    other test workers torch's own pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gcfn_params(rng, f):
    h = 6 * f
    return [rng.normal(size=(f,)), rng.normal(size=(f,)),
            rng.normal(size=(f, h)) * 0.1, rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(3, h)) * 0.3, rng.normal(size=(h,)) * 0.1,
            rng.normal(size=(h // 2, f)) * 0.1, rng.normal(size=(f,)) * 0.1,
            rng.normal(size=(f,)) * 0.01]


def gate_params(rng, f):
    return [rng.normal(size=(f,)), rng.normal(size=(f,)),
            rng.normal(size=(f, f)) * 0.1, rng.normal(size=(f,)) * 0.1]


def inputs(seed, b, t, length, f):
    """x, x_down, gate and GCFN params as float32 numpy (the GCFN's k3
    weight in JAX's [3, 6F] layout)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    xd = rng.normal(size=(b, length, f)).astype(np.float32)
    gate = [np.asarray(a, np.float32) for a in gate_params(rng, f)]
    gcfn = [np.asarray(a, np.float32) for a in gcfn_params(rng, f)]
    return x, xd, gate, gcfn


def to_port(gcfn):
    """The port's GCFN params: the k3 weight as the Conv1d's [6F, 3]."""
    out = [torch.from_numpy(a) for a in gcfn]
    out[4] = out[4].t().contiguous()
    return out


# the JAX package's kernel tests' shapes: r = 1, 2, 8 (one block and a
# multi-block t > 512) and a non-integral upsample (the JAX kernel's
# pick_block is 0 there, so it takes its reference); Large's F = 256 at
# r = 8 in one block and in five (t 640: blocks of 128)
@pytest.mark.parametrize("b,t,length,f", [(2, 256, 256, 64),
                                          (2, 512, 256, 64),
                                          (1, 512, 64, 128),
                                          (1, 1024, 128, 64),
                                          (1, 1150, 500, 64),
                                          (1, 256, 32, 256),
                                          (1, 640, 80, 256)])
def test_pair_plain_matches_jax(b, t, length, f):
    x, xd, gate, gcfn = inputs(t + length, b, t, length, f)
    j = [jnp.asarray(a) for a in (x, xd)]
    jg, jc = tuple(map(jnp.asarray, gate)), tuple(map(jnp.asarray, gcfn))
    ref = jpair.ega_tail_gcfn_reference(*j, jg, jc, 1e-5)
    kernel = jpair._impl(*j, jg, jc, 1e-5, interpret=True)
    got = tpair.ega_tail_gcfn_plain(
        torch.from_numpy(x), torch.from_numpy(xd),
        [torch.from_numpy(a) for a in gate], to_port(gcfn), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)


def test_pick_block_matches_jax():
    for t in range(1, 4200):
        assert pick_block(t) == jgcfn.pick_block(t), t


def test_pair_gradients_match_jax():
    """x, x_down and all thirteen parameters: the recompute VJP of
    ``fused_ega_tail_gcfn`` against ``jax.grad`` of the JAX wrapper (its
    kernel in interpret mode)."""
    x, xd, gate, gcfn = inputs(8, 1, 256, 64, 64)

    def loss(x, xd, gp, cp):
        return jnp.sum(jpair.fused_ega_tail_gcfn(x, xd, gp, cp, 1e-5,
                                                 True) ** 2)

    refs = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(xd), tuple(map(jnp.asarray, gate)),
        tuple(map(jnp.asarray, gcfn)))
    xt = torch.from_numpy(x).requires_grad_()
    xdt = torch.from_numpy(xd).requires_grad_()
    gt = [torch.from_numpy(a).requires_grad_() for a in gate]
    ct = [a.requires_grad_() for a in to_port(gcfn)]
    (tpair.fused_ega_tail_gcfn(xt, xdt, gt, ct, 1e-5) ** 2).sum().backward()
    got = [xt.grad, xdt.grad, *(a.grad for a in gt), *(a.grad for a in ct)]
    want = [refs[0], refs[1], *refs[2], *refs[3]]
    want[6 + 4] = np.asarray(want[6 + 4]).T      # the k3 weight's layout
    names = ["x", "x_down", "gns", "gnb", "wg", "bg", "lns", "lnb", "win",
             "bin", "wdw", "bdw", "wout", "bout", "ls"]
    for name, a, ref in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)


def seeded_block(f, heads, seed=9):
    gen = torch.Generator().manual_seed(seed)
    block = GlobalBlock(f, heads, fused_pair="on")
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        for name, p in block.named_parameters():
            if name.endswith("layer_scale"):
                p.fill_(0.5)
    return block


@pytest.mark.parametrize("train_p", [None, 0.0, 0.05])
def test_global_block_pair_route(monkeypatch, train_p):
    """The pair route calls K16 once in eval and in a train forward at
    dropout 0 (not at 0.05) and agrees with EGA then GCFN, in the output
    and, in training, in every gradient."""
    from sepreformer_torch.models import blocks

    calls = []
    real = blocks.fused_ega_tail_gcfn
    monkeypatch.setattr(blocks, "fused_ega_tail_gcfn",
                        lambda *a: calls.append(1) or real(*a))
    f, heads, t, length, maxlen = 16, 2, 256, 64, 64
    fused = seeded_block(f, heads)
    plain = copy.deepcopy(fused)
    plain.fused_pair = "off"
    gate = fused.block["ega"].block["linear"][1]
    assert gate.weight.t().is_contiguous()
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(2, t, f)).astype(np.float32))
    table = torch.from_numpy(
        rng.normal(size=(2 * maxlen, f // heads)).astype(np.float32))
    pos = RelPos(length=length, pos_kt=pos_kt(table, 128, maxlen),
                 table=table, maxlen=maxlen, impl="xla", train_impl="xla")
    outs, grads = [], []
    for block in (fused, plain):
        train = (None if train_p is None else
                 TrainMode(train_p, torch.Generator().manual_seed(11),
                           torch.Generator().manual_seed(12)))
        xi = x.clone().requires_grad_(train is not None)
        with torch.set_grad_enabled(train is not None):
            out = block(xi, pos, train=train)
            if train is not None:
                (out * out).sum().backward()
                grads.append([xi.grad] + [p.grad for p in block.parameters()])
        outs.append(out.detach())
    assert len(calls) == (1 if train_p in (None, 0.0) else 0)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)
    if train_p is not None:
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)


def test_pair_kernel_checks_before_launch():
    """The kernel path raises where T is not a multiple of the bottleneck
    length and at a width other than 128, before the device checks; the
    CPU wrapper takes the plain version and launches nothing."""
    x, xd, gate, gcfn = inputs(13, 1, 100, 30, 64)
    gt = [torch.from_numpy(a) for a in gate]
    with pytest.raises(ValueError, match="not a multiple"):
        tpair.pair_kernel(torch.from_numpy(x), torch.from_numpy(xd), gt,
                          to_port(gcfn), 1e-5)
    with pytest.raises(ValueError, match="width 64"):
        tpair.pair_kernel(torch.from_numpy(x), torch.from_numpy(xd[:, :25]),
                          gt, to_port(gcfn), 1e-5)
    before = tpair.fused_ega_tail_gcfn.launches
    tpair.fused_ega_tail_gcfn(torch.from_numpy(x), torch.from_numpy(xd), gt,
                              to_port(gcfn), 1e-5)
    assert tpair.fused_ega_tail_gcfn.launches == before


def test_pair_route_raises_on_unequal_eps():
    """K16 normalises the EGA gate's LayerNorm and the GCFN's with one
    eps: the pair route raises where they differ, and the unfused route
    still runs."""
    f, heads, t, length, maxlen = 16, 2, 64, 16, 16
    block = seeded_block(f, heads)
    block.block["ega"].block["linear"][0].eps = 1e-6
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(1, t, f)).astype(np.float32))
    table = torch.from_numpy(
        rng.normal(size=(2 * maxlen, f // heads)).astype(np.float32))
    pos = RelPos(length=length, pos_kt=pos_kt(table, 128, maxlen),
                 table=table, maxlen=maxlen, impl="xla", train_impl="xla")
    with torch.no_grad():
        with pytest.raises(ValueError, match="eps"):
            block(x, pos)
        block.fused_pair = "off"
        assert torch.isfinite(block(x, pos)).all()
