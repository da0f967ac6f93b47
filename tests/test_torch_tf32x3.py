"""The accuracy argument of ``sepreformer_torch/csrc/mma_tf32x3.cuh``,
emulated in numpy: why K8 and K12 take their products on the tensor cores
as three TF32 products ("3xTF32") and not one.

The header splits a float32 x into big = x rounded to TF32 (10 mantissa
bits, round to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
rounds) and small = x - big, whose 13 low bits the tensor core drops
(TF32 toward zero), and takes a·b as a_small·b_big + a_big·b_small +
a_big·b_big per m16n8k8 step, into float32 accumulators.
Here each step's products are exact (two 11-bit significands fit float32)
and summed in float64, then rounded to float32 and added to the float32
accumulator, in the header's order.  Against float64, at K12's depth (the
head width 16) and K8's (the hidden width 768), the three products must
err by under 1e-6 of the largest |result|, which holds the kernels' card
tests and the smoke's limits (rtol 1e-4, 3e-5 of max|out|) with room;
one TF32 product must err by more than 1e-4 of it, which is why plain
TF32 cannot pass them.
"""

import numpy as np
import pytest


def to_tf32(x):
    """float32 -> float32 with 10 mantissa bits, nearest, ties away."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def toward_zero(x):
    """float32 -> TF32 by dropping the 13 low bits, as the tensor core
    reads an operand."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = to_tf32(x)
    return big, toward_zero(np.float32(x) - big)


def mma_product(a, b, terms):
    """a [M, K] @ b [K, N] as the tensor cores take it: per k-step of 8,
    each (a part, b part) product in ``terms`` added to a float32
    accumulator in turn."""
    (ab, as_), (bb, bs) = split(a), split(b)
    parts = {"big": (ab, bb), "a_small": (as_, bb), "b_small": (ab, bs)}
    c = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k0 in range(0, a.shape[1], 8):
        for term in terms:
            pa, pb = parts[term]
            step = (pa[:, k0:k0 + 8].astype(np.float64)
                    @ pb[k0:k0 + 8].astype(np.float64))
            c = c + step.astype(np.float32)
    return c


def test_tf32_rounds_to_nearest_with_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's spacing at 1
    x = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                  1 + 3 * 2 ** -11, 3.0], dtype=np.float32)
    np.testing.assert_array_equal(
        to_tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                              3.0], dtype=np.float32))
    rng = np.random.default_rng(3)
    v = rng.normal(size=4096).astype(np.float32)
    big, small = split(v)
    # the low 13 bits of both parts are zero, big is within half a TF32
    # unit of the value, and together they keep about 21 bits of it
    assert not np.any(big.view(np.uint32) & 0x1FFF)
    assert not np.any(small.view(np.uint32) & 0x1FFF)
    assert np.all(np.abs(v - big) <= np.abs(v) * 2.0 ** -11)
    rel = np.abs((big.astype(np.float64) + small) - v) / np.abs(v)
    assert rel.max() < 2.0 ** -20


@pytest.mark.parametrize("depth", [16, 768])
def test_three_tf32_products_hold_float32_accuracy(depth):
    rng = np.random.default_rng(depth)
    a = rng.normal(size=(64, depth)).astype(np.float32)
    b = rng.normal(size=(depth, 64)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    three = mma_product(a, b, ("a_small", "b_small", "big"))
    one = mma_product(a, b, ("big",))
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 < 1e-6, err3
    assert err1 > 1e-4, err1
