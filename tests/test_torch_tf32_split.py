"""Why the BNN kernels split each float32 operand into two tf32 parts.

The GEMMs of ``csrc/bnn_grad.cuh`` run on the tensor cores in tf32, which
keeps 10 of float32's 23 mantissa bits.  The kernels split each operand
``a = big + small`` with ``big = tf32(a)`` and ``small = tf32(a - big)``
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero) and
accumulate ``big*big + big*small + small*big`` in float32 (3xTF32).  This
test emulates that arithmetic in numpy, bit for bit in the split and the
products: each wgmma k8 step adds 8 exact tf32 products to the float32
accumulator, once per term, in the kernel's order.  At the flagship's
contraction lengths (784 for x W1, 1024 for x^T da), against float64:

* the 3-term product is within 3x of float32 ``matmul``'s own error (it
  measured 1.0-1.6x);
* a single tf32 pass is at least 10x further off than the 3-term product
  (it measured ~500x: about 3e-4 of the largest output), too far for the
  samplers' 1e-5 gates.

The kernels' A operand (W1^T in the forward, da^T in the backward) is split
in registers as each thread loads it (``tf32_split_alu``): big rounded to
nearest as above, small = a - big left unrounded, of which the tensor cores
read the upper 19 bits (a truncation).  B (x, x^T) is staged split by
``cvt.rna``.  big.big accumulates in one float32 accumulator and the two
small products, A.big B.small then A.small B.big, in a second, added once at
the end; the last test emulates that order and holds it to the same 3x.
"""

import numpy as np
import pytest


def tf32_rna(a):
    """float32 -> tf32 (low 13 bits zero), to nearest, ties away from zero."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    big = tf32_rna(a)
    return big, tf32_rna((a - big).astype(np.float32))


def wgmma_sum(terms, k):
    """float32 accumulator; per k8 step, each term's 8 exact products added once."""
    acc = np.zeros((terms[0][0].shape[0], terms[0][1].shape[1]), np.float32)
    for k0 in range(0, k, 8):
        for a, b in terms:
            step = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def test_split_is_exact_up_to_the_small_part():
    a = np.random.RandomState(0).randn(10000).astype(np.float32) * np.float32(37.0)
    big, small = split(a)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    rest = (a - big).astype(np.float32)  # exact in float32
    assert np.array_equal(big.astype(np.float64) + rest.astype(np.float64), a.astype(np.float64))
    assert np.all(np.abs(rest) <= np.abs(a) * 2.0**-11)
    assert np.all(np.abs(small - rest) <= np.abs(a) * 2.0**-21)


@pytest.mark.parametrize("k", [784, 1024])
@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_three_tf32_products_hold_float32_accuracy_and_one_does_not(k, scale):
    rng = np.random.RandomState(k)
    a = rng.randn(64, k).astype(np.float32)  # x or x^T, N(0, 1) data
    b = (scale * rng.randn(k, 64)).astype(np.float32)  # W1 or da
    exact = a.astype(np.float64) @ b.astype(np.float64)
    top = np.abs(exact).max()
    fp32 = np.abs(np.matmul(a, b).astype(np.float64) - exact).max() / top
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    three = np.abs(wgmma_sum([(a_big, b_big), (a_big, b_small), (a_small, b_big)], k)
                   - exact).max() / top
    one = np.abs(wgmma_sum([(tf32_rna(a), tf32_rna(b))], k) - exact).max() / top
    assert three <= 3.0 * fp32
    assert one >= 10.0 * three
    assert one > 1e-5  # a single pass alone would break the 1e-5 gates


def split_alu(a):
    """The register split: big as ``split``'s, small = a - big as the tensor
    cores read it (low 13 bits cleared: truncated toward zero)."""
    big = tf32_rna(a)
    rest = np.ascontiguousarray((a - big).astype(np.float32)).view(np.uint32)
    return big, (rest & np.uint32(0xFFFFE000)).view(np.float32)


def two_accumulators(a, b, k):
    """The kernels' order: per k8 step big.big into acc, then A.big B.small
    and A.small B.big into acc_s; acc + acc_s once at the end (float32)."""
    (a_big, a_small), (b_big, b_small) = split_alu(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc_s = np.zeros_like(acc)
    for k0 in range(0, k, 8):
        def step(x, y):
            return x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
        acc = (acc.astype(np.float64) + step(a_big, b_big)).astype(np.float32)
        acc_s = (acc_s.astype(np.float64) + step(a_big, b_small)).astype(np.float32)
        acc_s = (acc_s.astype(np.float64) + step(a_small, b_big)).astype(np.float32)
    return acc + acc_s


# forward: A = W1^T (hidden x I, small weights), B = x^T (I x rows of x);
# backward: A = da^T (hidden x N), B = x (N x inputs)
@pytest.mark.parametrize("k, a_scale", [(784, 0.01), (784, 1.0), (1024, 1.0), (1024, 0.01)])
def test_register_split_in_the_kernels_order_holds_float32_accuracy(k, a_scale):
    rng = np.random.RandomState(k + int(100 * a_scale))
    a = (a_scale * rng.randn(64, k)).astype(np.float32)
    b = rng.randn(k, 64).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    top = np.abs(exact).max()
    fp32 = np.abs(np.matmul(a, b).astype(np.float64) - exact).max() / top
    got = np.abs(two_accumulators(a, b, k).astype(np.float64) - exact).max() / top
    assert got <= 3.0 * fp32
    small = split_alu(a)[1]
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(a - split_alu(a)[0] - small) <= np.abs(a) * 2.0**-21)
