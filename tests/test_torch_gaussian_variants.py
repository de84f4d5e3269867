"""The design choices of ``csrc/gaussian_hmc.cu`` that a CPU can check.

(a) The tensor-core variant computes the dense gradient ``(theta - mean) @ P``
    with ``mma.sync.m16n8k8`` in 3xTF32: P is split once into tf32 big and
    small parts, ``theta - mean`` is split each step (its small part left
    unrounded: the tensor cores read only its upper 19 bits), and per k8
    slice big*big, big*small and small*big each go into a float32
    accumulator of their own, added once at the end.  A numpy emulation of
    exactly that arithmetic drives the whole sampler at D=128 on injected
    noise and is held to the gates the card's checks use against the plain
    version: draws within 1e-5, identical accept counts.  The accumulation is
    emulated both rounded to nearest and truncated toward zero (the tensor
    cores' accumulation behaves like the latter), and a single tf32 pass is
    shown to break the gate.
(b) The card tests' Gaussian cases (``tests/test_torch_gpu.py``) compare accept
    counts; here, without a card, each case's closest Metropolis decision is
    shown to be far from a knife edge that float32 rounding could tip.
(c) ``_plan`` (the wrapper's choice of kernel variant, block shape and
    shared-memory bytes) over every D = 1..4096, diagonal and dense: a
    variant within the 232,448 bytes a block may use; only a D whose state
    no longer fits one block (beyond 9,676 dense, 11,612 diagonal) and a
    chain_tile below 1 are refused.
"""

import numpy as np
import pytest
import torch

from hamiltorch_tpu_torch.kernels.gaussian_hmc import (
    MAX_SHARED,
    MMA_MAX_D,
    WIDE_WARPS,
    _plan,
    _wide_shared,
    gaussian_hmc_reference,
)
from test_torch_gpu import (GAUSSIAN_CASES, GAUSSIAN_RUN, WIDE_BLOCK_CASES, WIDE_CASES,
                            _min_accept_margin, gaussian_case)
from test_torch_tf32_split import split, tf32_rna

ATOL = 1e-5


def _to_float32(acc64, truncate):
    """float64 -> float32 to nearest, or toward zero."""
    r = acc64.astype(np.float32)
    if truncate:
        over = np.abs(r.astype(np.float64)) > np.abs(acc64)
        r = np.where(over, np.nextafter(r, np.float32(0.0)), r)
    return r


def split_truncated(a):
    """The kernel's per-step split: big to nearest, small = a - big with its low
    13 bits dropped."""
    big = tf32_rna(a)
    rest = (a - big).astype(np.float32)
    return big, (rest.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def mma_matvec(delta, p_big, p_small, terms=3, truncate=False):
    """(C, D) @ (D, D) as the kernel's k8 slices of m16n8k8 products do it."""
    d_big, d_small = split_truncated(delta)
    acc = np.zeros((delta.shape[0], p_big.shape[1]), np.float32)
    acc_bs, acc_sb = np.zeros_like(acc), np.zeros_like(acc)

    def add(into, a, b):
        return _to_float32(into.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64),
                           truncate)

    for k0 in range(0, delta.shape[1], 8):
        k = slice(k0, k0 + 8)
        acc = add(acc, d_big[:, k], p_big[k])
        if terms == 3:
            acc_bs = add(acc_bs, d_big[:, k], p_small[k])
            acc_sb = add(acc_sb, d_small[:, k], p_big[k])
    return acc + (acc_bs + acc_sb)


def emulated_sampler(theta0, prec, mean, momenta, uniforms, steps, eps, **kw):
    """The kernel's draw loop in float32 numpy with the emulated gradient."""
    f = np.float32
    p_big, p_small = split(prec)
    if kw.get("terms") == 1:
        p_small = np.zeros_like(p_big)

    def grad(th):
        return -mma_matvec((th - mean).astype(f), p_big, p_small, **kw)

    def half_energy(th, g, p):  # sum of 1/2 (p^2 - (theta - mean) g) in float64
        delta = (th - mean).astype(f).astype(np.float64)
        return 0.5 * np.sum(p.astype(np.float64) ** 2 - delta * g.astype(np.float64), axis=1)

    theta, g_cur = theta0.copy(), grad(theta0)
    draws, accepted = [], np.zeros(theta0.shape[0])
    for z, u in zip(momenta, uniforms):
        e0 = half_energy(theta, g_cur, z)
        p = (z + f(0.5 * eps) * g_cur).astype(f)
        th, g = theta, g_cur
        for _ in range(steps):
            th = (th + f(eps) * p).astype(f)
            g = grad(th)
            p = (p + f(eps) * g).astype(f)
        p = (p - f(0.5 * eps) * g).astype(f)
        accept = (e0 - half_energy(th, g, p)) >= np.log(u.astype(np.float64))
        theta = np.where(accept[:, None], th, theta)
        g_cur = np.where(accept[:, None], g, g_cur)
        draws.append(theta)
        accepted += accept
    return np.stack(draws, axis=1), accepted


def _dense_case(d, chains, draws, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(d, d)
    prec = (a @ a.T / d + np.eye(d)).astype(np.float32)
    mean = rng.randn(d).astype(np.float32)
    theta0 = rng.randn(chains, d).astype(np.float32)
    return (theta0, prec, mean, rng.randn(draws, chains, d).astype(np.float32),
            rng.rand(draws, chains).astype(np.float32))


@pytest.mark.parametrize("truncate", [False, True], ids=["nearest", "truncated"])
def test_three_tf32_products_hold_the_sampler_gate_at_d128(truncate):
    draws, steps, eps = 20, 6, 0.2
    theta0, prec, mean, z, u = _dense_case(128, 64, draws, 4)
    got, got_acc = emulated_sampler(theta0, prec, mean, z, u, steps, eps, truncate=truncate)
    want, want_acc = gaussian_hmc_reference(
        0, torch.as_tensor(theta0), torch.as_tensor(prec), draws, steps, eps,
        mean=torch.as_tensor(mean), _noise=(torch.as_tensor(z), torch.as_tensor(u)))
    assert np.array_equal(got_acc, np.round(want_acc.numpy() * draws))
    assert 0.0 < float(want_acc.mean()) < 1.0  # both Metropolis outcomes occur
    assert np.abs(got - want.numpy()).max() <= ATOL
    # the comparison sees the gradient: a 1%-wrong precision moves the draws
    wrong, _ = gaussian_hmc_reference(
        0, torch.as_tensor(theta0), torch.as_tensor(1.01 * prec), draws, steps, eps,
        mean=torch.as_tensor(mean), _noise=(torch.as_tensor(z), torch.as_tensor(u)))
    assert float((wrong - want).abs().max()) >= 100 * ATOL


def test_one_tf32_product_breaks_the_sampler_gate_at_d128():
    draws, steps, eps = 5, 6, 0.2
    theta0, prec, mean, z, u = _dense_case(128, 16, draws, 4)
    got, _ = emulated_sampler(theta0, prec, mean, z, u, steps, eps, terms=1)
    want, _ = gaussian_hmc_reference(
        0, torch.as_tensor(theta0), torch.as_tensor(prec), draws, steps, eps,
        mean=torch.as_tensor(mean), _noise=(torch.as_tensor(z), torch.as_tensor(u)))
    assert np.abs(got - want.numpy()).max() > 10 * ATOL


def test_emulated_split_matches_tf32_rounding():
    a = np.random.RandomState(1).randn(1000).astype(np.float32)
    big, small = split(a)
    assert np.array_equal(big, tf32_rna(a))
    assert np.abs((big.astype(np.float64) + small) - a).max() <= np.abs(a).max() * 2.0**-21


@pytest.mark.parametrize("d,dense", GAUSSIAN_CASES + WIDE_CASES)
def test_card_cases_have_no_knife_edge_decision(d, dense):
    draws, steps, eps = GAUSSIAN_RUN.values()
    theta0, prec, mean, noise = gaussian_case(d, dense, "cpu")
    margin, replay = _min_accept_margin(theta0, prec, draws, steps, eps, mean, noise)
    want, _ = gaussian_hmc_reference(0, theta0, prec, draws, steps, eps, mean=mean, _noise=noise)
    assert torch.equal(replay, want)
    assert margin >= 1e-4


@pytest.mark.parametrize("d,dense,chains,per_block", WIDE_BLOCK_CASES)
def test_wide_block_cases_have_no_knife_edge_decision(d, dense, chains, per_block):
    draws, steps, eps = GAUSSIAN_RUN.values()
    theta0, prec, mean, noise = gaussian_case(d, dense, "cpu", chains)
    margin, replay = _min_accept_margin(theta0, prec, draws, steps, eps, mean, noise)
    want, acc = gaussian_hmc_reference(0, theta0, prec, draws, steps, eps, mean=mean, _noise=noise)
    assert torch.equal(replay, want)
    assert margin >= 1e-4
    if per_block > 1:  # some chains of a block accept where others reject
        assert 0.0 < float(acc.mean()) < 1.0


@pytest.mark.parametrize("d,dense,chains,per_block", WIDE_BLOCK_CASES)
def test_wide_block_cases_run_the_block_size_they_name(d, dense, chains, per_block):
    plan = _plan(d, dense, 8, chains)
    assert (plan.variant, plan.group) == (5, per_block)
    _check_plan(plan, d, dense)
    assert per_block == 1 or chains % per_block != 0  # a partial last block


def _check_plan(plan, d, dense):
    assert 0 <= plan.shared <= MAX_SHARED
    assert 1 <= plan.consumers <= 8
    if plan.variant == 5:  # any D: chains per block in `group`, the state in shared memory
        assert d > 256 or (dense and d > 240)
        assert plan.group in (1, 2, 4, 8) and plan.consumers == WIDE_WARPS
        assert plan.chains_per_warp == 0 and plan.shared == _wide_shared(d, dense, plan.group)
        return
    assert plan.variant == 4 or 1 <= plan.chains_per_warp <= 32 // plan.group
    if plan.variant == 1:
        assert d <= 8 and d <= plan.group <= 8 and plan.consumers == 1
    elif plan.variant == 2:
        assert 8 < d <= 32 and plan.group >= d and plan.consumers <= 4
    elif plan.variant == 4:
        assert dense and 32 < d <= MMA_MAX_D and plan.consumers in (4, 8)
    else:
        assert plan.variant == 3
        assert d > 32 and plan.group == 32 and plan.chains_per_warp == 1
        assert not dense or d > MMA_MAX_D


@pytest.mark.parametrize("dense", [False, True], ids=["diagonal", "dense"])
@pytest.mark.parametrize("d", range(1, 257))
def test_plan_fits_shared_memory_or_refuses(d, dense):
    for chain_tile in (1, 8, 32):
        plan = _plan(d, dense, chain_tile, chains=1024 if chain_tile < 32 else 10**6)
        if dense and d > 240:
            assert plan.variant == 5  # (D + 1) D floats no longer fit variant 3's block
        _check_plan(plan, d, dense)


@pytest.mark.parametrize("dense", [False, True], ids=["diagonal", "dense"])
@pytest.mark.parametrize("first", range(257, 4097, 256))
def test_plan_takes_every_wide_d(first, dense):
    """D = 257..4096 in 15 slices of 256: every D gets variant 5, whatever
    the chain count and chain_tile, and never the refusal."""
    for d in range(first, first + 256):
        for chains, chain_tile in ((1, 1), (37, 8), (1024, 8), (10**6, 33)):
            plan = _plan(d, dense, chain_tile, chains)
            assert plan.variant == 5, (d, chains)
            _check_plan(plan, d, dense)


@pytest.mark.parametrize("d,dense,chain_tile", [(0, False, 8), (3, False, 0), (241, True, 0),
                                                (9677, True, 8), (11613, False, 8)])
def test_plan_refuses_what_the_kernel_does_not_take(d, dense, chain_tile):
    assert _plan(d, dense, chain_tile, chains=4).variant == 0


def test_plan_does_not_depend_on_chain_tile_where_it_is_a_hint():
    # the tensor-core and any-D variants fix their blocks; the others only bound their warps
    assert _plan(128, True, 1, 1024) == _plan(128, True, 32, 1024)
    assert _plan(300, False, 1, 1024) == _plan(300, False, 32, 1024)
    assert _plan(3, False, 33, 4) == _plan(3, False, 32, 4)
    assert _plan(238, True, 8, 1024).consumers == 6  # shrunk so that P and the rows fit
    assert _plan(200, False, 32, 10**6).consumers == 8


def test_wide_plan_spreads_chains_and_fits_shared_memory():
    assert _plan(1024, True, 8, 64).group == 1  # 64 blocks for 132 SMs
    assert _plan(1024, True, 8, 1024).group == 8  # 128 blocks: P read once serves 8 chains
    assert _plan(1024, True, 8, 10**6).group == 8  # at most 8 chains a block
    assert _plan(4096, True, 8, 1024).group == 2
    assert _plan(9676, True, 8, 1024).group == 1
