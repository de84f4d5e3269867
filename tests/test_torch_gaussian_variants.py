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
(b) The any-D variant's dense kernel computes the same product with the
    chains as the N of ``P^T Delta^T``, both operands split as they are read,
    big*big and big*small + small*big in two accumulators reset every 64
    rows of P, the 64-row partials added in order (``grid_product``).  The
    same gates hold at D = 1024 and 4096, and a single tf32 pass breaks them.
(c) The card tests' Gaussian cases (``tests/test_torch_gpu.py``) compare accept
    counts; here, without a card, each case's closest Metropolis decision is
    shown to be far from a knife edge that float32 rounding could tip.
(d) ``_plan`` (the wrapper's choice of kernel variant, block shape and
    shared-memory bytes) over every D = 1..4096, diagonal and dense, and
    every diagonal D up to 12,288: a variant within the 232,448 bytes a
    block may use; only a diagonal D beyond the any-D variant's range
    (12,288; dense P has none), a D below 1 and a chain_tile below 1 are
    refused.
"""

import numpy as np
import pytest
import torch

from hamiltorch_tpu_torch.kernels.gaussian_hmc import (
    DENSE_CHAIN_TILES,
    DIAG_MAX_D,
    DIAG_WIDE_MAX_D,
    DIAG_WIDE_WARPS,
    MAX_SHARED,
    MMA_MAX_D,
    WIDE_WARPS,
    _dense_shared,
    _diag_wide_shared,
    _plan,
    gaussian_hmc_reference,
)
from test_torch_gpu import (GAUSSIAN_CASES, GAUSSIAN_RUN, WIDE_BLOCK_CASES, WIDE_CASES,
                            _min_accept_margin, gaussian_case)
from test_torch_tf32_split import split, tf32_rna

ATOL = 1e-5


def _to_float32(acc64, truncate):
    """float64 -> float32 to nearest, or toward zero (the 29 low bits of the
    float64 mantissa dropped first: exact at float32's normal range)."""
    if truncate:
        bits = np.asarray(acc64, np.float64).view(np.int64) & ~np.int64(2**29 - 1)
        acc64 = bits.view(np.float64)
    return acc64.astype(np.float32)


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


def emulated_sampler(theta0, prec, mean, momenta, uniforms, steps, eps, product=None, **kw):
    """The kernel's draw loop in float32 numpy with the emulated gradient:
    ``-product(theta - mean)``, by default the tensor-core variant's
    ``mma_matvec`` on P split once."""
    f = np.float32
    if product is None:
        p_big, p_small = split(prec)
        if kw.get("terms") == 1:
            p_small = np.zeros_like(p_big)

        def product(delta):
            return mma_matvec(delta, p_big, p_small, **kw)

    def grad(th):
        return -product((th - mean).astype(f))

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


def grid_product(prec, terms=3, truncate=True):
    """(C, D) @ P as the any-D variant's dense kernel computes it, as a
    function of theta - mean: G^T = P^T Delta^T on mma.sync.m16n8k8, both
    operands split as they are read (big to nearest, the small part's low 13
    bits dropped), per k8 slice big*big into one accumulator and big*small
    then small*big into another, each reset every 64 rows of P (a chunk) and
    accumulated to nearest or truncated; the chunks' two sums added, then
    added in order into a float32 total, to nearest."""
    d = prec.shape[0]
    n = -(-d // 64)

    def by_slice(a):  # (chunk, k8 slice, rows, 8): the slices of a's columns, padded with 0
        a = np.pad(a, ((0, 0), (0, 64 * n - d)))
        return np.ascontiguousarray(a.reshape(len(a), n, 8, 8).transpose(1, 2, 0, 3))

    a_big, a_small = (by_slice(x.astype(np.float64))
                      for x in split_truncated(np.ascontiguousarray(prec.T)))

    def product(delta):
        b_big, b_small = (by_slice(x.astype(np.float64)).transpose(0, 1, 3, 2)
                          for x in split_truncated(delta))
        acc_b = np.zeros((n, d, len(delta)), np.float32)
        acc_s = np.zeros_like(acc_b)
        bb = np.matmul(a_big, b_big)  # each slice's exact product: tf32 x tf32, 8 terms
        if terms == 3:
            bs, sb = np.matmul(a_big, b_small), np.matmul(a_small, b_big)
        for s in range(8):
            acc_b = _to_float32(acc_b + bb[:, s], truncate)
            if terms == 3:
                acc_s = _to_float32(acc_s + bs[:, s], truncate)
                acc_s = _to_float32(acc_s + sb[:, s], truncate)
        total = np.zeros((d, len(delta)), np.float32)
        for j in range(n):
            total = total + (acc_b[j] + acc_s[j])
        return total.T

    return product


def _grid_case(d, chains, draws, seed, rank=256):
    """A dense SPD precision I + B B^T / D (B of rank 256: eigenvalues in [1,
    ~2.6] at D = 4096, cheap to build) and the run's inputs."""
    rng = np.random.RandomState(seed)
    b = rng.randn(d, rank)
    prec = (np.eye(d) + b @ b.T / d).astype(np.float32)
    mean = rng.randn(d).astype(np.float32)
    theta0 = rng.randn(chains, d).astype(np.float32)
    return (theta0, prec, mean, rng.randn(draws, chains, d).astype(np.float32),
            rng.rand(draws, chains).astype(np.float32))


# (D, chains, draws, L, step, seed): both Metropolis outcomes occur, none near an edge
GRID_CASES = {"d1024": (1024, 8, 4, 5, 0.3, 1), "d4096": (4096, 2, 3, 3, 0.35, 3)}


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


@pytest.mark.parametrize("truncate", [False, True], ids=["nearest", "truncated"])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_product_holds_the_sampler_gate(case, truncate):
    d, chains, draws, steps, eps, seed = GRID_CASES[case]
    theta0, prec, mean, z, u = _grid_case(d, chains, draws, seed)
    got, got_acc = emulated_sampler(theta0, prec, mean, z, u, steps, eps,
                                    product=grid_product(prec, truncate=truncate))
    args = [torch.as_tensor(x) for x in (theta0, prec, mean)]
    noise = (torch.as_tensor(z), torch.as_tensor(u))
    want, want_acc = gaussian_hmc_reference(0, *args[:2], draws, steps, eps, mean=args[2],
                                            _noise=noise)
    margin, replay = _min_accept_margin(*args[:2], draws, steps, eps, args[2], noise)
    assert torch.equal(replay, want) and margin >= 1e-4
    assert np.array_equal(got_acc, np.round(want_acc.numpy() * draws))
    assert 0.0 < float(want_acc.mean()) < 1.0  # both Metropolis outcomes occur
    assert np.abs(got - want.numpy()).max() <= ATOL
    # the comparison sees the gradient: a 1%-wrong precision moves the draws
    wrong, _ = gaussian_hmc_reference(0, args[0], 1.01 * args[1], draws, steps, eps,
                                      mean=args[2], _noise=noise)
    assert float((wrong - want).abs().max()) >= 100 * ATOL


def test_one_tf32_pass_breaks_the_grid_product_gate():
    d, chains, draws, steps, eps, seed = GRID_CASES["d1024"]
    theta0, prec, mean, z, u = _grid_case(d, chains, draws, seed)
    got, _ = emulated_sampler(theta0, prec, mean, z, u, steps, eps,
                              product=grid_product(prec, terms=1))
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
    if 1 < per_block < chains:  # some chains of a block or tile accept where others reject
        assert 0.0 < float(acc.mean()) < 1.0


@pytest.mark.parametrize("d,dense,chains,per_block", WIDE_BLOCK_CASES)
def test_wide_block_cases_run_the_block_size_they_name(d, dense, chains, per_block):
    plan = _plan(d, dense, 8, chains)
    assert (plan.variant, plan.group) == (5, per_block)
    _check_plan(plan, d, dense)
    assert per_block == 1 or chains % per_block != 0  # a partial last block or tile of chains


def _check_plan(plan, d, dense):
    assert 0 <= plan.shared <= MAX_SHARED
    if plan.variant == 5:  # any D
        assert d > 256 or (dense and d > 240)
        if dense:  # tiles of 128 rows by `group` chains across one grid
            assert plan.consumers == WIDE_WARPS and plan.group in DENSE_CHAIN_TILES
            assert plan.chains_per_warp == 0 and plan.shared == _dense_shared(plan.group)
        elif d <= DIAG_MAX_D:  # `group` chains a block of 8 warps, the state in registers
            assert plan.consumers == WIDE_WARPS
            assert plan.group in (1, 2, 4, 8) and plan.chains_per_warp in (1, 2, 4)
            assert 4 * plan.chains_per_warp * (256 // plan.group) >= d and plan.shared == 0
            # the fewest groups of 4 elements a thread that a team of 256 threads takes
            assert plan.chains_per_warp == 1 or 2 * plan.chains_per_warp * 256 < d
        else:  # a chain a block of 32 warps, the state in registers, mean and P shared
            assert d <= DIAG_WIDE_MAX_D and plan.consumers == DIAG_WIDE_WARPS
            assert plan.group == 1 and plan.chains_per_warp in (2, 3)
            # the fewest groups of 4 elements a thread of 1024 that take D
            assert 4 * 1024 * (plan.chains_per_warp - 1) < d <= 4 * 1024 * plan.chains_per_warp
            assert plan.shared == _diag_wide_shared(plan.chains_per_warp)
        return
    assert 1 <= plan.consumers <= 8
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


@pytest.mark.parametrize("first", range(4097, DIAG_WIDE_MAX_D + 1, 512))
def test_plan_takes_every_diagonal_d_beyond_4096(first):
    """Diagonal D = 4097..12,288 in 16 slices of 512: a chain a block of 1024
    threads, whatever the chain count and chain_tile."""
    for d in range(first, first + 512):
        for chains, chain_tile in ((1, 1), (1024, 8), (10**6, 33)):
            plan = _plan(d, False, chain_tile, chains)
            assert plan.variant == 5, (d, chains)
            _check_plan(plan, d, False)


@pytest.mark.parametrize("d,dense,chain_tile", [(0, False, 8), (3, False, 0), (241, True, 0),
                                                (0, True, 8), (DIAG_WIDE_MAX_D + 1, False, 8)])
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
    assert _plan(1024, True, 8, 64).group == 8  # 64 tiles of 8 chains for 132 SMs
    assert _plan(1024, True, 8, 1024).group == 64  # 128 tiles: a byte of P serves 64 chains
    assert _plan(1024, True, 8, 10**6).group == 64  # at most 64 chains a tile
    assert _plan(4096, True, 8, 5).group == 8  # 32 tiles: P read once a step across the grid
    assert _plan(2048, True, 8, 201).group == 32  # 112 tiles, one wave
    assert _plan(9676, True, 8, 1024).group == 64
    assert _plan(9677, True, 8, 3)[:2] == (5, 8)  # the former design's bound: no longer one
    assert _plan(40000, True, 8, 3)[:2] == (5, 8)  # dense P at any D
    assert _plan(1024, False, 8, 1024)[1:4] == (1, WIDE_WARPS, 1)  # 256 threads, 4 elements each
    assert _plan(300, False, 8, 1024)[1:4] == (2, WIDE_WARPS, 1)  # 2 teams of 128 threads a block
    assert _plan(4096, False, 8, 8)[1:4] == (1, WIDE_WARPS, 4)  # 16 elements a thread
    # beyond 4096: a chain a block of 1024 threads, 8 or 12 elements each
    assert _plan(4097, False, 8, 1024)[1:] == (1, DIAG_WIDE_WARPS, 2, _diag_wide_shared(2))
    assert _plan(11612, False, 8, 1024)[1:] == (1, DIAG_WIDE_WARPS, 3, _diag_wide_shared(3))
