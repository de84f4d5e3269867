"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  They import no JAX,
so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest`` skips the suite's JAX set-up in ``tests/conftest.py``.)
Tolerances: parameters (and Gaussian draws) after a few draws differ only
by float32 rounding of differently ordered sums (~1e-7), so atol 1e-5;
accept decisions must be identical (energies are reduced in float64 on both
sides).  MCLMC's var_e is a float64 sum of dE^2 on both sides, where dE is
a difference of logp sums near the state; rtol 1e-3 (also from a velocity
anti-parallel to the gradient at a step where the first rotation's zeta is
at most 0.05).  One gradient alone
(``_bnn_gradient``, the GEMM pair in 3xTF32 on the tensor cores) is held
to 1e-5 of the largest gradient entry and logp to 1e-6 relative: float32
products summed over N or I terms in another order.
"""

import numpy as np
import pytest
import torch

from hamiltorch_tpu_torch.kernels import (
    bnn_hmc,
    bnn_hmc_reference,
    bnn_mclmc,
    bnn_mclmc_reference,
    gaussian_hmc,
    gaussian_hmc_reference,
)
from hamiltorch_tpu_torch.kernels.bnn_grad import (
    CONSUMERS,
    _bnn_gradient,
    _bnn_gradient_reference,
    _grids,
)
from hamiltorch_tpu_torch.kernels.bnn_grad import _plan as bnn_plan
from hamiltorch_tpu_torch.kernels.gaussian_hmc import _energy, _grad, _plan
from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree
from hamiltorch_tpu_torch.samplers.driver import MCMCConfig
from hamiltorch_tpu_torch.samplers.hmc import run_hmc_chains


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bnn_args(i_dim, h, n, c, seed, device):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(n, i_dim), rng.randn(n, 1), 0.01 * rng.randn(c, i_dim, h),
              0.01 * rng.randn(c, h), 0.01 * rng.randn(c, h), 0.01 * rng.randn(c))
    return [torch.as_tensor(a.astype(np.float32)).to(device) for a in arrays]


# (I, H, N, C): besides the small, wide and flagship shapes, more chains than
# SMs at small N (the persistent GEMMs' walks have a tail) and ragged N and I
# at H = 384
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 128, 100, 3), (784, 256, 200, 2), (784, 128, 1024, 4),
                                   (784, 128, 100, 133), (785, 384, 1023, 2)])
def test_bnn_hmc_kernel_matches_plain_version(cuda_device, shape):
    i_dim, h, n, c = shape
    rng = np.random.RandomState(5)
    noise = (torch.as_tensor(rng.randn(3, c, i_dim * h + 2 * h + 1).astype(np.float32)).to(cuda_device),
             torch.as_tensor(rng.rand(3, c).astype(np.float32)).to(cuda_device))
    kw = dict(num_samples=3, num_steps=4, step_size=0.01, tau=10.0, _noise=noise)
    before = bnn_hmc.launches
    got = bnn_hmc(0, *bnn_args(i_dim, h, n, c, 4, cuda_device), **kw)
    want = bnn_hmc_reference(0, *bnn_args(i_dim, h, n, c, 4, cuda_device), **kw)
    torch.cuda.synchronize()
    assert bnn_hmc.launches == before + 1
    assert torch.equal(got[4], want[4])
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_bnn_hmc_kernel_philox_is_deterministic_and_finite(cuda_device):
    args = bnn_args(784, 128, 1024, 8, 6, cuda_device)
    kw = dict(num_samples=4, num_steps=10, step_size=2e-4, tau=10.0)
    a, b, other = bnn_hmc(3, *args, **kw), bnn_hmc(3, *args, **kw), bnn_hmc(4, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], other[0])
    assert all(bool(torch.isfinite(t).all()) for t in a)
    assert not torch.equal(a[0][0], a[0][1])  # chains draw different momenta


@pytest.mark.gpu
def test_run_hmc_chains_on_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(2)
    z, log_u = torch.randn(5, 4, 41, generator=gen), torch.rand(5, 4, generator=gen).log()
    cfg = MCMCConfig(num_samples=5, num_steps_per_sample=5, step_size=0.05)
    lp_d, p_d = make_flagship_potential_tree(8, 4, 16, device=cuda_device)
    lp_h, p_h = make_flagship_potential_tree(8, 4, 16, device="cpu")
    on_card = run_hmc_chains(0, lp_d, p_d, cfg, 4, _noise=(z.to(cuda_device), log_u.to(cuda_device)))
    on_host = run_hmc_chains(0, lp_h, p_h, cfg, 4, _noise=(z, log_u))
    assert torch.equal(on_card.stats.accepted.cpu(), on_host.stats.accepted)
    for k in on_host.samples:
        torch.testing.assert_close(on_card.samples[k].cpu(), on_host.samples[k], atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_bnn_hmc_kernel_raises_on_shapes_it_does_not_take(cuda_device):
    before = bnn_hmc.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        bnn_hmc(0, *bnn_args(50, 64, 100, 2, 4, cuda_device), num_samples=1, num_steps=1)
    assert bnn_hmc.launches == before


# The backward's epilogue at its edges (it reads a batch of steps before its
# stores): I odd, so a thread's last step in the last I tile is one float
# (337 = 3 x 112 + 1, 113 = 112 + 1), and no multiple of 112; tiles that the
# blocks' consumers do not share evenly (337 at 35 chains: 280 tiles on 94
# blocks; 113 at 3 chains: a tile a block, so every second consumer has
# none); 3 steps a draw, so drifting steps and the last one both run.
EPILOGUE_SHAPES = [(337, 128, 150, 35), (113, 256, 97, 3)]


def backward_walks_are_ragged(shape, device) -> bool:
    i_dim, h, n, c = shape
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    plan = bnn_plan(n, i_dim, h, c, sm_count)
    return plan.bwd_tiles % (CONSUMERS * plan.bwd_grid) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_bnn_hmc_epilogue_edges_match_plain_version(cuda_device, shape):
    i_dim, h, n, c = shape
    assert i_dim % 2 == 1 and i_dim % 112 != 0 and backward_walks_are_ragged(shape, cuda_device)
    rng = np.random.RandomState(8)
    noise = (torch.as_tensor(rng.randn(2, c, i_dim * h + 2 * h + 1).astype(np.float32)).to(cuda_device),
             torch.as_tensor(rng.rand(2, c).astype(np.float32)).to(cuda_device))
    kw = dict(num_samples=2, num_steps=3, step_size=0.01, tau=10.0, _noise=noise)
    before = bnn_hmc.launches
    got = bnn_hmc(0, *bnn_args(i_dim, h, n, c, 9, cuda_device), **kw)
    want = bnn_hmc_reference(0, *bnn_args(i_dim, h, n, c, 9, cuda_device), **kw)
    torch.cuda.synchronize()
    assert bnn_hmc.launches == before + 1
    assert torch.equal(got[4], want[4])
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def hold_mclmc_against_plain_version(args, u, draws, eps, length=10.0):
    """bnn_mclmc vs its plain version on the same refresh normals: one
    launch, parameters within 1e-5, var_e within 1e-3 relative."""
    c, d = u.shape
    rng = np.random.RandomState(5)
    noise = torch.as_tensor(rng.randn(draws, c, d).astype(np.float32)).to(u.device)
    kw = dict(num_samples=draws, step_size=eps, length=length, tau=10.0, _noise=noise)
    before = bnn_mclmc.launches
    got = bnn_mclmc(0, *args, u, **kw)
    want = bnn_mclmc_reference(0, *args, u, **kw)
    torch.cuda.synchronize()
    assert bnn_mclmc.launches == before + 1
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=1e-3)


# small and flagship; a ragged last I tile (113 = 112 + 1); N = 100 at C = 1.
# At N = 100 and I = 784 a step of 2 leaves var_e at 2.8e-9, its dE (~0.02)
# within a few thousandths of the float32 rounding of logp, and kernel and
# plain version then differ by 1.3e-3 in var_e, the former design of the
# kernel as much as this one; a step of 5 lifts var_e to 1.7e-6.
MCLMC_STEP = {(784, 128, 100, 1): 5.0}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 128, 100, 3), (784, 128, 1024, 4), (113, 128, 200, 3),
                                   (784, 128, 100, 1), (50, 128, 1023, 133), (785, 256, 1000, 2)])
def test_bnn_mclmc_kernel_matches_plain_version(cuda_device, shape):
    i_dim, h, n, c = shape
    d = i_dim * h + 2 * h + 1
    rng = np.random.RandomState(5)
    u = torch.as_tensor(rng.randn(c, d).astype(np.float32)).to(cuda_device)
    hold_mclmc_against_plain_version(bnn_args(i_dim, h, n, c, 4, cuda_device), u, 5,
                                     MCLMC_STEP.get(shape, 2.0))


# the first pass normalises the given velocity by its own norm, whatever it is
@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-4, 1e3])
def test_bnn_mclmc_kernel_takes_a_velocity_that_is_not_unit(cuda_device, scale):
    i_dim, h, n, c = 784, 128, 1024, 4
    d = i_dim * h + 2 * h + 1
    u = torch.as_tensor((scale * np.random.RandomState(7).randn(c, d)).astype(np.float32))
    hold_mclmc_against_plain_version(bnn_args(i_dim, h, n, c, 4, cuda_device), u.to(cuda_device),
                                     5, 2.0)


# u = -g/|g| and zeta <= 0.05 in the first rotation: there ce g nearly cancels
# 2 zeta u, and the kernel takes |w| from the dots (targets 10 above the
# output and w2 of O(1) make |g| large, so that the step stays below ~2)
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 128, 100, 3), (784, 128, 1024, 4)])
def test_bnn_mclmc_kernel_from_an_anti_parallel_velocity(cuda_device, shape):
    i_dim, h, n, c = shape
    x, y, w1, b1, w2, b2 = bnn_args(i_dim, h, n, c, 4, cuda_device)
    y, w2 = y + 10.0, 100.0 * w2
    theta = torch.cat([t.reshape(c, -1) for t in (w1, b1, w2, b2)], dim=1)
    g, _ = _bnn_gradient_reference(x, y, theta, tau=10.0)
    g_norm = g.double().norm(dim=1)
    u = (-g.double() / g_norm[:, None]).float()
    d = u.shape[1]
    eps = float((-np.log(0.04) * (d - 1) / (0.1931833275037836 * g_norm)).max())
    assert float(torch.exp(-0.1931833275037836 * eps * g_norm / (d - 1)).max()) <= 0.05
    hold_mclmc_against_plain_version((x, y, w1, b1, w2, b2), u, 2, eps, length=5.0 * eps)


@pytest.mark.gpu
def test_bnn_mclmc_kernel_philox_is_deterministic_and_finite(cuda_device):
    args = bnn_args(784, 128, 1024, 4, 6, cuda_device)
    u = torch.randn(4, 784 * 128 + 257, device=cuda_device)
    kw = dict(num_samples=4, step_size=0.5, length=10.0, tau=10.0)
    a, b, other = bnn_mclmc(3, *args, u, **kw), bnn_mclmc(3, *args, u, **kw), bnn_mclmc(4, *args, u, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], other[0])
    assert all(bool(torch.isfinite(t).all()) for t in a)


# (I, H, N, C): the small, wide and flagship shapes; one chain; more tiles
# than SMs with a tail at small N; ragged N (1000, 1023) and I (50, 785); H =
# 256 and 384
GRADIENT_SHAPES = [(50, 128, 100, 3), (784, 256, 200, 2), (784, 128, 1024, 64),
                   (784, 128, 1024, 1), (784, 128, 100, 133), (784, 128, 100, 200),
                   (784, 128, 1000, 4), (50, 128, 1023, 3), (785, 128, 200, 5),
                   (785, 384, 1000, 5), (50, 256, 1023, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRADIENT_SHAPES)
def test_bnn_gradient_kernel_matches_plain_version(cuda_device, shape):
    i_dim, h, n, c = shape
    x, y, *parts = bnn_args(i_dim, h, n, c, 4, cuda_device)
    theta = torch.cat([t.reshape(c, -1) for t in parts], dim=1).contiguous()
    before = _bnn_gradient.launches
    g, logp = _bnn_gradient(x, y, theta, tau=10.0)
    want_g, want_logp = _bnn_gradient_reference(x, y, theta, tau=10.0)
    torch.cuda.synchronize()
    assert _bnn_gradient.launches == before + 1
    assert float((g - want_g).abs().max()) <= 1e-5 * float(want_g.abs().max())
    assert float(((logp - want_logp) / want_logp).abs().max()) <= 1e-6
    fwd_grid, bwd_grid = _grids(n, i_dim, h, c, cuda_device)
    sm_count = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 1 <= fwd_grid <= sm_count and 1 <= bwd_grid <= sm_count


# the backward's other callers at a ragged shape of EPILOGUE_SHAPES: the one
# gradient (no p) and MCLMC's dots against the velocity (step 5: var_e
# 6e-5 - 2.3e-4, float32's rounding 1.2e-5 of it)
@pytest.mark.gpu
def test_bnn_gradient_and_mclmc_epilogues_at_a_ragged_shape(cuda_device):
    i_dim, h, n, c = EPILOGUE_SHAPES[0]
    x, y, *parts = bnn_args(i_dim, h, n, c, 4, cuda_device)
    theta = torch.cat([t.reshape(c, -1) for t in parts], dim=1).contiguous()
    g, logp = _bnn_gradient(x, y, theta, tau=10.0)
    want_g, want_logp = _bnn_gradient_reference(x, y, theta, tau=10.0)
    torch.cuda.synchronize()
    assert float((g - want_g).abs().max()) <= 1e-5 * float(want_g.abs().max())
    assert float(((logp - want_logp) / want_logp).abs().max()) <= 1e-6
    u = torch.as_tensor(np.random.RandomState(5).randn(c, theta.shape[1]).astype(np.float32))
    hold_mclmc_against_plain_version((x, y, *parts), u.to(cuda_device), 5, 5.0)


# every partial sum lies in a slot fixed by its tile: two calls agree bit for bit
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(784, 128, 1024, 64), (784, 128, 100, 133), (785, 384, 1000, 5)])
def test_bnn_gradient_kernel_repeats_bit_for_bit(cuda_device, shape):
    i_dim, h, n, c = shape
    x, y, *parts = bnn_args(i_dim, h, n, c, 5, cuda_device)
    theta = torch.cat([t.reshape(c, -1) for t in parts], dim=1).contiguous()
    g1, logp1 = _bnn_gradient(x, y, theta, tau=10.0)
    g2, logp2 = _bnn_gradient(x, y, theta, tau=10.0, repeats=3)
    assert torch.equal(g1, g2) and torch.equal(logp1, logp2)


@pytest.mark.gpu
def test_bnn_gradient_kernel_raises_on_shapes_it_does_not_take(cuda_device):
    x, y, *parts = bnn_args(50, 64, 100, 2, 4, cuda_device)
    theta = torch.cat([t.reshape(2, -1) for t in parts], dim=1).contiguous()
    before = _bnn_gradient.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        _bnn_gradient(x, y, theta)
    assert _bnn_gradient.launches == before


def _dense_precision(d, seed):
    a = np.random.RandomState(seed).randn(d, d)
    return (a @ a.T / d + np.eye(d)).astype(np.float32)


def _min_accept_margin(theta0, prec, draws, steps, eps, mean, noise):
    """The plain version's draw loop once more, returning its draws and the
    least |(h0 - h1) - log u| over every chain and draw: how far the closest
    Metropolis decision is from the other outcome."""
    theta, g_cur, least, out = theta0, _grad(theta0, mean, prec), float("inf"), []
    for z, u in zip(*noise):
        h0 = _energy(theta, mean, g_cur, z)
        p = z + (0.5 * eps) * g_cur
        th, g = theta, g_cur
        for _ in range(steps):
            th = th + eps * p
            g = _grad(th, mean, prec)
            p = p + eps * g
        p = p - (0.5 * eps) * g
        margin = (h0 - _energy(th, mean, g, p)) - torch.log(u.double())
        least = min(least, float(margin.abs().min()))
        theta = torch.where((margin >= 0)[:, None], th, theta)
        g_cur = torch.where((margin >= 0)[:, None], g, g_cur)
        out.append(theta)
    return least, torch.stack(out, dim=1)


# The data of a case comes from RandomState(D), except where that seed puts a
# Metropolis decision on a knife edge: dense D=9 at seed 9 has a draw with
# margin 3e-7, within the float32 rounding of the state, so that kernel and
# plain version may rightly decide it differently.
_CASE_SEED = {(9, True): 1009}


GAUSSIAN_CASES = [
    (3, False), (40, False), (200, False), (2, True), (5, True), (128, True),
    # the edges of the variants: 2 to 32 lanes per chain, a warp per chain; dense
    # on the tensor cores up to D=128 and by float32 FMA beyond, up to D=240
    (1, False), (4, False), (5, False), (8, False), (9, False), (16, False), (17, False),
    (32, False), (33, False), (256, False),
    (1, True), (4, True), (8, True), (9, True), (10, True), (20, True), (32, True), (33, True),
    (70, True), (100, True), (129, True), (160, True), (240, True)]
GAUSSIAN_RUN = dict(draws=10, steps=6, eps=0.3)


def gaussian_case(d, dense, device, chains=37):
    """(theta0, precision, mean, (momenta, uniforms)) of a case."""
    c, draws = chains, GAUSSIAN_RUN["draws"]
    seed = _CASE_SEED.get((d, dense), d)
    rng = np.random.RandomState(seed)
    prec = _dense_precision(d, seed) if dense else rng.uniform(0.25, 4.0, d).astype(np.float32)
    mean = rng.randn(d).astype(np.float32)
    noise = (torch.as_tensor(rng.randn(draws, c, d).astype(np.float32)).to(device),
             torch.as_tensor(rng.rand(draws, c).astype(np.float32)).to(device))
    theta0 = rng.randn(c, d).astype(np.float32)
    return tuple(torch.as_tensor(a).to(device) for a in (theta0, prec, mean)) + (noise,)


def hold_against_plain_version(device, d, dense, chains=37):
    draws, steps, eps = GAUSSIAN_RUN.values()
    *args, mean, noise = gaussian_case(d, dense, device, chains)
    kw = dict(mean=mean, _noise=noise)
    before = gaussian_hmc.launches
    got, got_acc = gaussian_hmc(0, *args, draws, steps, eps, **kw)
    want, want_acc = gaussian_hmc_reference(0, *args, draws, steps, eps, **kw)
    torch.cuda.synchronize()
    assert gaussian_hmc.launches == before + 1
    # no decision of this case is a knife edge (float32 rounding moves h0 - h1 by
    # ~1e-6), so the accept counts below are compared on firm ground
    margin, replay = _min_accept_margin(*args, draws, steps, eps, mean, noise)
    assert torch.equal(replay, want)
    assert margin >= 1e-4
    # identical accept counts (the rates may differ in the last bit: PyTorch
    # divides by a scalar on the card through its reciprocal)
    assert torch.equal(torch.round(got_acc * draws), torch.round(want_acc * draws))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense", GAUSSIAN_CASES)
def test_gaussian_hmc_kernel_matches_plain_version(cuda_device, d, dense):
    hold_against_plain_version(cuda_device, d, dense)


@pytest.mark.gpu
def test_gaussian_hmc_kernel_philox_is_deterministic(cuda_device):
    prec = torch.ones(3, device=cuda_device)
    theta0 = torch.zeros(16, 3, device=cuda_device)
    s1, _ = gaussian_hmc(7, theta0, prec, 50, 5, 0.3)
    s2, _ = gaussian_hmc(7, theta0, prec, 50, 5, 0.3)
    assert torch.equal(s1, s2)
    assert not torch.allclose(s1[0], s1[1])


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense", [(3, False), (20, True), (128, True), (200, False), (200, True)])
def test_gaussian_hmc_kernel_draws_do_not_depend_on_chain_tile(cuda_device, d, dense):
    prec = torch.as_tensor(_dense_precision(d, 1) if dense else np.linspace(0.5, 2.0, d,
                           dtype=np.float32)).to(cuda_device)
    theta0 = torch.zeros(37, d, device=cuda_device)
    runs = [gaussian_hmc(11, theta0, prec, 40, 4, 0.2, chain_tile=tile) for tile in (1, 8, 32, 8)]
    for samples, acc in runs[1:]:
        assert torch.equal(samples, runs[0][0]) and torch.equal(acc, runs[0][1])
    assert bool(torch.isfinite(runs[0][0]).all())
    assert 0.0 < float(runs[0][1].mean()) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense,tile", [(0, True, 8), (12289, False, 8)])
def test_gaussian_hmc_kernel_raises_on_shapes_it_does_not_take(cuda_device, d, dense, tile):
    """Only D = 0 and a diagonal D whose state no longer fits the registers
    of a block of 1024 threads are refused (by the kernel; dense P has no
    bound but the card's memory), and a chain_tile below 1 (by the
    wrapper)."""
    prec = torch.eye(d, device=cuda_device) if dense else torch.ones(d, device=cuda_device)
    before = gaussian_hmc.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        gaussian_hmc(0, torch.zeros(4, d, device=cuda_device), prec, 2, 2, 0.1, chain_tile=tile)
    with pytest.raises(ValueError, match="chain_tile"):
        gaussian_hmc(0, torch.zeros(4, 3, device=cuda_device), torch.ones(3, device=cuda_device),
                     2, 2, 0.1, chain_tile=0)
    assert gaussian_hmc.launches == before


# the any-D variant (5): diagonal D > 256 and dense D > 240, ragged D included
WIDE_CASES = [(257, False), (512, False), (1000, False), (4096, False),
              (241, True), (256, True), (512, True), (1000, True)]


# (D, dense, chains, the plan's group): dense P in tiles of 128 rows by 8,
# 16, 32 or 64 chains, here each with a partial last tile of chains (and of
# rows where D is not a multiple of 128; D = 241, 513 and 4099 are not
# multiples of 4 either); diagonal P with the state in registers, 2 chains a
# block of 256 threads (one of them partial) or 1, holding 1, 2 or 4 groups
# of 4 elements a thread (D = 1000, 2000, 3001), and beyond D = 4096 a chain
# a block of 1024 threads of 2 or 3 groups (4099, 8193, 12,288)
WIDE_BLOCK_CASES = [(300, False, 201, 2), (257, False, 271, 2), (1000, False, 1061, 1),
                    (4099, False, 5, 1), (2048, True, 201, 32), (512, True, 270, 16),
                    (513, True, 530, 32), (4096, True, 5, 8), (4099, True, 3, 8),
                    (300, True, 1450, 64), (2000, False, 37, 1), (3001, False, 9, 1),
                    (8193, False, 3, 1), (12288, False, 2, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense", WIDE_CASES)
def test_gaussian_hmc_wide_variant_matches_plain_version(cuda_device, d, dense):
    hold_against_plain_version(cuda_device, d, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense,chains,per_block", WIDE_BLOCK_CASES)
def test_gaussian_hmc_wide_blocks_match_plain_version(cuda_device, d, dense, chains, per_block):
    assert _plan(d, dense, 8, chains)[:2] == (5, per_block)
    hold_against_plain_version(cuda_device, d, dense, chains)


@pytest.mark.gpu
def test_gaussian_hmc_dense_beyond_the_former_bound_draws_what_diagonal_p_draws(cuda_device):
    """Dense D = 9,800 (the former any-D design took 9,676 at most) with a
    diagonal P held as a (D, D) matrix: the grid's product on the tensor
    cores and the diagonal form (a chain a block of 1024 threads) both draw
    what the plain version draws, within 1e-5 and with the same accepts."""
    d, chains = 9800, 3
    draws, steps, eps = GAUSSIAN_RUN.values()
    theta0, prec, mean, noise = gaussian_case(d, False, "cpu", chains)
    margin, _ = _min_accept_margin(theta0, prec, draws, steps, eps, mean, noise)
    assert margin >= 1e-4
    theta0, prec, mean = (t.to(cuda_device) for t in (theta0, prec, mean))
    noise = tuple(t.to(cuda_device) for t in noise)
    kw = dict(mean=mean, _noise=noise)
    want, want_acc = gaussian_hmc_reference(0, theta0, prec, draws, steps, eps, **kw)
    for p in (torch.diag(prec), prec):
        got, got_acc = gaussian_hmc(0, theta0, p, draws, steps, eps, **kw)
        assert torch.equal(torch.round(got_acc * draws), torch.round(want_acc * draws))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dense", [(200, False), (192, True)])
def test_gaussian_hmc_forced_wide_variant_draws_what_variant_3_draws(cuda_device, d, dense):
    """At a shape that variant 3 runs, the any-D variant forced on it takes
    the same Philox normals and uniforms: the same samples and accepts."""
    prec = torch.as_tensor(_dense_precision(d, 1) if dense else np.linspace(0.25, 4.0, d,
                           dtype=np.float32)).to(cuda_device)
    theta0 = torch.as_tensor(np.random.RandomState(3).randn(64, d).astype(np.float32)).to(cuda_device)
    got, got_acc = gaussian_hmc(5, theta0, prec, 30, 6, 0.2, _variant=5)
    want, want_acc = gaussian_hmc(5, theta0, prec, 30, 6, 0.2)
    assert torch.equal(got_acc, want_acc) and 0.0 < float(want_acc.mean()) < 1.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_run_mams_chunked_equals_unchunked_on_card(cuda_device):
    from hamiltorch_tpu_torch.samplers.mams import MAMSConfig, run_mams

    prec = torch.as_tensor(_dense_precision(6, 2)).to(cuda_device)

    def lp(t):
        return -0.5 * t @ prec @ t

    cfg = dict(num_steps_per_sample=4, burn=5, step_size=0.3)
    theta0 = torch.ones(6, device=cuda_device)
    whole = run_mams(3, lp, theta0, MAMSConfig(num_samples=14, **cfg))
    first = run_mams(3, lp, theta0, MAMSConfig(num_samples=6, **cfg))
    second = run_mams(3, lp, first.final_theta, MAMSConfig(num_samples=8, **cfg),
                      init_da=first.final_da, start_step=int(first.final_step))
    assert whole.samples.is_cuda
    assert torch.equal(torch.cat([first.samples, second.samples]), whole.samples)
    assert torch.equal(second.step_size, whole.step_size)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["diag", "dense"])
def test_windowed_warmup_on_card_matches_cpu(cuda_device, mode):
    """run_hmc_chains with adapt_mass on a correlated 4-D Gaussian (one slow
    window, fixed step): the card's run equals the CPU's within 1e-5."""
    prec = torch.as_tensor(np.linalg.inv(_dense_precision(4, 7)).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    z, log_u = torch.randn(170, 3, 4, generator=gen), torch.rand(170, 3, generator=gen).log()
    cfg = MCMCConfig(num_samples=170, num_steps_per_sample=4, step_size=0.35, burn=160,
                     adapt_mass=mode)

    def run(device):
        p = prec.to(device)
        return run_hmc_chains(0, lambda t: -0.5 * t @ p @ t, torch.full((4,), 0.5, device=device),
                              cfg, 3, _noise=(z.to(device), log_u.to(device)))

    on_card, on_host = run(cuda_device), run("cpu")
    assert torch.equal(on_card.stats.accepted.cpu(), on_host.stats.accepted)
    torch.testing.assert_close(on_card.samples.cpu(), on_host.samples, atol=1e-5, rtol=0)
    metric = on_host.final_warm[1][0] if mode == "dense" else on_host.final_warm[1]
    card_metric = on_card.final_warm[1][0] if mode == "dense" else on_card.final_warm[1]
    torch.testing.assert_close(card_metric.cpu(), metric, atol=1e-5, rtol=1e-5)


# The BNN layer on torch.nn.Modules.  A module's potential on the card and
# on the CPU sum float32 terms in other orders (cuBLAS / cuDNN, TF32 off):
# log-probs within 1e-5 relative, gradients within 1e-5 of the largest
# entry, HMC states after a few draws within 1e-5, identical accepts.


def bnn_module(batch_norm):
    torch.manual_seed(0)
    mid = [torch.nn.BatchNorm1d(16)] if batch_norm else []
    return torch.nn.Sequential(torch.nn.Linear(6, 16), *mid, torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def bnn_data(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(40, 6).astype(np.float32), rng.randint(0, 3, 40).astype(np.float32)


def test_model_entry_points_raise_without_a_card(monkeypatch):
    """With no device given and no card, the BNN layer's entry points raise
    instead of falling back to the CPU (here with CUDA masked)."""
    from hamiltorch_tpu_torch.models import bnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = bnn_module(False)
    x, y = bnn_data()
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    calls = [
        lambda: bnn.build_model(net),
        lambda: bnn.define_model_log_prob(net, "multi_class_linear_output", x, y),
        lambda: bnn.define_model_tree_log_prob(net, "multi_class_linear_output", x, y),
        lambda: bnn.define_model_prior_and_lik(net, "multi_class_linear_output", x, y),
        lambda: bnn.sample_model(net, x, y, num_samples=2, verbose=False),
        lambda: bnn.predict_model(net, flat[None], x=x, y=y),
        lambda: bnn.define_split_model_log_prob(net, "multi_class_linear_output",
                                                [(x, y)], 1, verbose=False),
        lambda: bnn.define_split_model_tree_log_prob(net, "multi_class_linear_output",
                                                     [(x, y)], 1, verbose=False),
        lambda: bnn.sample_split_model(net, [(x[:20], y[:20]), (x[20:], y[20:])],
                                       num_samples=2, verbose=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("batch_norm", [False, True])
def test_bnn_module_hmc_on_card_matches_cpu(cuda_device, batch_norm):
    """run_hmc on a module's potential, card against CPU on injected noise;
    then sample_model on the card draws what run_hmc draws with its key,
    and store_on_GPU=False returns the same trace on the host."""
    from hamiltorch_tpu_torch import run_hmc, sample_model
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob

    net, (x, y) = bnn_module(batch_norm), bnn_data()
    gen = torch.Generator().manual_seed(3)
    d = sum(p.numel() for p in net.parameters())
    z, log_u = torch.randn(8, d, generator=gen), torch.rand(8, generator=gen).log()
    cfg = MCMCConfig(num_samples=8, num_steps_per_sample=5, step_size=0.1)

    def run(device):
        lp, flat, _ = define_model_log_prob(net, "multi_class_linear_output", x, y, tau_out=2.0,
                                            device=device)
        return run_hmc(0, lp, flat, cfg, _noise=(z.to(device), log_u.to(device)))

    on_card, on_host = run(cuda_device), run("cpu")
    assert torch.equal(on_card.stats.accepted.cpu(), on_host.stats.accepted)
    assert 0 < float(on_host.stats.accepted.float().mean()) < 1
    torch.testing.assert_close(on_card.samples.cpu(), on_host.samples, atol=1e-5, rtol=0)

    kw = dict(model_loss="multi_class_linear_output", num_samples=8, num_steps_per_sample=5,
              step_size=0.1, tau_out=2.0, key=7, verbose=False, device=cuda_device)
    drawn = sample_model(net, x, y, **kw)
    lp, flat, _ = define_model_log_prob(net, "multi_class_linear_output", x, y, tau_out=2.0,
                                        device=cuda_device)
    direct = run_hmc(7, lp, flat, cfg)
    assert drawn.is_cuda and torch.equal(drawn[1:], direct.samples[1:])
    offloaded = sample_model(net, x, y, store_on_GPU=False, **kw)
    assert offloaded.device.type == "cpu" and torch.equal(offloaded, drawn.cpu())


class _SwitchProbe(torch.autograd.Function):
    """Identity that notes cuBLAS's and cuDNN's TF32 switches in its forward
    and its backward."""

    generate_vmap_rule = True
    seen = []

    @staticmethod
    def forward(a):
        _SwitchProbe.seen.append((torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32))
        return a.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _SwitchProbe.seen.append((torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32))
        return g


class _LSTMNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(30, 8)
        self.lstm = torch.nn.LSTM(8, 6, batch_first=True)
        self.head = torch.nn.Linear(6, 3)

    def forward(self, x):
        return self.head(_SwitchProbe.apply(self.lstm(self.emb(x))[0][:, -1]))


@pytest.mark.gpu
def test_lstm_module_gradient_on_card_matches_float64(cuda_device):
    """cuDNN's fused LSTM gives the blocked potential a gradient on the card
    (its forward runs in training mode with dropout 0) that matches float64
    on the CPU, for 3 chains under vmap, with the TF32 switches read as off
    inside the potential, forward and backward, while they are on outside;
    the whole potential is refused on the card."""
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob

    torch.manual_seed(0)
    net = _LSTMNet()
    x, y = torch.randint(0, 30, (40, 9)), torch.randint(0, 3, (40,))
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    theta = flat + 0.1 * torch.randn(3, flat.numel())
    lp64, _, _ = define_model_log_prob(net.double(), "multi_class_linear_output", x, y,
                                       tau_list=5.0, device="cpu")
    g64, v64 = torch.func.vmap(torch.func.grad_and_value(lp64))(theta.double())
    net.float()
    lp, _, _ = define_model_log_prob(net, "multi_class_linear_output", x, y, tau_list=5.0,
                                     device=cuda_device, block_rows=16)
    _SwitchProbe.seen.clear()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        g, v = torch.func.vmap(torch.func.grad_and_value(lp))(theta.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert _SwitchProbe.seen == [(False, False)] * (2 * 3 * 3)  # 3 blocks of 16 rows, 3 chains
    torch.testing.assert_close(g.cpu().double(), g64, rtol=0, atol=1e-5 * float(g64.abs().max()))
    torch.testing.assert_close(v.cpu().double(), v64, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="block_rows"):
        define_model_log_prob(net, "multi_class_linear_output", x, y, device=cuda_device)


@pytest.mark.gpu
def test_batchnorm_under_vmap_on_card_matches_cpu(cuda_device):
    """BatchNorm on batch statistics under torch.func.vmap over chains:
    value and gradient of 4 chains on the card against the CPU."""
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob

    net, (x, y) = bnn_module(True), bnn_data(1)
    d = sum(p.numel() for p in net.parameters())
    shift = torch.as_tensor(0.1 * np.random.RandomState(2).randn(4, d).astype(np.float32))

    def grads(device):
        lp, flat, _ = define_model_log_prob(net, "multi_class_linear_output", x, y, device=device)
        return torch.func.vmap(torch.func.grad_and_value(lp))(flat[None] + shift.to(device))

    (g_card, v_card), (g_host, v_host) = grads(cuda_device), grads("cpu")
    torch.testing.assert_close(v_card.cpu(), v_host, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_card.cpu(), g_host, rtol=0, atol=1e-5 * float(g_host.abs().max()))


@pytest.mark.gpu
def test_predict_model_on_card_matches_cpu(cuda_device):
    from hamiltorch_tpu_torch.models.bnn import predict_model

    net, (x, y) = bnn_module(True), bnn_data(2)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    samples = flat[None] + 0.05 * torch.randn(5, flat.numel(), generator=torch.Generator().manual_seed(4))
    loader = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 40, 16)]  # 16, 16, 8
    host = predict_model(net, samples, test_loader=loader, device="cpu")
    card = predict_model(net, samples, test_loader=loader, device=cuda_device)
    streamed = predict_model(net, samples, test_loader=loader, stream_batches=2, device=cuda_device)
    assert card[0].is_cuda and streamed[0].device.type == "cpu"
    for got in (card, streamed):
        torch.testing.assert_close(got[0].cpu(), host[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1].cpu(), host[1], rtol=1e-5, atol=0)


# The sampler entry points place a start that is not a tensor on the card
# (utils.convert.place_start) and keep a tensor start where it is.

SAMPLER_ENTRIES = ["sample", "sample_nuts", "sample_offload", "run_hmc", "run_hmc_chains",
                   "run_hmc_host_offload", "run_mclmc", "run_mclmc_chains", "run_mams",
                   "run_mams_chains", "run_nuts", "run_nuts_chains", "run_nuts_ensemble",
                   "run_nuts_host_offload", "run_hmc_checkpointed",
                   "run_hmc_chains_checkpointed", "run_nuts_checkpointed",
                   "run_nuts_ensemble_checkpointed", "run_mclmc_checkpointed",
                   "run_mams_checkpointed", "sample_rmhmc", "sample_splitting", "run_rmhmc",
                   "run_rmhmc_chains", "run_rmhmc_host_offload", "run_rmhmc_checkpointed",
                   "run_split_hmc", "run_split_hmc_chains", "run_split_hmc_host_offload",
                   "run_split_hmc_checkpointed", "run_chees", "run_chees_checkpointed",
                   "run_sgld", "run_sgld_chains", "run_sghmc", "run_sghmc_chains",
                   "run_csgmcmc", "run_csgmcmc_chains", "run_sgld_checkpointed",
                   "run_sghmc_checkpointed", "run_parallel_tempering", "run_pt_chains",
                   "run_pt_checkpointed", "run_ti", "run_ti_checkpointed", "run_smc",
                   "run_barker", "run_barker_chains", "run_barker_checkpointed", "run_stretch",
                   "run_stretch_checkpointed", "run_elliptical", "run_elliptical_chains",
                   "map_estimate", "laplace_approx", "advi"]
# entry points that take a flat start only, as in the JAX package
FLAT_ONLY = ("run_rmhmc_host_offload", "run_rmhmc_checkpointed")


def _leaf_lp(t):
    from hamiltorch_tpu_torch.utils.pytree import tree_leaves

    return -0.5 * sum(torch.sum(leaf ** 2) for leaf in tree_leaves(t))


def call_entry(entry, theta0, ckpt_dir):
    """Run ``entry`` for a few draws from ``theta0``; returns (samples, final
    chain state) of its result."""
    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.samplers.offload import run_nuts_host_offload

    hmc = tht.MCMCConfig(num_samples=3, num_steps_per_sample=2, step_size=0.2)
    nuts = tht.NUTSConfig(num_samples=3, step_size=0.3, max_tree_depth=3)
    mclmc = tht.MCLMCConfig(num_samples=3, tune_steps=2)
    mams = tht.MAMSConfig(num_samples=3, num_steps_per_sample=2, burn=1)
    rm = dict(metric=tht.Metric.SOFTABS, softabs_const=10.0, fixed_point_max_iterations=3)
    split_terms = [lambda t: 0.5 * _leaf_lp(t)] * 2
    chees = tht.ChEESConfig(num_samples=3, step_size=0.2, burn=1)
    sgld = tht.SGLDConfig(num_samples=3, step_size=0.01)
    sghmc = tht.SGHMCConfig(num_samples=3, step_size=0.01)
    cyc = tht.CSGMCMCConfig(num_cycles=1, cycle_length=4, step_size=0.01, exploration_frac=0.5)

    pt = tht.PTConfig(num_samples=3, num_steps_per_sample=2, step_size=0.2, num_temps=3)
    ti = tht.TIConfig(num_samples=3, num_steps_per_sample=2, step_size=0.2, num_temps=3,
                      burn=1)
    smc = tht.SMCConfig(num_particles=4, num_temps=2, mcmc_steps=1, leapfrog_steps=2)
    barker = tht.BarkerConfig(num_samples=3, burn=1)
    stretch = tht.StretchConfig(num_samples=3)
    ess = tht.EllipticalConfig(num_samples=3)

    def split_term(t, m):
        return 0.5 * _leaf_lp(t)

    def prior_sample(seed, n):  # n copies of the start, numpy or tensor as it is
        def copies(v):
            if isinstance(v, np.ndarray):
                return np.stack([v] * n)
            return v.unsqueeze(0).expand((n,) + tuple(v.shape)).clone()
        return {k: copies(v) for k, v in theta0.items()} if isinstance(theta0, dict) \
            else copies(theta0)

    if entry.startswith("sample"):
        kw = dict(num_samples=3, num_steps_per_sample=2, step_size=0.2, verbose=False, key=0)
        lp = _leaf_lp
        if entry == "sample_nuts":
            kw["sampler"] = tht.Sampler.NUTS
        if entry == "sample_rmhmc":
            kw.update(rm, sampler=tht.Sampler.RMHMC)
        if entry == "sample_splitting":
            lp, kw["integrator"] = split_terms, tht.Integrator.SPLITTING
        out = tht.sample(lp, theta0, store_on_GPU=entry != "sample_offload", **kw)
        return out, out
    calls = {
        "run_hmc": lambda: tht.run_hmc(0, _leaf_lp, theta0, hmc),
        "run_hmc_chains": lambda: tht.run_hmc_chains(0, _leaf_lp, theta0, hmc, 2),
        "run_hmc_host_offload": lambda: tht.run_hmc_host_offload(0, _leaf_lp, theta0, hmc),
        "run_mclmc": lambda: tht.run_mclmc(0, _leaf_lp, theta0, mclmc),
        "run_mclmc_chains": lambda: tht.run_mclmc_chains(0, _leaf_lp, theta0, mclmc, 2),
        "run_mams": lambda: tht.run_mams(0, _leaf_lp, theta0, mams),
        "run_mams_chains": lambda: tht.run_mams_chains(0, _leaf_lp, theta0, mams, 2),
        "run_nuts": lambda: tht.run_nuts(0, _leaf_lp, theta0, nuts)[0],
        "run_nuts_chains": lambda: tht.run_nuts_chains(0, _leaf_lp, theta0, nuts, 2)[0],
        "run_nuts_ensemble": lambda: tht.run_nuts_ensemble(0, _leaf_lp, theta0, nuts, 2)[0],
        "run_nuts_host_offload": lambda: run_nuts_host_offload(0, _leaf_lp, theta0, nuts),
        "run_hmc_checkpointed": lambda: ck.run_hmc_checkpointed(0, _leaf_lp, theta0, hmc,
                                                                ckpt_dir),
        "run_hmc_chains_checkpointed": lambda: ck.run_hmc_chains_checkpointed(
            0, _leaf_lp, theta0, hmc, ckpt_dir, 2),
        "run_nuts_checkpointed": lambda: ck.run_nuts_checkpointed(0, _leaf_lp, theta0, nuts,
                                                                  ckpt_dir),
        "run_nuts_ensemble_checkpointed": lambda: ck.run_nuts_ensemble_checkpointed(
            0, _leaf_lp, theta0, nuts, ckpt_dir, 2)[0],
        "run_mclmc_checkpointed": lambda: ck.run_mclmc_checkpointed(0, _leaf_lp, theta0, mclmc,
                                                                    ckpt_dir),
        "run_mams_checkpointed": lambda: ck.run_mams_checkpointed(0, _leaf_lp, theta0, mams,
                                                                  ckpt_dir),
        "run_rmhmc": lambda: tht.run_rmhmc(0, _leaf_lp, theta0, hmc, **rm),
        "run_rmhmc_chains": lambda: tht.run_rmhmc_chains(0, _leaf_lp, theta0, hmc, 2, **rm),
        "run_rmhmc_host_offload": lambda: tht.samplers.run_rmhmc_host_offload(
            0, _leaf_lp, theta0, hmc, **rm),
        "run_rmhmc_checkpointed": lambda: ck.run_rmhmc_checkpointed(0, _leaf_lp, theta0, hmc,
                                                                    ckpt_dir, **rm),
        "run_split_hmc": lambda: tht.samplers.run_split_hmc(0, split_terms, theta0, hmc),
        "run_split_hmc_chains": lambda: tht.samplers.run_split_hmc_chains(
            0, split_term, 2, theta0, hmc, 2),
        "run_split_hmc_host_offload": lambda: tht.samplers.run_split_hmc_host_offload(
            0, split_term, 2, theta0, hmc),
        "run_split_hmc_checkpointed": lambda: ck.run_split_hmc_checkpointed(
            0, split_term, 2, theta0, hmc, ckpt_dir),
        "run_chees": lambda: tht.run_chees(0, _leaf_lp, theta0, chees, 2),
        "run_chees_checkpointed": lambda: ck.run_chees_checkpointed(0, _leaf_lp, theta0, chees,
                                                                    ckpt_dir, 2),
        "run_sgld": lambda: tht.run_sgld(0, split_term, 2, theta0, sgld),
        "run_sgld_chains": lambda: tht.run_sgld_chains(0, split_term, 2, theta0, sgld, 2),
        "run_sghmc": lambda: tht.run_sghmc(0, split_term, 2, theta0, sghmc),
        "run_sghmc_chains": lambda: tht.run_sghmc_chains(0, split_term, 2, theta0, sghmc, 2),
        "run_csgmcmc": lambda: tht.run_csgmcmc(0, split_term, 2, theta0, cyc),
        "run_csgmcmc_chains": lambda: tht.run_csgmcmc_chains(0, split_term, 2, theta0, cyc, 2),
        "run_sgld_checkpointed": lambda: ck.run_sgld_checkpointed(0, split_term, 2, theta0, sgld,
                                                                  ckpt_dir),
        "run_sghmc_checkpointed": lambda: ck.run_sghmc_checkpointed(0, split_term, 2, theta0,
                                                                    sghmc, ckpt_dir),
        "run_parallel_tempering": lambda: tht.run_parallel_tempering(0, _leaf_lp, theta0, pt),
        "run_pt_chains": lambda: tht.run_pt_chains(0, _leaf_lp, theta0, pt, 2),
        "run_pt_checkpointed": lambda: ck.run_pt_checkpointed(0, _leaf_lp, theta0, pt, ckpt_dir),
        "run_ti": lambda: tht.run_ti(0, _leaf_lp, _leaf_lp, theta0, ti),
        "run_ti_checkpointed": lambda: ck.run_ti_checkpointed(0, _leaf_lp, _leaf_lp, theta0, ti,
                                                              ckpt_dir),
        "run_smc": lambda: tht.run_smc(0, _leaf_lp, _leaf_lp, prior_sample, smc),
        "run_barker": lambda: tht.run_barker(0, _leaf_lp, theta0, barker),
        "run_barker_chains": lambda: tht.run_barker_chains(0, _leaf_lp, theta0, barker, 2),
        "run_barker_checkpointed": lambda: ck.run_barker_checkpointed(0, _leaf_lp, theta0,
                                                                      barker, ckpt_dir),
        "run_stretch": lambda: tht.run_stretch(0, _leaf_lp, theta0, stretch, 4),
        "run_stretch_checkpointed": lambda: ck.run_stretch_checkpointed(
            0, _leaf_lp, theta0, stretch, ckpt_dir, num_walkers=4),
        "run_elliptical": lambda: tht.run_elliptical(0, _leaf_lp, theta0, ess),
        "run_elliptical_chains": lambda: tht.run_elliptical_chains(0, _leaf_lp, theta0, ess, 2),
        "map_estimate": lambda: tht.map_estimate(_leaf_lp, theta0, num_steps=3),
        "laplace_approx": lambda: tht.laplace_approx(_leaf_lp, theta0),
        "advi": lambda: tht.advi(_leaf_lp, theta0, num_steps=3),
    }
    out = calls[entry]()
    if hasattr(out, "log_weights"):  # SMC: the final population
        return out.particles, out.particles
    if hasattr(out, "loglik_draws"):  # TI: the beta=1 rung's trace
        return out.samples, out.samples
    if isinstance(out, (tht.MAPResult, tht.LaplaceResult, tht.ADVIResult)):
        return (out.theta, out.final_theta) if hasattr(out, "theta") else (out.mean, out.mean)
    if hasattr(out, "final_walkers"):
        return out.samples, out.final_walkers
    if hasattr(out, "final_state"):
        final = out.final_state.theta
    elif hasattr(out, "final_carry"):  # ChEES, PT
        final = out.final_carry.thetas
    else:
        final = out.final_theta
    return out.samples, final


def _starts(entry):
    """The flat start, and for the entry points that take trees a dict one."""
    flat = np.array([0.3, -0.2, 0.1], np.float32)
    if entry.startswith("sample") or entry in FLAT_ONLY:
        return [flat]
    return [flat, {"a": flat[:2], "b": flat[2:]}]


def _devices(tree):
    from hamiltorch_tpu_torch.utils.pytree import tree_leaves

    return {leaf.device.type for leaf in tree_leaves(tree)}


@pytest.mark.parametrize("entry", SAMPLER_ENTRIES)
def test_numpy_starts_raise_without_a_card_and_cpu_tensors_run(monkeypatch, tmp_path, entry):
    """With CUDA masked, a start that is not a tensor (a numpy array, or a
    tree with numpy leaves) raises the no-card error; a CPU tensor start runs
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for start in _starts(entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call_entry(entry, start, str(tmp_path / "numpy"))
    for i, start in enumerate(_starts(entry)):
        as_cpu = (torch.as_tensor(start, device="cpu") if isinstance(start, np.ndarray)
                  else {k: torch.as_tensor(v, device="cpu") for k, v in start.items()})
        samples, final = call_entry(entry, as_cpu, str(tmp_path / f"cpu{i}"))
        assert _devices(samples) == _devices(final) == {"cpu"}


@pytest.mark.gpu
@pytest.mark.parametrize("entry", SAMPLER_ENTRIES)
def test_numpy_starts_sample_on_the_card(cuda_device, tmp_path, entry):
    """A numpy start (or a tree of numpy leaves) runs on the card: the
    chain's final state is there, and so are its samples unless the entry
    point offloads them to the host."""
    for i, start in enumerate(_starts(entry)):
        samples, final = call_entry(entry, start, str(tmp_path / str(i)))
        offloads = entry in ("sample_offload", "run_hmc_host_offload", "run_nuts_host_offload",
                             "run_rmhmc_host_offload", "run_split_hmc_host_offload")
        assert _devices(samples) == ({"cpu"} if offloads else {"cuda"})
        if not entry.startswith("sample"):
            assert _devices(final) == {"cuda"}


@pytest.mark.gpu
@pytest.mark.parametrize("pooled", [False, True])
def test_nuts_on_card_matches_cpu_in_float64(cuda_device, pooled):
    """NUTS chains (and the pooled ensemble) on the tiny flagship in float64
    on the same injected noise: identical trees, positions within 1e-8 of
    max |theta|."""
    from hamiltorch_tpu_torch.samplers.nuts import NUTSConfig, run_nuts_chains, run_nuts_ensemble

    chains, draws, depth = 4, 5, 5
    gen = torch.Generator().manual_seed(6)
    dims = 41
    noise = {"z": torch.randn(draws, chains, dims, generator=gen, dtype=torch.float64),
             "u_dir": torch.rand(draws, chains, depth, generator=gen, dtype=torch.float64),
             "u_merge": torch.rand(draws, chains, depth, generator=gen, dtype=torch.float64),
             "u_leaf": torch.rand(draws, chains, depth, 1 << (depth - 1), generator=gen,
                                  dtype=torch.float64)}
    cfg = NUTSConfig(num_samples=draws, step_size=0.05, burn=3, max_tree_depth=depth)
    run = run_nuts_ensemble if pooled else run_nuts_chains

    def go(device):
        lp, p = make_flagship_potential_tree(8, 4, 16, device=device, dtype=torch.float64)
        return run(0, lp, p, cfg, chains, _noise={k: v.to(device) for k, v in noise.items()})

    (card, card_info), (host, host_info) = go(cuda_device), go("cpu")
    for f in ("tree_depth", "num_leapfrogs", "divergent"):
        assert torch.equal(getattr(card_info, f).cpu(), getattr(host_info, f)), f
    for k in host.samples:
        scale = float(host.samples[k].abs().max())
        assert float((card.samples[k].cpu() - host.samples[k]).abs().max()) <= 1e-8 * scale


@pytest.mark.gpu
def test_checkpoint_resume_on_card(cuda_device, tmp_path):
    """run_hmc_chains_checkpointed and run_nuts_ensemble_checkpointed on the
    card, stopped and resumed, equal the straight runs bit for bit."""
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.samplers.nuts import NUTSConfig, run_nuts_ensemble

    lp, p = make_flagship_potential_tree(8, 4, 16, device=cuda_device)
    hmc = MCMCConfig(num_samples=10, num_steps_per_sample=5, step_size=0.05, burn=4,
                     adapt_step_size=True)
    want = run_hmc_chains(3, lp, p, hmc, 4)
    ck.run_hmc_chains_checkpointed(3, lp, p, MCMCConfig(**{**vars(hmc), "num_samples": 4}),
                                   str(tmp_path / "hmc"), 4, chunk_size=3)
    got = ck.run_hmc_chains_checkpointed(3, lp, p, hmc, str(tmp_path / "hmc"), 4, chunk_size=3)
    for k in want.samples:
        assert got.samples[k].is_cuda and torch.equal(got.samples[k], want.samples[k])
    for a, b in zip(got.stats, want.stats):
        assert torch.equal(a, b)
    nuts = NUTSConfig(num_samples=8, step_size=0.05, burn=4, max_tree_depth=4)
    want_n, want_info = run_nuts_ensemble(3, lp, p, nuts, 4)
    ck.run_nuts_ensemble_checkpointed(3, lp, p, NUTSConfig(**{**vars(nuts), "num_samples": 3}),
                                      str(tmp_path / "nuts"), 4, chunk_size=2)
    got_n, got_info = ck.run_nuts_ensemble_checkpointed(3, lp, p, nuts, str(tmp_path / "nuts"),
                                                        4, chunk_size=2)
    for k in want_n.samples:
        assert torch.equal(got_n.samples[k], want_n.samples[k])
    for a, b in zip(got_info, want_info):
        assert torch.equal(a, b)


# --- RMHMC and split HMC on the card (no kernel of their own) -------------------

PREC4 = np.array([[2.0, 0.6, 0.0, 0.1], [0.6, 1.0, 0.2, 0.0],
                  [0.0, 0.2, 1.5, -0.3], [0.1, 0.0, -0.3, 0.8]])


def quartic_lp(device, dtype=torch.float64):
    prec = torch.as_tensor(PREC4, dtype=dtype, device=device)

    def lp(t):
        return -0.5 * t @ prec @ t - 0.025 * torch.sum(t ** 4)
    return lp


def funnel_lp(t):
    v, x = t[0], t[1:]
    return -0.5 * v ** 2 / 9.0 - 0.5 * torch.sum(x ** 2) * torch.exp(-v) - 0.5 * 4 * v


RM_CARD_CASES = [("IMPLICIT", "SOFTABS"), ("EXPLICIT", "SOFTABS"), ("MIDPOINT", "SOFTABS"),
                 ("S3", "SOFTABS"), ("IMPLICIT", "HESSIAN"), ("IMPLICIT", "JACOBIAN_DIAG")]


@pytest.mark.gpu
@pytest.mark.parametrize("integrator,metric", RM_CARD_CASES)
def test_rmhmc_on_card_matches_cpu_in_float64(cuda_device, integrator, metric):
    """run_rmhmc_chains on the card and on the CPU, float64, the same
    injected noise (jitter included): identical accepts and fixed-point
    counts, positions within 1e-8 of max |theta|."""
    import hamiltorch_tpu_torch as tht

    chains, draws, d = 3, 3, 4
    gen = torch.Generator().manual_seed(3)
    noise = (torch.randn(draws, chains, d, generator=gen, dtype=torch.float64),
             torch.rand(draws, chains, generator=gen, dtype=torch.float64).log(),
             torch.rand(draws, chains, d, generator=gen, dtype=torch.float64))
    cfg = tht.MCMCConfig(num_samples=draws, num_steps_per_sample=3, step_size=0.2)
    kw = dict(integrator=getattr(tht.Integrator, integrator), metric=getattr(tht.Metric, metric),
              softabs_const=1e2, jitter=0.1, fixed_point_threshold=1e-10,
              fixed_point_max_iterations=30)

    def go(device):
        theta0 = torch.full((d,), 0.3, dtype=torch.float64, device=device)
        return tht.run_rmhmc_chains(0, quartic_lp(device), theta0, cfg, chains,
                                    _noise=tuple(t.to(device) for t in noise), **kw)

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.stats.accepted.cpu(), host.stats.accepted)
    assert torch.equal(card.stats.fp_iters.cpu(), host.stats.fp_iters)
    assert bool(host.stats.accepted.any())
    scale = float(host.samples.abs().max())
    assert float((card.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale


@pytest.mark.gpu
def test_softabs_under_vmap_and_grad_on_card(cuda_device):
    """The softabs Function under torch.func.vmap over torch.func.grad on
    CUDA tensors, at exactly repeated eigenvalues: finite, and equal to the
    CPU's derivative."""
    from hamiltorch_tpu_torch.ops.metrics import softabs_transform

    rng = np.random.RandomState(4)
    q, _ = np.linalg.qr(rng.randn(5, 5))
    mats = np.stack([np.diag([2.0, 2.0, 2.0, -1.0, 0.5]),
                     (q * np.array([0.7, 0.7, -0.3, -0.3, 1e-9])) @ q.T])
    w = rng.randn(5, 5)

    def grads(device):
        wt = torch.as_tensor(w, device=device)

        def loss(m):
            g, lam = softabs_transform(m, 10.0)
            return (g * wt).sum() + torch.log(lam).sum()
        return torch.func.vmap(torch.func.grad(loss))(torch.as_tensor(mats, device=device))

    card, host = grads(cuda_device), grads("cpu")
    assert bool(torch.isfinite(card).all())
    torch.testing.assert_close(card.cpu(), host, rtol=0, atol=1e-10)


@pytest.mark.gpu
def test_a_metric_that_is_not_spd_is_nan_and_rejected_on_card(cuda_device):
    """cholesky_ex without checks: the non-SPD HESSIAN metric of the funnel
    gives a NaN energy on the card (no exception, no host sync) and the
    driver rejects every draw as a divergence."""
    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch.enums import Metric
    from hamiltorch_tpu_torch.ops.metrics import RMOptions, make_rm_hamiltonian

    theta = torch.tensor([-1.0, 2.0, 0.5, -1.5, 1.0], dtype=torch.float64, device=cuda_device)
    rm = make_rm_hamiltonian(funnel_lp, RMOptions(metric=Metric.HESSIAN))
    assert bool(torch.isnan(rm.ham(theta, torch.ones_like(theta), None)))
    res = tht.run_rmhmc(0, funnel_lp, theta,
                        tht.MCMCConfig(num_samples=3, num_steps_per_sample=2, step_size=0.1),
                        metric=tht.Metric.HESSIAN, fixed_point_max_iterations=3)
    assert bool(res.stats.divergent.all()) and not bool(res.stats.accepted.any())
    assert torch.equal(res.samples[-1], theta)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["SPLITTING", "SPLITTING_RAND", "SPLITTING_KMID"])
def test_split_hmc_on_card_matches_cpu_in_float64(cuda_device, scheme):
    """run_split_hmc_chains with stacked data on the card and on the CPU,
    float64, the same injected noise and term orders: identical accepts,
    positions within 1e-8 of max |theta|."""
    import hamiltorch_tpu_torch as tht

    chains, draws, terms = 3, 4, 3
    rng = np.random.RandomState(5)
    data = rng.randn(terms, 6, 2)
    noise = (torch.as_tensor(rng.randn(draws, chains, 2)),
             torch.as_tensor(np.log(rng.rand(draws, chains))),
             torch.as_tensor(np.stack([[rng.permutation(terms) for _ in range(chains)]
                                       for _ in range(draws)])))

    def term(t, m, xs):
        return -0.5 * torch.sum((t - xs[m]) ** 2) / terms + 0.1 * torch.sum(torch.sin(t))

    def go(device):
        return tht.samplers.run_split_hmc_chains(
            0, term, terms, torch.zeros(2, dtype=torch.float64, device=device),
            tht.MCMCConfig(num_samples=draws, num_steps_per_sample=3, step_size=0.5), chains,
            integrator=getattr(tht.Integrator, scheme),
            data=torch.as_tensor(data, device=device),
            _noise=tuple(t.to(device) for t in noise))

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.stats.accepted.cpu(), host.stats.accepted)
    scale = float(host.samples.abs().max())
    assert float((card.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("adapt_mass", [False, "diag", "dense"])
def test_chees_on_card_matches_cpu_in_float64(cuda_device, adapt_mass):
    """run_chees on the card and on the CPU, float64, the same injected
    momenta, Metropolis uniforms and jitter, burn 150 (one slow window):
    identical leapfrog counts and accepts, positions within 1e-8 of max
    |theta|."""
    import hamiltorch_tpu_torch as tht

    chains, draws, d = 8, 160, 4
    rng = np.random.RandomState(6)
    noise = (torch.as_tensor(rng.randn(draws, chains, d)),
             torch.as_tensor(np.log(rng.rand(draws, chains))), torch.as_tensor(rng.rand(draws)))
    start = rng.randn(chains, d)
    scales = torch.tensor([1.0, 1.5, 0.8, 1.2], dtype=torch.float64)
    cfg = tht.ChEESConfig(num_samples=draws, step_size=0.1, burn=150, adapt_mass=adapt_mass,
                          desired_accept_rate=0.95)

    def go(device):
        lp = lambda t: (-0.5 * torch.sum((t / scales.to(t.device)) ** 2)  # noqa: E731
                        + 0.05 * torch.sum(torch.sin(t)))
        return tht.run_chees(0, lp, torch.as_tensor(start, device=device), cfg, chains,
                             _noise=tuple(t.to(device) for t in noise))

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.info.num_leapfrog.cpu(), host.info.num_leapfrog)
    moved = lambda s: (s[:, 1:] != s[:, :-1]).any(dim=-1)  # noqa: E731
    assert torch.equal(moved(card.samples.cpu()), moved(host.samples))
    scale = float(host.samples.abs().max())
    assert float((card.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgld", "psgld", "sghmc"])
def test_sgmcmc_on_card_matches_cpu_in_float64(cuda_device, kind):
    """SG-MCMC chains on the card and on the CPU, float64, the same injected
    normals; the terms come from the host hash on both: identical terms
    (recorded by the term function), positions within 1e-8 of max |theta|."""
    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch.utils.rng import sg_term_indices

    chains, steps, terms = 3, 12, 4
    rng = np.random.RandomState(7)
    centres = rng.randn(terms, 3)
    z = torch.as_tensor(rng.randn(steps, chains, 3))

    def go(device):
        seen = []

        def term(t, m, xs):
            seen.append(m)
            return -0.5 * torch.sum((t - xs[m]) ** 2) / terms

        noise = {"z": z.to(device), "fresh": z.to(device),
                 "m": torch.as_tensor([[int(m) for m in row] for row in
                                       [sg_term_indices(0, g, chains, terms)
                                        for g in range(steps)]])}
        theta0 = torch.zeros(3, dtype=torch.float64, device=device)
        data = torch.as_tensor(centres, device=device)
        if kind == "sghmc":
            cfg = tht.SGHMCConfig(num_samples=steps, step_size=0.01, resample_momentum_every=5)
            res = tht.run_sghmc_chains(0, term, terms, theta0, cfg, chains, data=data,
                                       _noise=noise)
        else:
            cfg = tht.SGLDConfig(num_samples=steps, step_size=0.01,
                                 preconditioner="rmsprop" if kind == "psgld" else "none")
            res = tht.run_sgld_chains(0, term, terms, theta0, cfg, chains, data=data,
                                      _noise=noise)
        return res, seen

    (card, seen_card), (host, seen_host) = go(cuda_device), go("cpu")
    assert seen_card == seen_host
    scale = float(host.samples.abs().max())
    assert float((card.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale


# --- parallel tempering, TI and SMC: card against CPU in float64 ----------------------


def _tempering_lp(t):
    return (torch.logaddexp(-0.5 * torch.sum(((t - 1.5) / 0.6) ** 2),
                            -0.5 * torch.sum(((t + 1.5) / 0.6) ** 2))
            + 0.05 * torch.sum(torch.sin(t)))


def _moved(trace):
    """Which lanes' states changed from one kept draw to the next."""
    return (trace[1:] != trace[:-1]).reshape(trace.shape[0] - 1, *trace.shape[1:-1], -1).any(-1)


def _pt_card_and_cpu(cuda_device, ensembles, target):
    """One float64 PT run on the card and on the CPU on the same injected
    noise, dual averaging and ladder adaptation across burn, acceptance
    target ``target``: ``(card, cpu, position error of max |theta|)`` after
    asserting identical swaps and accepts."""
    import hamiltorch_tpu_torch as tht

    k, d, draws = 4, 3, 40
    lead = (draws,) if ensembles is None else (draws, ensembles)
    rng = np.random.RandomState(8)
    noise = {"z": torch.as_tensor(rng.randn(*lead, k, d)),
             "u_mh": torch.as_tensor(rng.rand(*lead, k)),
             "u_swap": torch.as_tensor(rng.rand(*lead, k))}
    start = rng.randn(*lead[1:], k, d)
    cfg = tht.PTConfig(num_samples=draws, num_steps_per_sample=4, step_size=0.25, num_temps=k,
                       max_temp=12.0, burn=25, adapt_ladder=True, adapt_step_size=True,
                       desired_accept_rate=target)

    def go(device):
        t0 = torch.as_tensor(start, device=device)
        nz = {n: v.to(device) for n, v in noise.items()}
        if ensembles is None:
            return tht.run_parallel_tempering(0, _tempering_lp, t0, cfg, _noise=nz)
        return tht.run_pt_chains(0, _tempering_lp, t0, cfg, ensembles, _noise=nz)

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.info.swap_accept.cpu(), host.info.swap_accept)
    reps_c, reps_h = card.replica_samples.cpu(), host.replica_samples
    if ensembles is not None:
        reps_c, reps_h = reps_c.transpose(0, 1), reps_h.transpose(0, 1)
    assert torch.equal(_moved(reps_c), _moved(reps_h))
    return card, host, float((reps_c - reps_h).abs().max()) / float(reps_h.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("ensembles", [None, 3])
def test_pt_on_card_matches_cpu_in_float64(cuda_device, ensembles):
    """run_parallel_tempering / run_pt_chains on the card and on the CPU,
    float64, the same injected noise, dual averaging and ladder adaptation
    across burn: identical swaps and accepts, positions within 1e-8 of max
    |theta|.  Acceptance target 0.95: at the default 0.8 dual averaging
    amplifies a last-bit difference of the card's sums draw after draw
    (tests/test_torch_tempering.py shows it on the CPU alone; the next
    test holds the default target)."""
    card, host, err = _pt_card_and_cpu(cuda_device, ensembles, 0.95)
    assert err <= 1e-8
    torch.testing.assert_close(card.info.betas.cpu(), host.info.betas, rtol=1e-10, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ensembles", [None, 3])
def test_pt_on_card_matches_cpu_at_the_default_target(cuda_device, ensembles):
    """The same at the default acceptance target of 0.8: identical swaps
    and accepts; the positions drift as far as dual averaging carries the
    card's last-bit differences (chip_smoke.py's tempering phase prints the
    drift beside that of a reversed summation order on the CPU alone), held
    within 1e-5 of max |theta|."""
    _, _, err = _pt_card_and_cpu(cuda_device, ensembles, 0.8)
    assert err <= 1e-5


@pytest.mark.gpu
def test_ti_on_card_matches_cpu_in_float64(cuda_device):
    """run_ti on the card and on the CPU, float64, the same injected noise,
    dual averaging across burn: identical swaps, positions and evidence
    within 1e-8."""
    import hamiltorch_tpu_torch as tht

    k, d, draws = 5, 3, 40
    rng = np.random.RandomState(9)
    noise = {"z": torch.as_tensor(rng.randn(draws, k, d)),
             "u_mh": torch.as_tensor(rng.rand(draws, k)),
             "u_swap": torch.as_tensor(rng.rand(draws, k))}
    cfg = tht.TIConfig(num_samples=draws, num_steps_per_sample=4, step_size=0.3, num_temps=k,
                       schedule_power=2.0, burn=20)

    def go(device):
        return tht.run_ti(0, lambda t: -0.5 * torch.sum(t ** 2), _tempering_lp,
                          torch.zeros(d, dtype=torch.float64, device=device), cfg,
                          _noise={n: v.to(device) for n, v in noise.items()})

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.info.swap_accept.cpu(), host.info.swap_accept)
    scale = float(host.samples.abs().max())
    assert float((card.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale
    assert abs(float(card.log_evidence) - float(host.log_evidence)) <= 1e-8 * abs(
        float(host.log_evidence))


@pytest.mark.gpu
@pytest.mark.parametrize("adapt_trajectory", [False, True])
def test_smc_on_card_matches_cpu_in_float64(cuda_device, adapt_trajectory, monkeypatch):
    """run_smc on the card and on the CPU, float64, each stage's noise drawn
    from the port's keyed stream on the CPU for both: identical resample
    decisions and trajectory lengths, particles and evidence within 1e-8."""
    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch.samplers import smc as tsmc
    from hamiltorch_tpu_torch.utils import rng as trng

    def cpu_noise(key, stage, steps, n, dim, dtype=torch.float32, device=None):
        out = trng.draw_smc_stage_noise(key, stage, steps, n, dim, dtype, "cpu")
        return {k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in out.items()}

    monkeypatch.setattr(tsmc, "draw_smc_stage_noise", cpu_noise)
    d = 3
    block = np.random.RandomState(10).randn(64, d)
    cfg = tht.SMCConfig(num_particles=64, num_temps=8, mcmc_steps=3, leapfrog_steps=6,
                        step_size=0.3, resample_threshold=0.8, adapt_trajectory=adapt_trajectory)

    def go(device):
        return tht.run_smc(0, lambda t: -0.5 * torch.sum(t ** 2), _tempering_lp,
                           lambda seed, n: torch.as_tensor(block, device=device), cfg)

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.info.resampled.cpu(), host.info.resampled)
    torch.testing.assert_close(card.info.trajectory_length.cpu(), host.info.trajectory_length,
                               rtol=1e-10, atol=0)
    scale = float(host.particles.abs().max())
    assert float((card.particles.cpu() - host.particles).abs().max()) <= 1e-8 * scale
    assert abs(float(card.log_evidence) - float(host.log_evidence)) <= 1e-8 * abs(
        float(host.log_evidence))


@pytest.mark.gpu
@pytest.mark.parametrize("runner", ["pt", "pt_chains", "ti"])
def test_checkpointed_tempering_on_card_matches_cpu_in_float64(cuda_device, tmp_path, runner,
                                                               monkeypatch):
    """run_pt_checkpointed (one ladder and ensembles) and run_ti_checkpointed
    on the card, stopped and resumed, equal their straight runs on the card
    bit for bit, and the CPU's runs within 1e-8 when each draw's ladder
    noise comes from the port's keyed stream on the CPU."""
    import dataclasses

    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.samplers import tempering as tpt
    from hamiltorch_tpu_torch.samplers import ti as tti
    from hamiltorch_tpu_torch.utils import rng as trng

    def cpu_noise(key, n, ladder, lanes, dim, stream, dtype=torch.float32, device=None):
        return tuple(v.to(device) for v in trng.draw_ladder_noise(key, n, ladder, lanes, dim,
                                                                  stream, dtype, "cpu"))

    monkeypatch.setattr(tpt, "draw_ladder_noise", cpu_noise)
    monkeypatch.setattr(tti, "draw_ladder_noise", cpu_noise)
    prior = lambda t: -0.5 * torch.sum(t ** 2)  # noqa: E731
    if runner == "ti":
        cfg = tht.TIConfig(num_samples=30, num_steps_per_sample=3, step_size=0.3, num_temps=4,
                           burn=12)

        def straight(device):
            return tht.run_ti(4, prior, _tempering_lp, torch.zeros(3, dtype=torch.float64,
                                                                   device=device), cfg)

        def chunked(device, c, path):
            return ck.run_ti_checkpointed(4, prior, _tempering_lp,
                                          torch.zeros(3, dtype=torch.float64, device=device),
                                          c, path, chunk_size=7)
    else:
        ens = None if runner == "pt" else 2
        cfg = tht.PTConfig(num_samples=30, num_steps_per_sample=3, step_size=0.3, num_temps=3,
                           burn=12, adapt_ladder=True, adapt_step_size=True)

        def straight(device):
            t0 = torch.zeros(3, dtype=torch.float64, device=device)
            if ens is None:
                return tht.run_parallel_tempering(4, _tempering_lp, t0, cfg)
            return tht.run_pt_chains(4, _tempering_lp, t0, cfg, ens)

        def chunked(device, c, path):
            return ck.run_pt_checkpointed(4, _tempering_lp,
                                          torch.zeros(3, dtype=torch.float64, device=device), c,
                                          path, chunk_size=7, num_ensembles=ens)

    want = straight(cuda_device)
    chunked(cuda_device, dataclasses.replace(cfg, num_samples=17), str(tmp_path / "card"))
    got = chunked(cuda_device, cfg, str(tmp_path / "card"))
    assert torch.equal(got.samples, want.samples)
    assert tree_equal(got.info, want.info)
    host = chunked("cpu", cfg, str(tmp_path / "cpu"))
    scale = float(host.samples.abs().max())
    assert float((got.samples.cpu() - host.samples).abs().max()) <= 1e-8 * scale


def tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))



# --- Barker, the stretch move, elliptical slice and optim: card against CPU -------------


def _ripple_lp(t):
    return -0.5 * torch.sum((t / torch.linspace(0.5, 2.0, t.shape[-1], dtype=t.dtype,
                                                device=t.device)) ** 2) + 0.2 * torch.sum(
        torch.cos(t))


def _max_rel(card, host):
    return float((card.cpu() - host).abs().max()) / float(host.abs().max())


# (name, chains, config kwargs)
BARKER_CARD = [("single-both-adaptations", None, dict(num_samples=48, burn=16, adapt_scale=True,
                                                       desired_accept_rate=0.95)),
               ("chains-scale-fixed-step", 4, dict(num_samples=60, burn=40, adapt_scale=True,
                                                   adapt_step_size=False, step_size=0.9))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,chains,cfg_kw", BARKER_CARD, ids=[c[0] for c in BARKER_CARD])
def test_barker_on_card_matches_cpu_in_float64(cuda_device, name, chains, cfg_kw):
    """run_barker / run_barker_chains, float64, the same injected noise:
    identical accepts and divergences, positions within 1e-10 of max
    |theta| (dual averaging at an acceptance target of 0.95, as the other
    float64 comparisons with adaptation run)."""
    import hamiltorch_tpu_torch as tht

    d, draws = 6, cfg_kw["num_samples"]
    lead = (draws,) if chains is None else (draws, chains)
    rng = np.random.RandomState(21)
    noise = {"z": torch.as_tensor(rng.randn(*lead, d)),
             "u_keep": torch.as_tensor(rng.rand(*lead, d)),
             "u_mh": torch.as_tensor(rng.rand(*lead).astype(np.float32))}
    cfg = tht.BarkerConfig(**cfg_kw)

    def go(device):
        t0 = torch.full((d,), 0.3, dtype=torch.float64, device=device)
        nz = {k: v.to(device) for k, v in noise.items()}
        if chains is None:
            return tht.run_barker(0, _ripple_lp, t0, cfg, _noise=nz)
        return tht.run_barker_chains(0, _ripple_lp, t0, cfg, chains, _noise=nz)

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.stats.accepted.cpu(), host.stats.accepted)
    assert torch.equal(card.stats.divergent.cpu(), host.stats.divergent)
    assert 0.0 < float(host.stats.accepted.float().mean()) < 1.0
    assert _max_rel(card.samples, host.samples) <= 1e-10
    assert _max_rel(card.scale, host.scale) <= 1e-10


@pytest.mark.gpu
def test_stretch_on_card_matches_cpu_in_float64(cuda_device):
    import hamiltorch_tpu_torch as tht

    k, d, iters = 16, 4, 60
    rng = np.random.RandomState(22)
    noise = {"u_z": torch.as_tensor(rng.rand(iters, 2, k // 2)),
             "j": torch.as_tensor(rng.randint(0, k // 2, (iters, 2, k // 2))),
             "u_mh": torch.as_tensor(rng.rand(iters, 2, k // 2).astype(np.float32))}
    walkers = rng.randn(k, d)

    def go(device):
        return tht.run_stretch(0, _ripple_lp, torch.as_tensor(walkers, device=device),
                               tht.StretchConfig(num_samples=iters, thin=2), k,
                               _noise={n: v.to(device) for n, v in noise.items()})

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.stats.accept_frac.cpu(), host.stats.accept_frac)
    assert _max_rel(card.samples, host.samples) <= 1e-10
    assert _max_rel(card.final_logp, host.final_logp) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("prior", ["diag-mean", "cholesky"])
def test_elliptical_on_card_matches_cpu_in_float64(cuda_device, prior):
    """run_elliptical_chains, float64: identical shrink counts, positions
    within 1e-10 of max |theta| (the likelihood in float32, as the JAX
    package keeps it, is compared with its slice level in float32 on both
    sides)."""
    import hamiltorch_tpu_torch as tht

    c, d, draws, cap = 4, 5, 40, 64
    rng = np.random.RandomState(23)
    noise = {"nu": torch.as_tensor(rng.randn(draws, c, d)),
             "u": torch.as_tensor(rng.rand(draws, c).astype(np.float32)),
             "t0": torch.as_tensor(rng.rand(draws, c).astype(np.float32)),
             "t_shrink": torch.as_tensor(rng.rand(draws, c, cap).astype(np.float32))}
    a = rng.randn(d, d)
    scale = (np.linalg.cholesky(a @ a.T / d + np.eye(d)) if prior == "cholesky"
             else np.linspace(0.5, 2.0, d))
    mean = None if prior == "cholesky" else rng.randn(d)

    def go(device):
        return tht.run_elliptical_chains(
            0, lambda t: -0.5 * torch.sum(((t - 1.0) / 0.5) ** 2),
            torch.zeros(d, dtype=torch.float64, device=device), tht.EllipticalConfig(draws), c,
            prior_scale=torch.as_tensor(scale, device=device),
            prior_mean=None if mean is None else torch.as_tensor(mean, device=device),
            _noise={n: v.to(device) for n, v in noise.items()})

    card, host = go(cuda_device), go("cpu")
    assert torch.equal(card.stats.shrinks.cpu(), host.stats.shrinks)
    assert int(host.stats.shrinks.max()) >= 2
    assert _max_rel(card.samples, host.samples) <= 1e-10


@pytest.mark.gpu
def test_gradient_free_default_noise_on_card_equals_cpu_with_cpu_generators(cuda_device,
                                                                          monkeypatch):
    """The samplers' own streams: with the generator put on the CPU, the card
    runs the CPU's draws (one generator a draw for every chain)."""
    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch.samplers import barker, elliptical, stretch
    from hamiltorch_tpu_torch.utils import rng as trng

    def cpu_generator(key, stream, n, device=None, slot=0):
        return trng.stream_generator(key, stream, n, "cpu", slot)

    for mod in (barker, elliptical, stretch):
        monkeypatch.setattr(mod, "stream_generator", cpu_generator)

    def go(device):
        t0 = torch.zeros(4, dtype=torch.float64, device=device)
        return (tht.run_barker_chains(1, _ripple_lp, t0, tht.BarkerConfig(30, burn=10), 3).samples,
                tht.run_stretch(1, _ripple_lp, t0, tht.StretchConfig(30), 8).samples,
                tht.run_elliptical_chains(1, _ripple_lp, t0, tht.EllipticalConfig(30), 3).samples)

    for card, host in zip(go(cuda_device), go("cpu")):
        assert card.device.type == "cuda" and _max_rel(card, host) <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("runner", ["barker", "stretch"])
def test_gradient_free_checkpoints_on_card(cuda_device, tmp_path, runner):
    """Stopped part-way and resumed on the card: the straight run bit for bit."""
    import dataclasses

    import hamiltorch_tpu_torch as tht
    from hamiltorch_tpu_torch import checkpoint as ck

    t0 = torch.zeros(4, device=cuda_device)
    if runner == "barker":
        cfg = tht.BarkerConfig(num_samples=40, burn=20, adapt_scale=True)
        want = tht.run_barker(2, _ripple_lp, t0, cfg)
        ck.run_barker_checkpointed(2, _ripple_lp, t0, dataclasses.replace(cfg, num_samples=25),
                                   str(tmp_path), chunk_size=7)
        got = ck.run_barker_checkpointed(2, _ripple_lp, t0, cfg, str(tmp_path), chunk_size=7)
        assert torch.equal(got.scale, want.scale)
    else:
        cfg = tht.StretchConfig(num_samples=40)
        want = tht.run_stretch(2, _ripple_lp, t0, cfg, 8)
        ck.run_stretch_checkpointed(2, _ripple_lp, t0, dataclasses.replace(cfg, num_samples=25),
                                    str(tmp_path), chunk_size=7, num_walkers=8)
        got = ck.run_stretch_checkpointed(2, _ripple_lp, t0, cfg, str(tmp_path), chunk_size=7,
                                          num_walkers=8)
    assert got.samples.device.type == "cuda" and torch.equal(got.samples, want.samples)


@pytest.mark.gpu
def test_optim_on_card_matches_cpu_in_float64(cuda_device):
    """map_estimate (Adam on the card, the same update), advi mean-field and
    full-rank on injected normals, laplace_approx: within 1e-10."""
    import hamiltorch_tpu_torch as tht

    rng = np.random.RandomState(24)
    noise = torch.as_tensor(rng.randn(150, 4, 5))

    def go(device):
        t0 = torch.zeros(5, dtype=torch.float64, device=device)
        m = tht.map_estimate(_ripple_lp, t0, num_steps=200, learning_rate=0.05)
        lap = tht.laplace_approx(_ripple_lp, m.theta)
        fits = [tht.advi(_ripple_lp, t0, num_steps=150, learning_rate=0.05, method=method,
                         _noise=noise.to(device)) for method in ("meanfield", "fullrank")]
        return [m.theta, lap.cov, lap.log_evidence] + [f.mean for f in fits] + [
            fits[0].log_std, fits[1].scale_tril]

    for card, host in zip(go(cuda_device), go("cpu")):
        assert card.device.type == "cuda"
        assert float((card.cpu() - host).abs().max()) <= 1e-10 * max(float(host.abs().max()), 1.0)


def _svgd_small(device):
    """20 SVGD steps of 16 float64 particles on a small ripple target from one
    CPU-drawn cloud (the update runs in float32, as the JAX package's)."""
    import hamiltorch_tpu_torch as tht

    gen = torch.Generator().manual_seed(7)
    p0 = torch.randn(16, 3, generator=gen, dtype=torch.float64)
    s = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64, device=device)
    return tht.run_svgd(0, lambda t: -0.5 * torch.sum((t / s) ** 2) + 0.2 * torch.sum(torch.sin(t)),
                        torch.zeros(3, dtype=torch.float64, device=device),
                        tht.SVGDConfig(num_steps=20, step_size=0.05), 16, particles0=p0.to(device))


@pytest.mark.gpu
def test_svgd_on_card_matches_cpu_in_float64(cuda_device):
    """Float64 particles, a float32 update on both sides (as the JAX
    package's): the card's and the CPU's float32 products differ in their
    last bits and AdaGrad's division grows it (7.5e-7 of max |x| after 20
    steps on the H100), so the float32 class 1e-5 of the kernel tests."""
    card, host = _svgd_small(cuda_device), _svgd_small("cpu")
    assert card.particles.device.type == "cuda" and int(card.num_rejected) == 0
    assert card.particles.dtype == torch.float64
    err = float((card.particles.cpu() - host.particles).abs().max())
    assert err <= 1e-5 * float(host.particles.abs().max())


@pytest.mark.gpu
def test_one_rank_nccl_mesh_runs_the_chains_sharded_hmc_bit_for_bit(cuda_device):
    """``make_mesh()`` on the card: a one-rank NCCL group, and the
    chains-sharded HMC on it equals ``run_hmc_chains`` bit for bit."""
    import torch.distributed as dist

    from hamiltorch_tpu_torch.parallel import sharding as sh

    lp, params0 = make_flagship_potential_tree(in_dim=8, hidden=4, n_data=16, device=cuda_device)
    cfg = MCMCConfig(num_samples=4, num_steps_per_sample=5, step_size=0.05)
    mesh = sh.make_mesh()
    try:
        assert dist.get_backend() == "nccl" and sh.mesh_device(mesh).type == "cuda"
        got = sh.run_hmc_chains_sharded(3, lp, params0, cfg, mesh, 8)
    finally:
        dist.destroy_process_group()
    want = run_hmc_chains(3, lp, params0, cfg, 8)
    for k, v in want.samples.items():
        assert got.samples[k].device.type == "cuda" and torch.equal(got.samples[k], v), k
    assert torch.equal(got.stats.accepted, want.stats.accepted)


def test_make_mesh_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    """``make_mesh`` follows ``resolve_device``: with no card and no device
    it raises before it starts a process group; ``device="cpu"`` runs a
    one-rank gloo group (here with CUDA masked)."""
    import torch.distributed as dist

    from hamiltorch_tpu_torch.parallel import sharding as sh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sh.make_mesh()
    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and sh.mesh_device(mesh).type == "cpu"
    finally:
        dist.destroy_process_group()


# ---- the recorder (utils/profiling.py) inside the fused paths ----


def recorded(fn):
    """fn() with the recorder on and emptied first: (its result, spans, counters)."""
    from hamiltorch_tpu_torch.utils import profiling

    profiling.reset()
    with profiling.recording():
        out = fn()
    torch.cuda.synchronize()
    got = profiling.spans(), profiling.counters()
    profiling.reset()
    return (out, *got)


def check_call_spans(spans, entry):
    """One top-level call of ``entry`` with its prepare, enqueue and
    prologue children, the prologue (stamped in C) inside the enqueue."""
    by = {s.name: s for s in spans}
    assert [s.name for s in spans if s.parent is None] == [entry]
    top = by[entry]
    for part in ("prepare", "enqueue", "prologue"):
        child = by[f"{entry}.{part}"]
        assert child.parent == top.id and child.call == top.id
        assert top.start_ns <= child.start_ns <= child.end_ns <= top.end_ns
    enqueue, prologue = by[f"{entry}.enqueue"], by[f"{entry}.prologue"]
    assert enqueue.start_ns <= prologue.start_ns <= prologue.end_ns <= enqueue.end_ns


# (I, H, N, C, draws, steps)
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 128, 100, 3, 2, 3), (113, 256, 200, 5, 3, 5)])
def test_bnn_hmc_counts_its_launches(cuda_device, shape):
    i_dim, h, n, c, draws, steps = shape
    args = bnn_args(i_dim, h, n, c, 4, cuda_device)
    _, spans, counters = recorded(lambda: bnn_hmc(0, *args, num_samples=draws,
                                                  num_steps=steps, step_size=0.01))
    assert counters["bnn_hmc.kernel_launches"] == 9 + draws * (3 * steps + 3)
    assert 0 < counters["bnn_hmc.launch_ns"] and 0 < counters["bnn_hmc.prologue_ns"]
    check_call_spans(spans, "bnn_hmc")


@pytest.mark.gpu
@pytest.mark.parametrize("draws", [1, 4])
def test_bnn_mclmc_counts_its_launches(cuda_device, draws):
    """9 a draw (every draw after the first replays one graph of 9)."""
    args = bnn_args(50, 128, 100, 3, 4, cuda_device)
    u = torch.randn(3, 50 * 128 + 2 * 128 + 1, device=cuda_device)
    _, spans, counters = recorded(lambda: bnn_mclmc(0, *args, u, num_samples=draws,
                                                    step_size=0.05, length=1.0))
    assert counters["bnn_mclmc.kernel_launches"] == 9 + 9 * draws
    check_call_spans(spans, "bnn_mclmc")


@pytest.mark.gpu
@pytest.mark.parametrize("d,chains", [(250, 4), (300, 70)])
def test_gaussian_hmc_dense_grid_counts_its_launches(cuda_device, d, chains):
    """The any-D dense variant: the barrier's memset and one cooperative launch."""
    *args, mean, _ = gaussian_case(d, True, cuda_device, chains)
    _, spans, counters = recorded(lambda: gaussian_hmc(0, *args, 5, 4, 0.1, mean=mean,
                                                       _variant=5))
    assert counters["gaussian_hmc.kernel_launches"] == 2
    check_call_spans(spans, "gaussian_hmc")


def bnn_hmc_call(device):
    args = bnn_args(784, 128, 1024, 4, 6, device)
    return lambda: bnn_hmc(11, *args, num_samples=2, num_steps=4, step_size=2e-4)


def bnn_mclmc_call(device):
    args = bnn_args(784, 128, 1024, 4, 6, device)
    u = torch.randn(4, 784 * 128 + 2 * 128 + 1, generator=torch.Generator().manual_seed(3))
    return lambda: bnn_mclmc(11, *args, u.to(device), num_samples=3, step_size=2e-3, length=1.0)


def gaussian_dense_call(device):
    *args, mean, _ = gaussian_case(250, True, device, 64)
    return lambda: gaussian_hmc(11, *args, 20, 10, 0.02, mean=mean, _variant=5)


@pytest.mark.gpu
@pytest.mark.parametrize("call,kernel,phases", [
    (bnn_hmc_call, "bnn_backward", ("products_cycles", "epilogue_cycles")),
    (bnn_mclmc_call, "bnn_backward", ("products_cycles", "epilogue_cycles")),
    (gaussian_dense_call, "dense_grid", ("product_cycles", "epilogue_cycles", "barrier_cycles",
                                         "between_draws_cycles")),
], ids=["bnn_hmc", "bnn_mclmc", "gaussian_hmc"])
def test_recorder_leaves_outputs_bit_identical_and_counts_every_phase(cuda_device, call, kernel,
                                                                      phases):
    fn = call(cuda_device)
    off = fn()
    on, _, counters = recorded(fn)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    for phase in phases:
        assert counters[f"{kernel}.{phase}"] > 0, phase
