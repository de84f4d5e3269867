"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one.  They import no JAX,
so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest`` skips the suite's JAX set-up in ``tests/conftest.py``.)
Tolerances: parameters after a few draws differ only by float32 rounding of
differently ordered sums (~1e-7), so atol 1e-5; accept decisions must be
identical (energies are reduced in float64 on both sides).
"""

import numpy as np
import pytest
import torch

from hamiltorch_tpu_torch.kernels import bnn_hmc, bnn_hmc_reference
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 128, 100, 3), (784, 256, 200, 2), (784, 128, 1024, 4)])
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
    lp_h, p_h = make_flagship_potential_tree(8, 4, 16)
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
