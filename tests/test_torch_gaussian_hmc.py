"""The fused Gaussian sampler: ``gaussian_hmc`` and its plain version.

(a) Against the Pallas kernel itself, run in interpret mode as the JAX
    package's own tests run it.  Interpret mode's PRNG returns constant
    bits, so every momentum entry is one constant normal and every
    Metropolis uniform one constant; the port's plain version takes them
    through its noise hook.  Every draw must agree within atol 1e-5: both
    run the same float32 leapfrog, and they differ only by the rounding of
    fused multiply-adds and of sums taken in another order (~2e-6 seen on
    values of order 1-5).  Accept decisions must be identical (the port
    reduces the energies in float64, the JAX kernel in float32; no case
    sits on a knife edge).  A precision 1% off moves the draws by far more
    than atol, so the comparison sees a wrong gradient.
(b) On CPU tensors the wrapper routes to the plain version and launches
    nothing; it rejects what it does not take.

The kernel itself runs only on a card: ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.kernels.gaussian_hmc import gaussian_hmc as j_gaussian_hmc
from hamiltorch_tpu_torch.kernels import gaussian_hmc, gaussian_hmc_reference
from test_torch_bnn_hmc import interpret_prng_constants

ATOL = 1e-5


def _dense(d):
    a = np.random.RandomState(0).randn(d, d)
    return (a @ a.T / d + np.eye(d)).astype(np.float32)


CASES = {
    # name: (precision, mean, chains)
    "diag_d3": (np.array([4.0, 1.0, 0.25], np.float32), None, 16),
    "dense_d2": (np.linalg.inv(np.array([[1.0, 0.6], [0.6, 1.0]])).astype(np.float32), None, 8),
    "dense_d5": (_dense(5), None, 8),
    "diag_mean_d2": (np.array([1.0, 4.0], np.float32), np.array([3.0, -2.0], np.float32), 8),
    # beyond the register-resident variants: the card runs these on the
    # any-D variant (5); the JAX kernel pads D to 384
    "diag_d300": (np.linspace(0.25, 4.0, 300).astype(np.float32), None, 4),
    "dense_d260": (_dense(260), np.linspace(-1, 1, 260).astype(np.float32), 4),
}


def run_reference(theta0, prec, mean, noise, draws, steps, eps):
    return gaussian_hmc_reference(
        0, torch.as_tensor(theta0), torch.as_tensor(prec), draws, steps, eps,
        mean=None if mean is None else torch.as_tensor(mean), _noise=noise)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_kernel_in_interpret_mode(case):
    prec, mean, c = CASES[case]
    d = prec.shape[0]
    draws, steps, eps = 20, 5, 0.6
    theta0 = (np.random.RandomState(1).randn(c, d) + (0 if mean is None else mean)).astype(np.float32)
    want, want_acc = j_gaussian_hmc(
        0, jnp.asarray(theta0), jnp.asarray(prec), num_samples=draws, num_steps=steps,
        step_size=eps, interpret=True, mean=None if mean is None else jnp.asarray(mean))
    z, u = interpret_prng_constants()
    noise = (torch.full((draws, c, d), z), torch.full((draws, c), u))
    got, got_acc = run_reference(theta0, prec, mean, noise, draws, steps, eps)
    assert got.shape == (c, draws, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), rtol=1e-6)
    # the draw-for-draw comparison sees the gradient: a 1%-wrong precision
    # moves the draws far beyond the tolerance
    off, _ = run_reference(theta0, 1.01 * prec, mean, noise, draws, steps, eps)
    assert np.abs(off.numpy() - got.numpy()).max() > 100 * ATOL
    if case == "dense_d5":  # both Metropolis outcomes occur
        assert 0.0 < float(got_acc.mean()) < 1.0


def test_cpu_wrapper_routes_to_plain_version():
    prec = torch.tensor([4.0, 1.0, 0.25])
    theta0 = torch.zeros(6, 3)
    gaussian_hmc.launches = 0
    got = gaussian_hmc(5, theta0, prec, 30, 6, 0.2)
    want = gaussian_hmc_reference(5, theta0, prec, 30, 6, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert gaussian_hmc.launches == 0
    again = gaussian_hmc(5, theta0, prec, 30, 6, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert not torch.equal(got[0][0], got[0][1])  # chains draw different momenta
    assert bool(torch.isfinite(got[0]).all()) and got[0].shape == (6, 30, 3)


@pytest.mark.parametrize("bad", ["dtype", "theta_shape", "prec_shape", "mean", "device", "steps", "noise",
                                 "chain_tile", "variant"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    theta0, prec, mean = torch.zeros(4, 3), torch.ones(3), None
    kw = dict(num_samples=2, num_steps=3)
    if bad == "dtype":
        theta0 = theta0.double()
    elif bad == "theta_shape":
        theta0 = torch.zeros(3)
    elif bad == "prec_shape":
        prec = torch.ones(3, 2)
    elif bad == "mean":
        mean = torch.zeros(2)
    elif bad == "device":
        theta0, prec = theta0.to("meta"), prec.to("meta")
    elif bad == "steps":
        kw["num_steps"] = 0
    elif bad == "chain_tile":
        kw["chain_tile"] = 0
    elif bad == "variant":
        kw["_variant"] = 3
    else:
        kw["_noise"] = (torch.zeros(2, 4, 2), torch.zeros(2, 4))
    with pytest.raises((TypeError, ValueError)):
        gaussian_hmc(0, theta0, prec, mean=mean, **kw)
