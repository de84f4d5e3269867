"""The fused flagship MCLMC sampler: ``bnn_mclmc`` and its plain version.

(a) Against the Pallas kernel itself, run in interpret mode as the JAX
    package's own tests run it (``tests/test_mclmc_kernel.py:91-141``'s
    shapes, H=128, L=2).  Interpret mode's PRNG returns constant bits, so
    every refresh normal is one constant; the port's plain version takes it
    through its noise hook.  Two settings:

    * eps=2e-2, tau=1 (the JAX test's): parameters within 2e-6 and var_e
      at rtol 1e-3, atol 1e-9, as there.  Here the gradient's part of the
      move is ~1e-8, below the tolerance, and var_e (~1e-11 in the JAX
      kernel) is float32 rounding noise, so this case checks the velocity
      algebra and the refresh, not the gradient.
    * eps=1, tau=10: the gradient's part of the move (the result less the
      same run at tau=0) is >= 50x the 2e-6 tolerance in every parameter
      block, so a wrong likelihood gradient fails.  Parameters within
      2e-6; var_e (~3e-6) at rtol 1e-2: the JAX kernel computes the
      rotation's scalars in float32, where dk = (d-1)(delta - ln 2 + ...)
      loses (d-1) * 2^-24 * ln 2 ~ 1e-3 to cancellation per rotation
      against dE ~ 0.2 (the port computes them in float64).
(b) On CPU tensors the wrapper routes to the plain version and launches
    nothing; it rejects what it does not take.

The kernel itself runs only on a card: ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.kernels.bnn_mclmc import bnn_mclmc as j_bnn_mclmc
from hamiltorch_tpu_torch.kernels import bnn_mclmc, bnn_mclmc_reference
from test_torch_bnn_hmc import interpret_prng_constants

NAMES = ("x", "y", "w1", "b1", "w2", "b2", "u")
ATOL = 2e-6


def mclmc_inputs(i_dim, h, n, c, seed=0):
    rng = np.random.RandomState(seed)
    d = i_dim * h + 2 * h + 1
    return dict(
        x=rng.randn(n, i_dim).astype(np.float32),
        y=rng.randn(n, 1).astype(np.float32),
        w1=(0.01 * rng.randn(c, i_dim, h)).astype(np.float32),
        b1=np.zeros((c, h), np.float32),
        w2=(0.01 * rng.randn(c, h)).astype(np.float32),
        b2=np.zeros((c,), np.float32),
        u=rng.randn(c, d).astype(np.float32),
    )


def torch_args(inp):
    return [torch.as_tensor(inp[k]) for k in NAMES]


@pytest.mark.parametrize("eps,tau,var_rtol", [(2e-2, 1.0, 1e-3), (1.0, 10.0, 1e-2)])
@pytest.mark.parametrize("i_dim,n,c,draws", [(128, 64, 1, 3), (100, 60, 2, 3)])
def test_reference_matches_pallas_kernel_in_interpret_mode(i_dim, n, c, draws, eps, tau, var_rtol):
    h, length = 128, 2.0
    inp = mclmc_inputs(i_dim, h, n, c)
    kw = dict(num_samples=draws, step_size=eps, length=length)
    want = j_bnn_mclmc(0, *(jnp.asarray(inp[k]) for k in NAMES), tau=tau, interpret=True, **kw)
    z, _ = interpret_prng_constants()
    noise = torch.full((draws, c, inp["u"].shape[1]), z)
    got = bnn_mclmc_reference(0, *torch_args(inp), tau=tau, _noise=noise, **kw)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=var_rtol, atol=1e-9)
    if eps == 1.0:
        drift_only = bnn_mclmc_reference(0, *torch_args(inp), tau=0.0, _noise=noise, **kw)
        for a, b, name in zip(got[:4], drift_only[:4], NAMES[2:]):
            assert float((a - b).abs().max()) > 50 * ATOL, name
        assert float(got[4].min()) > 1e3 * 1e-9  # var_e is far above the atol floor


def test_cpu_wrapper_routes_to_plain_version():
    inp = mclmc_inputs(12, 128, 10, 2, seed=3)
    kw = dict(num_samples=3, step_size=0.05, length=1.0, tau=10.0)
    bnn_mclmc.launches = 0
    got = bnn_mclmc(5, *torch_args(inp), **kw)
    want = bnn_mclmc_reference(5, *torch_args(inp), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bnn_mclmc.launches == 0
    again = bnn_mclmc(5, *torch_args(inp), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert not torch.equal(got[0][0], got[0][1])  # chains draw different refresh noise


@pytest.mark.parametrize("bad", ["dtype", "shape", "u_shape", "device", "samples", "scale", "noise"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    x, y, w1, b1, w2, b2, u = torch_args(mclmc_inputs(12, 8, 10, 2))
    kw = dict(num_samples=2, step_size=0.1, length=1.0)
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        y = y[:, 0]
    elif bad == "u_shape":
        u = u[:, :-1].contiguous()
    elif bad == "device":
        x, y, w1, b1, w2, b2, u = (t.to("meta") for t in (x, y, w1, b1, w2, b2, u))
    elif bad == "samples":
        kw["num_samples"] = 0
    elif bad == "scale":
        kw["length"] = 0.0
    else:
        kw["_noise"] = torch.zeros(2, 2, 5)
    with pytest.raises((TypeError, ValueError)):
        bnn_mclmc(0, x, y, w1, b1, w2, b2, u, **kw)
