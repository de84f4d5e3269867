"""The BNN gradient alone: ``kernels/bnn_grad._bnn_gradient`` on the CPU.

The CUDA kernel (``csrc/bnn_grad.cu``: the GEMM pair of ``bnn_hmc`` and
``bnn_mclmc``) runs only on a card (``tests/test_torch_gpu.py``); here the
wrapper routes CPU tensors to its plain version, which must equal
``jax.value_and_grad`` of the JAX package's flagship potential
(``hamiltorch_tpu/models/flagship.py``) on the same data and parameters:
gradients within 1e-5 of the largest entry and logp within 1e-5 relative
(both sides sum float32 terms over N, in other orders; the port's logp
reduces in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.models.flagship import make_flagship_potential
from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient, _bnn_gradient_reference


def jax_data(in_dim, n_data, seed=0):
    """The x and y that make_flagship_potential draws for this seed."""
    k_x, k_w, _ = jax.random.split(jax.random.key(seed), 3)
    x = jax.random.normal(k_x, (n_data, in_dim), jnp.float32)
    w_teacher = jax.random.normal(k_w, (in_dim,), jnp.float32) / jnp.sqrt(in_dim)
    return np.array(x), np.array(jnp.tanh(x @ w_teacher)[:, None])


@pytest.mark.parametrize("in_dim,hidden,n_data,chains", [(50, 128, 100, 3), (784, 128, 64, 2),
                                                          (30, 256, 40, 2)])
def test_gradient_matches_jax_autodiff_of_the_flagship_potential(in_dim, hidden, n_data, chains):
    log_prob_fn, _ = make_flagship_potential(in_dim, hidden, n_data, tau_out=10.0, seed=0)
    x, y = jax_data(in_dim, n_data)
    d = in_dim * hidden + 2 * hidden + 1
    theta = (0.05 * np.random.RandomState(1).randn(chains, d)).astype(np.float32)
    want_logp, want_g = jax.vmap(jax.value_and_grad(log_prob_fn))(jnp.asarray(theta))
    want_logp, want_g = np.asarray(want_logp, np.float64), np.asarray(want_g)

    before = _bnn_gradient.launches
    g, logp = _bnn_gradient(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(theta), tau=10.0)
    assert _bnn_gradient.launches == before  # CPU tensors: the plain version, no launch
    assert g.shape == (chains, d) and logp.dtype == torch.float64
    assert np.abs(g.numpy() - want_g).max() <= 1e-5 * np.abs(want_g).max()
    assert np.abs((logp.numpy() - want_logp) / want_logp).max() <= 1e-5


def test_reference_is_the_wrapper_on_cpu():
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(20, 6).astype(np.float32))
    y = torch.as_tensor(rng.randn(20, 1).astype(np.float32))
    theta = torch.as_tensor(rng.randn(2, 6 * 128 + 257).astype(np.float32))
    g, logp = _bnn_gradient(x, y, theta, tau=3.0)
    g_ref, logp_ref = _bnn_gradient_reference(x, y, theta, tau=3.0)
    assert torch.equal(g, g_ref) and torch.equal(logp, logp_ref)


@pytest.mark.parametrize("bad", ["width", "dtype", "y", "repeats"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    x, y = torch.zeros(10, 6), torch.zeros(10, 1)
    theta = torch.zeros(2, 6 * 128 + 257)
    kw = {}
    if bad == "width":
        theta = torch.zeros(2, 6 * 128 + 258)
    elif bad == "dtype":
        theta = theta.double()
    elif bad == "y":
        y = torch.zeros(10)
    else:
        kw = dict(repeats=0)
    with pytest.raises((ValueError, TypeError)):
        _bnn_gradient(x, y, theta, **kw)
