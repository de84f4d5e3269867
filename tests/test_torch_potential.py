"""Port vs JAX package: the flagship potentials and ``pass_grad``.

The same inputs, made from a seed (the JAX package's own ``jax.random``
data recipe, or numpy), go through ``hamiltorch_tpu`` and
``hamiltorch_tpu_torch``.  Both run float32 on the CPU; sums run in another
order in the two frameworks, so values agree to a relative 1e-5 and
gradients to a relative 1e-4 of their largest entry (a full-width gradient
entry is a 1024-term sum of products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu.models.flagship as jflag
from hamiltorch_tpu.ops.potential import make_log_prob as j_make_log_prob
from hamiltorch_tpu_torch.models import flagship as tflag
from hamiltorch_tpu_torch.ops.potential import make_log_prob, resolve_potential, value_and_grad
from hamiltorch_tpu_torch.utils.convert import from_jax_params


def jax_flagship_data(in_dim, hidden, n_data, seed=0):
    """x, y, theta0 exactly as hamiltorch_tpu.models.flagship draws them."""
    k_x, k_w, k_init = jax.random.split(jax.random.key(seed), 3)
    x = jax.random.normal(k_x, (n_data, in_dim), jnp.float32)
    w_teacher = jax.random.normal(k_w, (in_dim,), jnp.float32) / jnp.sqrt(in_dim)
    y = jnp.tanh(x @ w_teacher)[:, None]
    theta0 = 0.01 * jax.random.normal(k_init, (jflag.flagship_dims(in_dim, hidden),), jnp.float32)
    return np.asarray(x), np.asarray(y), np.asarray(theta0)


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


WIDTHS = {"full": (784, 128, 1024), "tiny": (8, 4, 16)}


@pytest.mark.parametrize("width", ["full", "tiny"])
@pytest.mark.parametrize("form", ["flat", "tree"])
def test_flagship_value_and_grad(width, form):
    in_dim, hidden, n_data = WIDTHS[width]
    x, y, theta0 = jax_flagship_data(in_dim, hidden, n_data)
    rng = np.random.RandomState(1)
    theta = (theta0 + 0.05 * rng.randn(theta0.size)).astype(np.float32)

    if form == "flat":
        j_lp, j_theta0 = jflag.make_flagship_potential(in_dim, hidden, n_data)
        j_point = jnp.asarray(theta)
        t_point, tx, ty = from_jax_params(theta, x, y, device="cpu")
        t_lp, t_theta0 = tflag.make_flagship_potential(
            in_dim, hidden, n_data, x=tx, y=ty, theta0=from_jax_params(theta0, device="cpu")[0],
            device="cpu")
    else:
        j_lp, j_theta0 = jflag.make_flagship_potential_tree(in_dim, hidden, n_data)
        s0, s1 = in_dim * hidden, in_dim * hidden + hidden
        split = lambda t: {"w1": t[:s0].reshape(in_dim, hidden), "b1": t[s0:s1],  # noqa: E731
                           "w2": t[s1:s1 + hidden].reshape(hidden, 1), "b2": t[s1 + hidden:]}
        j_point = jax.tree_util.tree_map(jnp.asarray, split(theta))
        t_point, tx, ty = from_jax_params(split(theta), x, y, device="cpu")
        t_lp, t_theta0 = tflag.make_flagship_potential_tree(
            in_dim, hidden, n_data, x=tx, y=ty, theta0=from_jax_params(theta0, device="cpu")[0],
            device="cpu")

    # the recipe reproduces the JAX package's initial point exactly
    for a, b in zip(jax.tree_util.tree_leaves(j_theta0),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, t_theta0))):
        np.testing.assert_array_equal(np.asarray(a), b)

    j_val, j_grad = jax.value_and_grad(j_lp)(j_point)
    t_val, t_grad = value_and_grad(t_lp)(t_point)
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5)
    for k in (sorted(t_grad) if form == "tree" else [None]):
        assert_grad_close(t_grad if k is None else t_grad[k], j_grad if k is None else j_grad[k])


def test_value_and_grad_vmaps_over_chains():
    x, y, theta0 = jax_flagship_data(8, 4, 16)
    t_lp, _ = tflag.make_flagship_potential(8, 4, 16, x=x, y=y, theta0=theta0, device="cpu")
    thetas = torch.as_tensor(np.random.RandomState(2).randn(3, theta0.size).astype(np.float32))
    vals, grads = torch.func.vmap(value_and_grad(t_lp))(thetas)
    for c in range(3):
        v, g = value_and_grad(t_lp)(thetas[c])
        torch.testing.assert_close(vals[c], v)
        torch.testing.assert_close(grads[c], g)


def test_tiny_potential_matches():
    j_ll, j_prior, j_x, j_y, j_theta0 = jflag.make_tiny_potential()
    t_ll, t_prior, t_x, t_y, t_theta0 = tflag.make_tiny_potential(x=np.asarray(j_x), device="cpu")
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(t_theta0.numpy(), np.asarray(j_theta0))
    theta = np.random.RandomState(3).randn(j_theta0.size).astype(np.float32)
    np.testing.assert_allclose(
        float(t_ll(torch.as_tensor(theta), t_x, t_y)), float(j_ll(jnp.asarray(theta), j_x, j_y)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(t_prior(torch.as_tensor(theta))), float(j_prior(jnp.asarray(theta))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["callable", "constant"])
def test_pass_grad_matches(kind):
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    theta = np.array([0.3, -1.2, 2.5], np.float32)
    const = np.array([1.0, -2.0, 3.0], np.float32)

    def j_lp(t):
        return -0.5 * jnp.sum((t / scale) ** 2)

    def t_lp(t):
        return -0.5 * torch.sum((t / torch.as_tensor(scale)) ** 2)

    if kind == "callable":
        j_pg, t_pg = (lambda t: -2.0 * t), (lambda t: -2.0 * t)
    else:
        j_pg, t_pg = jnp.asarray(const), torch.as_tensor(const)
    j_val, j_grad = jax.value_and_grad(j_make_log_prob(j_lp, j_pg))(jnp.asarray(theta))
    t_val, t_grad = value_and_grad(make_log_prob(t_lp, t_pg))(torch.as_tensor(theta))
    np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-6)

    # the autograd.Function composes with vmap over chains
    thetas = torch.as_tensor(np.stack([theta, 2 * theta]))
    vals, grads = torch.func.vmap(value_and_grad(resolve_potential(t_lp, t_pg)))(thetas)
    torch.testing.assert_close(grads[0], t_grad)
    torch.testing.assert_close(vals[1], t_lp(thetas[1]))
