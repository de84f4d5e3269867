"""Port vs JAX package: mass operators, leapfrog and one HMC transition.

The same theta, momenta and step size go through both packages.  On the
JAX side the momenta are injected with a mass stub defined here, whose
``sample`` returns the given array; on the port's side they are the ``z``
its transition takes.  float32 on the CPU in both; sums run in another
order, so states agree to atol 1e-5 and energies to a relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu.models.flagship as jflag
from hamiltorch_tpu.integrators.leapfrog import PhasePoint as JPhasePoint
from hamiltorch_tpu.integrators.leapfrog import leapfrog as j_leapfrog
from hamiltorch_tpu.ops import mass as jmass
from hamiltorch_tpu.samplers.driver import ChainState as JChainState
from hamiltorch_tpu.samplers.hmc import hmc_transition as j_hmc_transition
from hamiltorch_tpu_torch.integrators.leapfrog import PhasePoint, leapfrog
from hamiltorch_tpu_torch.models import flagship as tflag
from hamiltorch_tpu_torch.ops import mass as tmass
from hamiltorch_tpu_torch.ops.potential import value_and_grad
from hamiltorch_tpu_torch.samplers.driver import ChainState
from hamiltorch_tpu_torch.samplers.hmc import hmc_transition


class GivenMomentum:
    """JAX-side identity mass whose ``sample`` returns a given momentum."""

    def __init__(self, p):
        self.p = p

    def sample(self, key, dtype=jnp.float32):
        return self.p

    def velocity(self, p):
        return p

    def kinetic(self, p):
        leaves = jax.tree_util.tree_leaves(p)
        return 0.5 * sum(jnp.sum(leaf * leaf) for leaf in leaves)


def tiny_flagship(form):
    """(jax lp, port lp, theta (numpy, flat or dict)) on shared data."""
    in_dim, hidden, n_data = 8, 4, 16
    rng = np.random.RandomState(0)
    x = rng.randn(n_data, in_dim).astype(np.float32)
    y = np.tanh(x @ rng.randn(in_dim).astype(np.float32))[:, None].astype(np.float32)
    theta = (0.3 * rng.randn(jflag.flagship_dims(in_dim, hidden))).astype(np.float32)
    t_lp, _ = (tflag.make_flagship_potential if form == "flat"
               else tflag.make_flagship_potential_tree)(in_dim, hidden, n_data, x=x, y=y, theta0=theta,
                                                    device="cpu")
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    s0, s1 = in_dim * hidden, in_dim * hidden + hidden

    def split(t):
        return {"w1": t[:s0].reshape(in_dim, hidden), "b1": t[s0:s1],
                "w2": t[s1:s1 + hidden].reshape(hidden, 1), "b2": t[s1 + hidden:]}

    def j_lp(t):
        p = split(t) if form == "flat" else t
        h = jnp.tanh(xj @ p["w1"] + p["b1"])
        out = h @ p["w2"] + p["b2"]
        prior = -0.5 * sum(jnp.sum(v * v) for v in jax.tree_util.tree_leaves(p))
        return prior - 5.0 * jnp.sum((out - yj) ** 2)

    return j_lp, t_lp, (theta if form == "flat" else split(theta)), split


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree):
    return tree if not isinstance(tree, (dict, np.ndarray)) else (
        {k: torch.as_tensor(v) for k, v in tree.items()} if isinstance(tree, dict)
        else torch.as_tensor(tree))


def close(got, want, atol=1e-5):
    for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_transition_with_given_momenta(form):
    j_lp, t_lp, theta, _ = tiny_flagship(form)
    z = np.random.RandomState(5).randn(41).astype(np.float32)
    # a tree momentum is the flat draw split in sorted-key (JAX leaf) order
    p_jax = (jnp.asarray(z) if form == "flat"
             else jmass.tree_unravel_like(to_jax(theta), jnp.asarray(z)))
    eps, L = 0.05, 7

    j_vg = jax.value_and_grad(j_lp)
    j_logp, j_grad = j_vg(to_jax(theta))
    j_state = JChainState(to_jax(theta), j_logp, j_grad)
    j_prop, j_h0, j_h1 = j_hmc_transition(j_vg, GivenMomentum(p_jax), L)(
        jax.random.key(0), j_state, eps)

    t_vg = value_and_grad(t_lp)
    t_logp, t_grad = t_vg(to_torch(theta))
    t_mass = tmass.IdentityMass(41) if form == "flat" else tmass.make_mass_tree(None, to_torch(theta))
    t_prop, t_h0, t_h1 = hmc_transition(t_vg, t_mass, L)(
        torch.as_tensor(z), ChainState(to_torch(theta), t_logp, t_grad), eps)

    close(t_prop.theta, j_prop.theta)
    close(t_prop.grad, j_prop.grad, atol=1e-4)
    np.testing.assert_allclose(float(t_prop.logp), float(j_prop.logp), rtol=1e-5)
    np.testing.assert_allclose(float(t_h0), float(j_h0), rtol=1e-5)
    np.testing.assert_allclose(float(t_h1), float(j_h1), rtol=1e-5)


def make_masses(d, kind):
    rng = np.random.RandomState(7)
    if kind == "identity":
        return jmass.make_mass(None, d), tmass.make_mass(None, d)
    if kind == "diag":
        inv = (0.5 + rng.rand(d)).astype(np.float32)
        return jmass.make_mass(jnp.asarray(inv), d), tmass.make_mass(torch.as_tensor(inv), d)
    a = rng.randn(d, d).astype(np.float32)
    inv = (a @ a.T / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    return jmass.make_mass(jnp.asarray(inv), d), tmass.make_mass(torch.as_tensor(inv), d)


@pytest.mark.parametrize("kind", ["identity", "diag", "dense"])
def test_mass_operators_match(kind):
    d = 6
    j_m, t_m = make_masses(d, kind)
    key = jax.random.key(3)
    z = np.asarray(jax.random.normal(key, (d,), jnp.float32))
    p_j = j_m.sample(key)
    p_t = t_m.sample(torch.as_tensor(z))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_m.velocity(p_t).numpy(), np.asarray(j_m.velocity(p_j)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(t_m.kinetic(p_t)), float(j_m.kinetic(p_j)), rtol=1e-5)


@pytest.mark.parametrize("inv", ["none", "flat", "tree"])
def test_tree_mass_matches(inv):
    _, _, theta, split = tiny_flagship("tree")
    inv_flat = (0.5 + np.random.RandomState(8).rand(41)).astype(np.float32)
    j_inv = {"none": None, "flat": jnp.asarray(inv_flat), "tree": to_jax(split(inv_flat))}[inv]
    t_inv = {"none": None, "flat": torch.as_tensor(inv_flat), "tree": to_torch(split(inv_flat))}[inv]
    j_m = jmass.make_mass_tree(j_inv, to_jax(theta))
    t_m = tmass.make_mass_tree(t_inv, to_torch(theta))
    key = jax.random.key(4)
    z = np.asarray(jax.random.normal(key, (41,), jnp.float32))
    p_j = j_m.sample(key)
    p_t = t_m.sample(torch.as_tensor(z))
    close(p_t, p_j, atol=1e-6)
    close(t_m.velocity(p_t), j_m.velocity(p_j), atol=1e-6)
    np.testing.assert_allclose(float(t_m.kinetic(p_t)), float(j_m.kinetic(p_j)), rtol=1e-5)
    # the flat draw is split in sorted-key order: ravel gives it back
    scale = 1.0 if inv == "none" else 1.0 / np.sqrt(t_m.inner.inv_diag.numpy())
    np.testing.assert_allclose(tmass.tree_ravel(p_t).numpy(), z * scale, rtol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "diag", "dense"])
def test_leapfrog_matches(kind):
    d = 6
    j_m, t_m = make_masses(d, kind)
    prec = np.linspace(0.5, 3.0, d).astype(np.float32)
    rng = np.random.RandomState(9)
    theta, p = rng.randn(d).astype(np.float32), rng.randn(d).astype(np.float32)

    j_vg = jax.value_and_grad(lambda t: -0.5 * jnp.sum(prec * t * t))
    t_vg = value_and_grad(lambda t: -0.5 * torch.sum(torch.as_tensor(prec) * t * t))
    j_lp, j_g = j_vg(jnp.asarray(theta))
    t_lp, t_g = t_vg(torch.as_tensor(theta))
    j_end = j_leapfrog(j_vg, j_m, JPhasePoint(jnp.asarray(theta), jnp.asarray(p), j_lp, j_g), 0.1, 12)
    t_end = leapfrog(t_vg, t_m, PhasePoint(torch.as_tensor(theta), torch.as_tensor(p), t_lp, t_g), 0.1, 12)
    for a, b in zip(t_end, j_end):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_block_diagonal_mass_not_ported():
    """A list of blocks was refused until BlockDiagMass was ported; it now
    builds the block operator, which acts as the JAX package's does
    (tests/test_torch_mass_block.py holds it against JAX in full)."""
    blocks = [2.0 * np.eye(2, dtype=np.float32), np.eye(3, dtype=np.float32)]
    op = tmass.make_mass([torch.as_tensor(b) for b in blocks], 5)
    assert isinstance(op, tmass.BlockDiagMass)
    p = np.arange(5, dtype=np.float32)
    want = jmass.make_mass([jnp.asarray(b) for b in blocks], 5).velocity(jnp.asarray(p))
    np.testing.assert_allclose(op.velocity(torch.as_tensor(p)).numpy(), np.asarray(want))
