"""Port vs JAX package: MAMS (``samplers/mams.py``).

The test computes the JAX sampler's own per-draw noise (per-chain keys
``split(key, C)``, then ``split(fold_in(key_c, g))`` into the velocity's
normals and the Metropolis uniform) and hands it to the port's noise hook.
Then, on a flat 5-D correlated Gaussian and the tiny flagship BNN tree,
with both integrators:

* at a fixed step size (thinned or not) the accept decisions are identical
  and the samples agree within 1e-5 (float32 on both sides; the port sums
  dE in float64, the JAX code in float32);
* with step-size adaptation the accept decisions are identical, the step
  sizes agree within rtol 1e-4 and the samples within 1e-3 (16 draws, 8 of
  burn): the port's float64 dE differs from the JAX float32 sum by float32
  rounding, and dual averaging scales that by sqrt(t) / gamma into the step
  size, which then moves each trajectory (and its dE, which is not compared
  here);
* each case's least |log u - log_ratio| over every draw is >= 1e-4, so no
  decision sits on a float32 tie that the float64 dE could flip.

Within the port, chunked runs (``init_da`` / ``start_step``) reproduce the
straight run bit for bit, and bad configurations raise the JAX package's
exception types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.models.flagship as jflag
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu_torch.models import flagship as tflag
from test_torch_hmc import TINY, jax_flagship_data

DIM = jflag.flagship_dims(*TINY[:2])
CHAINS = 3

_rng = np.random.default_rng(0)
_A = _rng.standard_normal((5, 5))
PRECISION = np.linalg.inv(_A @ _A.T / 5 + 0.5 * np.eye(5)).astype(np.float32)


def jax_mams_noise(key, num_chains, num_samples, dims):
    """The JAX sampler's (z (S, C, D), u (S, C)) for run_mams_chains(key)."""

    def one(k, g):
        k_u, k_mh = jax.random.split(jax.random.fold_in(k, g))
        return (jax.random.normal(k_u, (dims,), jnp.float32),
                jax.random.uniform(k_mh, (), jnp.float32))

    keys = jax.random.split(key, num_chains)
    z, u = jax.vmap(lambda k: jax.vmap(lambda g: one(k, g))(jnp.arange(num_samples)))(keys)
    return (torch.as_tensor(np.asarray(z).transpose(1, 0, 2).copy()),
            torch.as_tensor(np.asarray(u).T.copy()))


def targets(form):
    """(JAX log-prob, JAX theta0, port log-prob, port theta0, dims, fixed step)."""
    if form == "flat":
        jp, tp = jnp.asarray(PRECISION), torch.as_tensor(PRECISION)
        return (lambda t: -0.5 * t @ jp @ t, jnp.ones(5),
                lambda t: -0.5 * t @ tp @ t, torch.ones(5), 5, 1.4)
    x, y, theta0 = jax_flagship_data(*TINY)
    j_lp, j_theta0 = jflag.make_flagship_potential_tree(*TINY)
    t_lp, t_theta0 = tflag.make_flagship_potential_tree(*TINY, x=x, y=y, theta0=theta0,
                                                        device="cpu")
    return j_lp, j_theta0, t_lp, t_theta0, DIM, 0.5


def as_numpy_tree(samples):
    """{leaf name: array}; a flat trace is one leaf."""
    if isinstance(samples, dict):
        return {k: np.asarray(v) for k, v in samples.items()}
    return {"": np.asarray(samples)}


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("integrator", ["mclachlan", "leapfrog"])
@pytest.mark.parametrize("mode", ["fixed", "thin2", "adapt"])
def test_run_mams_chains_matches_jax_draw_for_draw(form, integrator, mode):
    j_lp, j_theta0, t_lp, t_theta0, dims, step = targets(form)
    num_samples = 24 if mode != "adapt" else 16
    cfg = dict(num_samples=num_samples, num_steps_per_sample=4, integrator=integrator,
               adapt_step_size=False, step_size=step)
    if mode == "thin2":
        cfg["thin"] = 2
    if mode == "adapt":
        cfg.update(burn=8, adapt_step_size=True, step_size=0.5 * step)
    key = jax.random.key(7 if mode != "adapt" else 8)
    z, u = jax_mams_noise(key, CHAINS, num_samples, dims)

    j_res = jht.run_mams_chains(key, j_lp, j_theta0, jht.MAMSConfig(**cfg), CHAINS)
    t_res = tht.run_mams_chains(0, t_lp, t_theta0, tht.MAMSConfig(**cfg), CHAINS, _noise=(z, u))

    # every draw's margin, from the unthinned JAX run (thinning keeps the
    # stream: the draws are the same)
    j_every = j_res if mode != "thin2" else jht.run_mams_chains(
        key, j_lp, j_theta0, jht.MAMSConfig(**dict(cfg, thin=1)), CHAINS)
    margin = np.min(np.abs(np.log(u.numpy().T) + np.asarray(j_every.stats.energy_change)))
    assert margin >= 1e-4
    j_acc = np.asarray(j_every.stats.accepted)
    assert 0 < j_acc.mean() < 1  # both Metropolis outcomes occur

    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    np.testing.assert_array_equal(t_res.stats.divergent.numpy(), np.asarray(j_res.stats.divergent))
    atol, rtol = (1e-3, 1e-4) if mode == "adapt" else (1e-5, 1e-6)
    want, got = as_numpy_tree(j_res.samples), as_numpy_tree(t_res.samples)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol)
    np.testing.assert_allclose(t_res.stats.step_size.numpy(), np.asarray(j_res.stats.step_size),
                               rtol=rtol)
    np.testing.assert_allclose(t_res.step_size.numpy(), np.asarray(j_res.step_size), rtol=rtol)
    if mode != "adapt":
        np.testing.assert_allclose(t_res.stats.energy_change.numpy(),
                                   np.asarray(j_res.stats.energy_change), atol=2e-5)
    np.testing.assert_allclose(t_res.acc_rate.numpy(), np.asarray(j_res.acc_rate), atol=1e-4)
    assert t_res.final_step.tolist() == [num_samples] * CHAINS


def test_run_mams_single_chain_matches_jax():
    """run_mams draws with the key itself (no per-chain split)."""
    j_lp, j_theta0, t_lp, t_theta0, dims, step = targets("flat")
    cfg = dict(num_samples=16, num_steps_per_sample=3, adapt_step_size=False, step_size=step)
    key = jax.random.key(5)
    ks = [jax.random.split(jax.random.fold_in(key, g)) for g in range(16)]
    z = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k[0], (dims,))) for k in ks]))
    u = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k[1], ())) for k in ks]))
    j_res = jht.run_mams(key, j_lp, j_theta0, jht.MAMSConfig(**cfg))
    t_res = tht.run_mams(0, t_lp, t_theta0, tht.MAMSConfig(**cfg), _noise=(z, u))
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    np.testing.assert_allclose(t_res.samples.numpy(), np.asarray(j_res.samples), atol=1e-5)
    np.testing.assert_allclose(t_res.final_theta.numpy(), np.asarray(j_res.final_theta), atol=1e-5)
    assert int(t_res.final_step) == 16


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_chunked_run_reproduces_unchunked(form):
    """Resuming from final_theta / final_da / final_step gives the straight
    run bit for bit (Philox streams, no hook; a fresh run must be longer
    than its burn, so the chunks meet after it)."""
    _, _, t_lp, t_theta0, _, step = targets(form)
    cfg = dict(num_steps_per_sample=3, burn=5, step_size=0.5 * step)
    whole = tht.run_mams(3, t_lp, t_theta0, tht.MAMSConfig(num_samples=14, **cfg))
    first = tht.run_mams(3, t_lp, t_theta0, tht.MAMSConfig(num_samples=6, **cfg))
    second = tht.run_mams(3, t_lp, first.final_theta, tht.MAMSConfig(num_samples=8, **cfg),
                          init_da=first.final_da, start_step=int(first.final_step))
    glue = torch.cat if form == "flat" else (
        lambda parts: {k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    joined = glue([first.samples, second.samples])
    if form == "flat":
        assert torch.equal(joined, whole.samples)
    else:
        assert all(torch.equal(joined[k], whole.samples[k]) for k in whole.samples)
    assert torch.equal(torch.cat([first.stats.accepted, second.stats.accepted]),
                       whole.stats.accepted)
    assert torch.equal(second.step_size, whole.step_size)


def test_chains_are_batched_independent_streams():
    """Chain c of a C-chain run is the same as chain c of a larger run."""
    _, _, t_lp, t_theta0, _, step = targets("flat")
    cfg = tht.MAMSConfig(num_samples=10, num_steps_per_sample=3, burn=4, step_size=step)
    small = tht.run_mams_chains(4, t_lp, t_theta0, cfg, 2)
    large = tht.run_mams_chains(4, t_lp, t_theta0, cfg, 3)
    assert torch.equal(small.samples, large.samples[:2])
    assert not torch.equal(large.samples[0], large.samples[1])


def test_pooled_gaussian_moments():
    """Exactness: pooled post-burn draws recover the covariance."""
    _, _, t_lp, _, _, _ = targets("flat")
    cfg = tht.MAMSConfig(num_samples=400, num_steps_per_sample=6, burn=100, step_size=0.5)
    res = tht.run_mams_chains(9, t_lp, torch.zeros(5), cfg, 16)
    draws = res.samples[:, 100:].reshape(-1, 5).double()
    cov = np.linalg.inv(PRECISION.astype(np.float64))
    np.testing.assert_allclose(torch.cov(draws.T).numpy(), cov, atol=0.15 * np.abs(cov).max())
    assert 0.7 < float(res.acc_rate.mean()) < 1.0


def test_divergent_trajectory_is_rejected():
    """A log-prob that turns NaN past |x| > 1: divergences are data."""

    def cliff(t):
        return torch.where(torch.abs(t).max() > 1.0, torch.tensor(float("nan")),
                           -0.5 * torch.sum(t**2))

    cfg = tht.MAMSConfig(num_samples=30, num_steps_per_sample=5, step_size=0.5, burn=10)
    res = tht.run_mams(2, cliff, torch.zeros(3), cfg)
    assert bool(torch.all(torch.isfinite(res.samples)))
    assert bool(res.stats.divergent.any())
    assert not bool(torch.any(res.stats.accepted & res.stats.divergent))
    assert bool(torch.all(res.samples.abs() <= 1.0))
    assert bool(torch.isfinite(res.step_size))


BAD_CONFIGS = [
    dict(num_samples=0),
    dict(num_samples=10, num_steps_per_sample=0),
    dict(num_samples=10, step_size=0.0),
    dict(num_samples=10, burn=-1),
    dict(num_samples=10, burn=0),  # adapt_step_size needs burn
    dict(num_samples=10, burn=2, desired_accept_rate=1.0),
    dict(num_samples=10, burn=2, integrator="verlet"),
    dict(num_samples=10, burn=2, thin=0),
    dict(num_samples=10, burn=2, thin=3),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_config_errors_match_jax(kw):
    with pytest.raises(Exception) as j_err:
        jht.MAMSConfig(**kw)
    with pytest.raises(j_err.type):
        tht.MAMSConfig(**kw)


def test_burn_must_be_less_than_num_samples():
    cfg = dict(num_samples=5, burn=5)
    for run in (lambda: jht.run_mams(jax.random.key(0), lambda t: -jnp.sum(t**2), jnp.ones(2),
                                     jht.MAMSConfig(**cfg)),
                lambda: tht.run_mams(0, lambda t: -torch.sum(t**2), torch.ones(2),
                                     tht.MAMSConfig(**cfg)),
                lambda: tht.run_mams_chains(0, lambda t: -torch.sum(t**2), torch.ones(2),
                                            tht.MAMSConfig(**cfg), 2)):
        with pytest.raises(RuntimeError, match="burn"):
            run()
