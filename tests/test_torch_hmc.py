"""Port vs JAX package: the HMC chain sampler as a whole.

* Draw for draw: the test computes the JAX driver's own per-draw noise
  (``split(key, C)``, then ``split(fold_in(keys[c], n))`` into a momentum
  normal and a Metropolis uniform) and feeds it to the port's noise hook.
  The port must then reproduce ``hamiltorch_tpu.run_hmc_chains`` on the
  tiny flagship: identical accept decisions, and samples within float32
  tolerance (atol 1e-5: both run float32 on the CPU, sums in another order;
  with step-size adaptation 2e-3, for the reason given in the test).
* Within the port, chunked runs reproduce the unchunked one bit for bit.
* Statistics: pooled chains on a 3-D Gaussian recover its moments within
  the tolerances of ``tests/test_kernels.py`` (mean atol 0.1, std rtol 0.1).
* The ``sample()`` façade keeps the JAX package's return convention and
  raises on the same bad inputs.
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
from hamiltorch_tpu_torch.ops.mass import make_mass
from hamiltorch_tpu_torch.ops.potential import value_and_grad
from hamiltorch_tpu_torch.samplers.driver import ChainState, MCMCConfig, run_mcmc
from hamiltorch_tpu_torch.samplers.hmc import hmc_transition
from hamiltorch_tpu_torch.utils.pytree import tree_leaves
from hamiltorch_tpu_torch.utils.rng import draw_noise

TINY = (8, 4, 16)  # in_dim, hidden, n_data
DIM = jflag.flagship_dims(*TINY[:2])


def jax_flagship_data(in_dim, hidden, n_data, seed=0):
    """x, y, theta0 exactly as hamiltorch_tpu.models.flagship draws them."""
    k_x, k_w, k_init = jax.random.split(jax.random.key(seed), 3)
    x = jax.random.normal(k_x, (n_data, in_dim), jnp.float32)
    w_teacher = jax.random.normal(k_w, (in_dim,), jnp.float32) / jnp.sqrt(in_dim)
    y = jnp.tanh(x @ w_teacher)[:, None]
    theta0 = 0.01 * jax.random.normal(k_init, (jflag.flagship_dims(in_dim, hidden),), jnp.float32)
    return np.asarray(x), np.asarray(y), np.asarray(theta0)


def jax_driver_noise(key, num_chains, num_samples, dim):
    """The JAX driver's (z (S, C, D), log_u (S, C)) for run_hmc_chains(key)."""

    def one(k, n):
        k_prop, k_mh = jax.random.split(jax.random.fold_in(k, n))
        return (jax.random.normal(k_prop, (dim,), jnp.float32),
                jnp.log(jax.random.uniform(k_mh, (), jnp.float32)))

    keys = jax.random.split(key, num_chains)
    z, log_u = jax.vmap(lambda k: jax.vmap(lambda n: one(k, n))(jnp.arange(num_samples)))(keys)
    return (torch.as_tensor(np.asarray(z).transpose(1, 0, 2).copy()),
            torch.as_tensor(np.asarray(log_u).T.copy()))


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("adapt", [False, True])
def test_run_hmc_chains_matches_jax_draw_for_draw(form, adapt):
    num_chains, num_samples = 4, 20
    x, y, theta0 = jax_flagship_data(*TINY)
    kw = dict(num_samples=num_samples, num_steps_per_sample=5, step_size=0.06)
    # Without adaptation the states agree to float32 rounding.  With it, the
    # dual-averaging recursion scales the rounding of the energies by
    # sqrt(t)/gamma ~ 50 into the step size (rtol up to 2e-4 here), and this stiff
    # little posterior (tau=10) grows that over the draws: atol 2e-3.
    atol = 1e-5
    if adapt:
        kw.update(burn=8, adapt_step_size=True, step_size=0.15)
        atol = 2e-3
    key = jax.random.key(42)
    if form == "flat":
        j_lp, j_theta0 = jflag.make_flagship_potential(*TINY)
        t_lp, t_theta0 = tflag.make_flagship_potential(*TINY, x=x, y=y, theta0=theta0, device="cpu")
    else:
        j_lp, j_theta0 = jflag.make_flagship_potential_tree(*TINY)
        t_lp, t_theta0 = tflag.make_flagship_potential_tree(*TINY, x=x, y=y, theta0=theta0, device="cpu")

    j_res = jht.run_hmc_chains(key, j_lp, j_theta0, jht.MCMCConfig(**kw), num_chains)
    t_res = tht.run_hmc_chains(0, t_lp, t_theta0, tht.MCMCConfig(**kw), num_chains,
                               _noise=jax_driver_noise(key, num_chains, num_samples, DIM))

    j_acc = np.asarray(j_res.stats.accepted)
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), j_acc)
    assert 0 < j_acc.mean() < 1  # the Metropolis test both accepts and rejects here
    j_samples = jax.tree_util.tree_map(np.asarray, j_res.samples)
    if form == "flat":
        np.testing.assert_allclose(t_res.samples.numpy(), j_samples, atol=atol)
    else:
        for k in sorted(j_samples):
            np.testing.assert_allclose(t_res.samples[k].numpy(), j_samples[k], atol=atol)
    # energies of accepted proposals (a rejected one may have blown up to
    # ~1e15, where the two frameworks' rounding differs in the 2nd digit)
    acc = j_acc.astype(bool)
    np.testing.assert_allclose(t_res.stats.energy_new.numpy()[acc],
                               np.asarray(j_res.stats.energy_new)[acc],
                               rtol=1e-5 if not adapt else 1e-3)
    np.testing.assert_allclose(t_res.stats.step_size.numpy(), np.asarray(j_res.stats.step_size),
                               rtol=1e-5 if not adapt else 1e-3)
    np.testing.assert_allclose(t_res.acc_rate.numpy(), np.asarray(j_res.acc_rate), rtol=1e-6)


@pytest.mark.parametrize("thin", [1, 2])
def test_run_hmc_matches_jax_single_chain(thin):
    """One chain, thinned or not: the run_hmc entry and the thin bookkeeping."""
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    cfg = dict(num_samples=12, num_steps_per_sample=4, step_size=0.6, thin=thin)
    key = jax.random.key(3)
    j_res = jht.run_hmc(key, lambda t: -0.5 * jnp.sum((t / scale) ** 2), jnp.ones(3),
                        jht.MCMCConfig(**cfg))
    # run_hmc draws with the chain's key itself, not with split(key, C)[c]
    k_prop = [jax.random.split(jax.random.fold_in(key, n)) for n in range(12)]
    z = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k[0], (3,))) for k in k_prop]))
    log_u = torch.as_tensor(np.stack([np.log(np.asarray(jax.random.uniform(k[1], ())))
                                      for k in k_prop]))
    t_res = tht.run_hmc(0, lambda t: -0.5 * torch.sum((t / torch.as_tensor(scale)) ** 2),
                        torch.ones(3), tht.MCMCConfig(**cfg), _noise=(z, log_u))
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    np.testing.assert_array_equal(t_res.stats.divergent.numpy(), np.asarray(j_res.stats.divergent))
    np.testing.assert_allclose(t_res.samples.numpy(), np.asarray(j_res.samples), atol=1e-5)
    np.testing.assert_allclose(t_res.stats.accept_prob.numpy(), np.asarray(j_res.stats.accept_prob),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(t_res.acc_rate), float(j_res.acc_rate), rtol=1e-6)


def test_chunked_run_reproduces_unchunked():
    lp, theta0 = tflag.make_flagship_potential(*TINY, device="cpu")
    vg = value_and_grad(lp)
    theta = theta0.expand(3, -1).clone()
    logp, grad = torch.func.vmap(vg)(theta)
    state = ChainState(theta, logp, grad)
    transition = torch.func.vmap(hmc_transition(vg, make_mass(None, DIM), 4))
    cfg = lambda n: MCMCConfig(num_samples=n, num_steps_per_sample=4,  # noqa: E731
                               step_size=0.1, burn=5, adapt_step_size=True)
    whole = run_mcmc(9, state, transition, cfg(10))
    first = run_mcmc(9, state, transition, cfg(6))
    second = run_mcmc(9, first.final_state, transition, cfg(4), init_da=first.final_da,
                      start_iter=6)
    assert torch.equal(whole.samples, torch.cat([first.samples, second.samples], dim=1))
    assert torch.equal(whole.final_step_size, second.final_step_size)


def test_chain_streams_do_not_depend_on_chain_count():
    z2, u2 = draw_noise(5, 3, 2, 7)
    z4, u4 = draw_noise(5, 3, 4, 7)
    assert torch.equal(z2, z4[:2]) and torch.equal(u2, u4[:2])
    z_next, _ = draw_noise(5, 4, 2, 7)
    assert not torch.equal(z2, z_next)
    assert not torch.equal(z4[0], z4[1])


def test_pooled_gaussian_moments():
    stds = torch.tensor([0.5, 1.0, 2.0])
    # the trajectory of the JAX package's own kernel-statistics test
    # (tests/test_kernels.py), 6 x 0.2, keeps off the t ~ pi*sigma resonance
    # of the std-0.5 dimension; 64 chains x 850 kept draws
    cfg = MCMCConfig(num_samples=1000, num_steps_per_sample=6, step_size=0.2)
    res = tht.run_hmc_chains(0, lambda t: -0.5 * torch.sum((t / stds) ** 2), torch.zeros(3),
                             cfg, num_chains=64)
    pooled = res.samples[:, 150:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(pooled.mean(0), np.zeros(3), atol=0.1)
    np.testing.assert_allclose(pooled.std(0), stds.numpy(), rtol=0.1)
    assert float(res.acc_rate.mean()) > 0.8


def _gauss_j(t):
    return -0.5 * jnp.sum((t / jnp.array([0.5, 1.0, 2.0])) ** 2)


def _gauss_t(t):
    return -0.5 * torch.sum((t / torch.tensor([0.5, 1.0, 2.0])) ** 2)


@pytest.mark.parametrize("burn,thin,sampler", [
    (0, 1, "HMC"), (5, 1, "HMC"), (-1, 1, "HMC"), (4, 2, "HMC"), (6, 1, "HMC_NUTS"),
])
def test_sample_return_convention(burn, thin, sampler):
    kw = dict(num_samples=20, num_steps_per_sample=3, step_size=0.3, burn=burn, thin=thin,
              verbose=False, debug=2)
    j_s, j_aux = jht.sample(_gauss_j, jnp.ones(3), sampler=getattr(jht.Sampler, sampler),
                            key=jax.random.key(0), **kw)
    t_s, t_aux = tht.sample(_gauss_t, torch.ones(3), sampler=getattr(tht.Sampler, sampler),
                            key=0, **kw)
    assert tuple(t_s.shape) == tuple(j_s.shape)
    assert torch.equal(t_s[0], torch.ones(3))
    assert isinstance(t_aux, float) and isinstance(j_aux, float)
    if sampler == "HMC":
        assert 0.0 <= t_aux <= 1.0


def test_sample_tuple_log_prob_and_pass_grad():
    base = tht.sample(_gauss_t, torch.ones(3), num_samples=8, key=4, verbose=False)
    tup = tht.sample(lambda t: (_gauss_t(t), t), torch.ones(3), num_samples=8, key=4,
                     verbose=False)
    exact = tht.sample(_gauss_t, torch.ones(3), num_samples=8, key=4, verbose=False,
                       pass_grad=lambda t: -t / torch.tensor([0.25, 1.0, 4.0]))
    torch.testing.assert_close(tup, base)
    torch.testing.assert_close(exact, base)


def test_set_random_seed_makes_keyless_sample_reproducible():
    runs = []
    for seed in (7, 7, 8):
        assert tht.set_random_seed(seed) == seed
        runs.append(tht.sample(_gauss_t, torch.ones(3), num_samples=6, verbose=False))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_sample_error_probes():
    with pytest.raises(RuntimeError, match="1d"):
        tht.sample(_gauss_t, torch.zeros(2, 3), num_samples=5, verbose=False)
    with pytest.raises(RuntimeError, match="burn"):
        tht.sample(_gauss_t, torch.zeros(3), num_samples=5, burn=5, verbose=False)
    with pytest.raises(RuntimeError, match="non-finite"):
        tht.sample(_gauss_t, torch.tensor([0.0, float("nan"), 0.0]), verbose=False)
    with pytest.raises(RuntimeError, match="adapt_mass requires burn"):
        tht.sample(_gauss_t, torch.zeros(3), num_samples=5, adapt_mass=True, verbose=False)
    # RMHMC and the splitting integrators are ported: RMHMC samples, and a
    # splitting integrator wants a list of per-term log-probs, as in the JAX
    # package (tests/test_torch_rmhmc.py and test_torch_splitting.py hold them)
    rm = tht.sample(_gauss_t, torch.zeros(3), num_samples=3, num_steps_per_sample=2,
                    verbose=False, key=1, sampler=tht.Sampler.RMHMC)
    assert rm.shape == (3, 3) and bool(torch.isfinite(rm).all())
    with pytest.raises(RuntimeError, match="must be list of functions"):
        tht.sample(_gauss_t, torch.zeros(3), num_samples=5, verbose=False,
                   integrator=tht.Integrator.SPLITTING)
    # NUTS is ported: sample() keeps run_nuts's draws after the first, behind
    # the initial point
    nuts = tht.sample(_gauss_t, torch.zeros(3), num_samples=5, key=1, verbose=False,
                      sampler=tht.Sampler.NUTS)
    direct = tht.run_nuts(1, _gauss_t, torch.zeros(3),
                          tht.NUTSConfig(num_samples=5, adapt_step_size=False))[0]
    assert torch.equal(nuts[1:], direct.samples[1:])
    # host offload and progress lines are ported: the same draws as the plain call
    plain = tht.sample(_gauss_t, torch.zeros(3), num_samples=5, key=1, verbose=False)
    for kw in (dict(store_on_GPU=False), dict(progress_every=2)):
        got = tht.sample(_gauss_t, torch.zeros(3), num_samples=5, key=1, verbose=False, **kw)
        assert torch.equal(got, plain), kw
    assert MCMCConfig(num_samples=5, progress_every=50).progress_every == 50


def test_nan_cliff_does_not_crash():
    """A log-prob that turns NaN past |x| > 1: divergences are data."""

    def cliff(t):
        return torch.where(torch.abs(t).max() > 1.0, torch.tensor(float("nan")), -0.5 * torch.sum(t**2))

    res = tht.run_hmc(2, cliff, torch.zeros(2),
                      MCMCConfig(num_samples=30, num_steps_per_sample=5, step_size=0.4))
    assert bool(torch.all(torch.isfinite(res.samples)))
    assert bool(res.stats.divergent.any())
    assert bool(torch.all(res.samples.abs() <= 1.0))
    assert not bool(torch.any(res.stats.accepted & res.stats.divergent))
    assert all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(res.final_state.theta))
