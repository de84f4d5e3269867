"""Port vs JAX package: tempered SMC (``samplers/smc.py``).

The port runs on the JAX sampler's own randomness, replayed: ``split(key)``
gives ``k_init`` (unused here: both packages take the same numpy particles
from their ``prior_sample_fn``) and the run key; stage k splits
``fold_in(key, k)`` into the resample key (one uniform) and the mutation
key, split once per mutation and each of those three ways into the momentum
key (split once per leaf), the jitter key (``randint`` lengths, or a
uniform with ``adapt_trajectory``) and the Metropolis key.  They go into the
port's ``_noise={"z", "jit", "u_mh", "u_res"}``.

* Float32, N = 16 particles, flat and two-leaf tree particles, resampling
  at every stage and at ESS < 0.5, with and without ``adapt_trajectory``:
  identical resample decisions and indices (the populations agree),
  particles, log-weights and evidence within 1e-5 relative, and every
  decision (Metropolis, ESS, the resample comb against the cumsum, L = ceil(u
  T / eps)) at least 1e-4 from its other outcome.
* Float64 (``jax.enable_x64``) with step-size and trajectory adaptation:
  within 1e-10.
* ``_systematic_resample`` against the JAX function, and the clamped index
  where the float32 cumsum of the weights ends below the last comb position
  (``searchsorted`` returns n there; JAX's gather clamps it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import smc as jsmc
from hamiltorch_tpu_torch.samplers import smc as tsmc

MARGIN = 1e-4
N = 16


def model(xp, tree=False):
    """(log_prior, log_lik): N(0, I) prior on 3 coordinates, a likelihood
    with a cosine ripple."""
    total = jnp.sum if xp is jnp else torch.sum

    def flat(t):
        if not tree:
            return t
        return (jnp.concatenate([t["a"], t["b"][None]]) if xp is jnp
                else torch.cat([t["a"], t["b"][None]]))

    def log_prior(t):
        return -0.5 * total(flat(t) ** 2)

    def log_lik(t):
        x = flat(t)
        return -2.0 * total((x - 0.4) ** 2) + 0.3 * total(xp.cos(3.0 * x))
    return log_prior, log_lik


def jax_smc_noise(key, cfg, shapes, dtype):
    """The JAX runner's draws in the port's ``_noise`` layout."""
    _, key = jax.random.split(key)
    z = [[] for _ in shapes]
    jit, u_mh, u_res = [], [], []
    for k in range(cfg.num_temps):
        k_res, k_mut = jax.random.split(jax.random.fold_in(key, jnp.int32(k)))
        u_res.append(np.asarray(jax.random.uniform(k_res, ())))
        rows = [[] for _ in shapes], [], []
        for k_step in jax.random.split(k_mut, cfg.mcmc_steps):
            k_mom, k_jit, k_mh = jax.random.split(k_step, 3)
            for i, mk in enumerate(jax.random.split(k_mom, len(shapes))):
                rows[0][i].append(np.asarray(jax.random.normal(mk, shapes[i], dtype)))
            if cfg.adapt_trajectory:
                rows[1].append(np.asarray(jax.random.uniform(k_jit, (), dtype)))
            else:
                rows[1].append(1 + int(jax.random.randint(k_jit, (), 0, cfg.leapfrog_steps)))
            rows[2].append(np.asarray(jax.random.uniform(k_mh, (N,), dtype)))
        for i in range(len(shapes)):
            z[i].append(np.stack(rows[0][i]))
        jit.append(rows[1])
        u_mh.append(np.stack(rows[2]))
    jit = (torch.as_tensor(np.array(jit)) if cfg.adapt_trajectory
           else torch.as_tensor(np.array(jit, np.int64)))
    return ([torch.as_tensor(np.stack(zi)) for zi in z], jit, torch.as_tensor(np.stack(u_mh)),
            torch.as_tensor(np.stack(u_res)))


def particles(form, dtype, seed):
    block = np.random.RandomState(seed).randn(N, 3).astype(dtype)
    if form == "flat":
        return block, lambda b: b
    return block, lambda b: {"a": b[:, :2], "b": b[:, 2]}


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(port, ref, rel):
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def run_both(form, cfg_kw, dtype, seed=0):
    cfg_j, cfg_t = jsmc.SMCConfig(**cfg_kw), tsmc.SMCConfig(**cfg_kw)
    block, split = particles(form, dtype, seed)
    tree = form == "tree"
    key = jax.random.key(seed + 31)
    shapes = [(N, 2), (N,)] if tree else [(N, 3)]
    zs, jit, u_mh, u_res = jax_smc_noise(key, cfg_j, shapes, jnp.dtype(dtype))
    z = {"a": zs[0], "b": zs[1]} if tree else zs[0]
    margins = []
    ref = jsmc.run_smc(key, *model(jnp, tree), lambda k, n: split(jnp.asarray(block)), cfg_j)
    port = tsmc.run_smc(0, *model(torch, tree), lambda k, n: split(torch.as_tensor(block)), cfg_t,
                        _noise={"z": z, "jit": jit, "u_mh": u_mh, "u_res": u_res},
                        _margins=margins)
    return port, ref, margins


def assert_smc_match(port, ref, rel):
    np.testing.assert_array_equal(port.info.resampled.numpy(), np.asarray(ref.info.resampled))
    assert_close(port.particles, ref.particles, rel)
    np.testing.assert_allclose(port.log_weights.numpy(), np.asarray(ref.log_weights), rtol=rel,
                               atol=rel)
    np.testing.assert_allclose(float(port.log_evidence), float(ref.log_evidence), rtol=rel)
    for f in ("betas", "ess_fraction", "accept_prob", "step_size", "trajectory_length"):
        np.testing.assert_allclose(getattr(port.info, f).numpy(),
                                   np.asarray(getattr(ref.info, f)), rtol=rel, atol=rel)


# (form, resample_threshold, adapt_trajectory)
F32_CASES = [
    ("flat", 1.0, False),
    ("flat", 0.5, False),
    ("tree", 0.9, False),
    ("flat", 1.0, True),
    ("tree", 1.0, True),
]


@pytest.mark.parametrize("form,threshold,adapt", F32_CASES,
                         ids=[f"{c[0]}-res{c[1]}-adapt{c[2]}" for c in F32_CASES])
def test_float32_matches_jax(form, threshold, adapt):
    cfg_kw = dict(num_particles=N, num_temps=6, temp_power=2.0, mcmc_steps=3, leapfrog_steps=5,
                  step_size=0.25, resample_threshold=threshold, adapt_trajectory=adapt)
    port, ref, margins = run_both(form, cfg_kw, np.float32)
    assert min(float(m) for m in margins) >= MARGIN
    assert_smc_match(port, ref, 1e-5)
    assert bool(port.info.resampled.any())
    if threshold < 1.0:
        assert not bool(port.info.resampled.all())


# (form, adapt_trajectory)
F64_CASES = [("flat", True), ("tree", False)]


@pytest.mark.parametrize("form,adapt", F64_CASES, ids=[f"{c[0]}-adapt{c[1]}" for c in F64_CASES])
def test_float64_matches_jax(form, adapt):
    cfg_kw = dict(num_particles=N, num_temps=8, temp_power=2.0, mcmc_steps=3, leapfrog_steps=6,
                  step_size=0.3, resample_threshold=0.7, adapt_trajectory=adapt)
    with jax.enable_x64(True):
        port, ref, margins = run_both(form, cfg_kw, np.float64, seed=1)
    assert min(float(m) for m in margins) >= MARGIN
    assert_smc_match(port, ref, 1e-10)


def test_systematic_resample_matches_jax():
    for seed in range(6):
        rng = np.random.RandomState(seed)
        logw = (2.0 * rng.randn(N)).astype(np.float32)
        u = np.float32(rng.rand())
        want = jnp.searchsorted(jnp.cumsum(jax.nn.softmax(jnp.asarray(logw))),
                                (u + jnp.arange(N)) / N)
        got = tsmc._systematic_resample(torch.tensor(u), torch.as_tensor(logw), N)
        assert float(tsmc._resample_margin(torch.tensor(u), torch.as_tensor(logw), N)) >= MARGIN
        np.testing.assert_array_equal(got.numpy(), np.minimum(np.asarray(want), N - 1))


def clamp_case():
    """Log-weights whose float32 cumsum ends below 1, and the largest
    float32 uniform below 1, so that the last comb position lies past the
    cumsum's end."""
    rng = np.random.RandomState(0)
    for _ in range(1000):
        logw = rng.randn(N).astype(np.float32)
        cum = torch.cumsum(torch.softmax(torch.as_tensor(logw), dim=0), dim=0)
        u = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
        last = (torch.tensor(u) + torch.arange(N, dtype=torch.float32)[-1]) / N
        if float(cum[-1]) < float(last):
            return logw, u
    raise AssertionError("no case found")


def test_resample_index_is_clamped_past_the_end_of_the_population():
    logw, u = clamp_case()
    cum = torch.cumsum(torch.softmax(torch.as_tensor(logw), dim=0), dim=0)
    positions = (torch.tensor(u) + torch.arange(N, dtype=torch.float32)) / N
    assert int(torch.searchsorted(cum, positions)[-1]) == N  # the unclamped index
    idx = tsmc._systematic_resample(torch.tensor(u), torch.as_tensor(logw), N)
    assert int(idx.max()) == N - 1
    # as the JAX package resamples: its searchsorted gives N too, and its
    # gather clamps
    parts = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    want_idx = jnp.searchsorted(jnp.cumsum(jax.nn.softmax(jnp.asarray(logw))),
                                (u + jnp.arange(N)) / N)
    assert int(want_idx[-1]) == N
    want = np.asarray(jnp.asarray(parts)[want_idx])
    result = tsmc.SMCResult(particles=torch.as_tensor(parts), log_weights=torch.as_tensor(logw),
                            log_evidence=torch.tensor(0.0), info=None)
    np.testing.assert_array_equal(tsmc.smc_posterior_sample(0, result, _noise=u).numpy(), want)


def test_posterior_sample_matches_jax():
    key = jax.random.key(5)
    rng = np.random.RandomState(2)
    logw = (1.5 * rng.randn(N)).astype(np.float32)
    logw = logw - np.log(np.sum(np.exp(logw)))
    parts = rng.randn(N, 3).astype(np.float32)
    j = jsmc.smc_posterior_sample(key, jsmc.SMCResult(jnp.asarray(parts), jnp.asarray(logw),
                                                      jnp.zeros(()), None))
    u = np.array(jax.random.uniform(key, ()))  # a writable copy
    t = tsmc.smc_posterior_sample(0, tsmc.SMCResult(torch.as_tensor(parts),
                                                    torch.as_tensor(logw), torch.zeros(()),
                                                    None), _noise=u)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the port's own uniform: keyed and repeatable
    res = tsmc.SMCResult(torch.as_tensor(parts), torch.as_tensor(logw), torch.zeros(()), None)
    assert torch.equal(tsmc.smc_posterior_sample(1, res), tsmc.smc_posterior_sample(1, res))


def test_default_noise_and_gaussian_evidence():
    """The port's own noise on the conjugate Gaussian of tests/test_smc.py:
    log Z = -d/2 log(1 + lam) within 0.15 (2048 particles), the posterior
    std within 12%; the same key repeats the run."""
    d, lam = 3, 4.0
    log_prior = lambda t: -0.5 * torch.sum(t ** 2) - 0.5 * d * float(np.log(2 * np.pi))  # noqa
    log_lik = lambda t: -0.5 * lam * torch.sum(t ** 2)  # noqa: E731

    def prior_sample(seed, n):
        return torch.randn(n, d, generator=torch.Generator().manual_seed(seed),
                           dtype=torch.float64)

    cfg = tsmc.SMCConfig(num_particles=2048, num_temps=25, mcmc_steps=5, leapfrog_steps=8,
                         step_size=0.5)
    r = tsmc.run_smc(0, log_prior, log_lik, prior_sample, cfg)
    assert abs(float(r.log_evidence) + 0.5 * d * np.log(1 + lam)) < 0.15
    draws = tsmc.smc_posterior_sample(9, r)
    np.testing.assert_allclose(draws.std(0).numpy(), 1 / np.sqrt(1 + lam), rtol=0.12)
    small = tsmc.SMCConfig(num_particles=64, num_temps=4, mcmc_steps=2, leapfrog_steps=4)
    a = tsmc.run_smc(3, log_prior, log_lik, prior_sample, small)
    b = tsmc.run_smc(3, log_prior, log_lik, prior_sample, small)
    assert torch.equal(a.particles, b.particles)


def test_validation_errors():
    with pytest.raises(ValueError, match="num_particles"):
        tsmc.SMCConfig(num_particles=1)
    with pytest.raises(ValueError, match="num_temps"):
        tsmc.SMCConfig(num_particles=8, num_temps=0)
    with pytest.raises(ValueError, match="mcmc_steps"):
        tsmc.SMCConfig(num_particles=8, mcmc_steps=0)
    with pytest.raises(ValueError, match="leapfrog_steps"):
        tsmc.SMCConfig(num_particles=8, leapfrog_steps=0)
    with pytest.raises(ValueError, match="temp_power"):
        tsmc.SMCConfig(num_particles=8, temp_power=0.0)
    with pytest.raises(ValueError, match="resample_threshold"):
        tsmc.SMCConfig(num_particles=8, resample_threshold=1.5)
    with pytest.raises(ValueError, match="desired_accept_rate"):
        tsmc.SMCConfig(num_particles=8, desired_accept_rate=0.0)
    with pytest.raises(ValueError, match="init_trajectory_length"):
        tsmc.SMCConfig(num_particles=8, init_trajectory_length=0.0)
    with pytest.raises(ValueError, match="adam_lr"):
        tsmc.SMCConfig(num_particles=8, adam_lr=0.0)
    log_prior, log_lik = model(torch)
    with pytest.raises(ValueError, match="num_particles"):
        tsmc.run_smc(0, log_prior, log_lik, lambda k, n: torch.zeros(n + 1, 3),
                     tsmc.SMCConfig(num_particles=8))
