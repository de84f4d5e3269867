"""Port vs JAX package: Stan's windowed mass warmup (``samplers/warmup.py``)
and the ``adapt_mass`` branch of the HMC runners.

* The Welford updates and Chan's batch merges, diagonal and dense, and the
  regularised estimates agree with the JAX functions within 1e-6 on numpy
  data; the schedule's flags are identical.
* ``run_hmc`` / ``run_hmc_chains`` with ``adapt_mass`` in {True, "diag",
  "dense"} on a flat correlated 4-D Gaussian, and diagonal on a tree, run
  on the JAX driver's own noise (``test_torch_hmc.jax_driver_noise``) at
  a fixed step size: identical accept decisions; samples within 1e-5 and
  every part of ``final_warm`` (Welford count, mean and m2, the metric,
  the DA counter) within rtol 1e-4.
* With step-size adaptation as well, dual averaging doubles a rounding
  difference in the step size about every draw while it climbs (gamma =
  0.05), so float32 runs part after ~30 draws whatever the code does.
  That case runs both packages' internal runners (``_run_hmc_jit`` and
  ``_run_hmc_batched``) in float64 on a 32-draw schedule with two short
  slow windows passed as flags: samples within 1e-5, step sizes within
  rtol 1e-6 and ``final_warm`` within 1e-8 (measured: <= 1.2e-7, 5e-9,
  3e-10).
* Within the port, a run cut into two chunks (``init_state``, ``init_da``,
  ``start_iter``, ``init_warm`` and the chunk's slice of the schedule)
  continues the warmup carry bit for bit.
* The ``validate_adapt_mass`` and tree-state errors match the JAX
  package's types and messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.samplers.hmc as jhmc
import hamiltorch_tpu.samplers.warmup as jwarm
import hamiltorch_tpu_torch as tht
import hamiltorch_tpu_torch.samplers.warmup as twarm
from hamiltorch_tpu_torch.ops.mass import make_diag_mass_tree, make_mass
from hamiltorch_tpu_torch.samplers.hmc import _run_hmc_batched
from hamiltorch_tpu_torch.utils.pytree import tree_leaves
from test_torch_hmc import jax_driver_noise

RNG = np.random.default_rng(3)
XS = RNG.standard_normal((40, 6)).astype(np.float32) * np.array([0.5, 1, 2, 3, 1, 0.1], np.float32)

_A = np.random.default_rng(1).standard_normal((4, 4))
COV = (_A @ _A.T / 4 + 0.3 * np.eye(4)).astype(np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
BURN = 160  # one slow window: [75, 110)
SAMPLES = 170
CHAINS = 3


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def test_welford_update_and_variance_match_jax():
    j, t = jwarm.welford_init(6), twarm.welford_init(6)
    for x in XS:
        j = jwarm.welford_update(j, jnp.asarray(x))
        t = twarm.welford_update(t, torch.as_tensor(x))
    for a, b in zip(t, j):
        close(a, b, rtol=1e-6, atol=1e-6)
    close(twarm.welford_variance(t), jwarm.welford_variance(j), rtol=1e-6)


def test_welford_cov_update_and_covariance_match_jax():
    j, t = jwarm.welford_cov_init(6), twarm.welford_cov_init(6)
    for x in XS:
        j = jwarm.welford_cov_update(j, jnp.asarray(x))
        t = twarm.welford_cov_update(t, torch.as_tensor(x))
    for a, b in zip(t, j):
        close(a, b, rtol=1e-6, atol=1e-6)
    close(twarm.welford_covariance(t), jwarm.welford_covariance(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_chan_batch_merge_matches_jax_and_the_sequential_update(dense):
    init, merge, update = (("welford_cov_init", "welford_cov_merge_batch", "welford_cov_update")
                           if dense else ("welford_init", "welford_merge_batch", "welford_update"))
    j = getattr(jwarm, init)(6)
    t = getattr(twarm, init)(6)
    seq = getattr(twarm, init)(6)
    for batch in (XS[:7], XS[7:25], XS[25:]):
        j = getattr(jwarm, merge)(j, jnp.asarray(batch))
        t = getattr(twarm, merge)(t, torch.as_tensor(batch))
        for x in batch:
            seq = getattr(twarm, update)(seq, torch.as_tensor(x))
    for a, b, c in zip(t, j, seq):
        close(a, b, rtol=1e-6, atol=1e-6)
        close(a, c, rtol=1e-5, atol=1e-5)
    # the sharded form: gsum over the batch axis and the global count
    t2 = getattr(twarm, merge)(getattr(twarm, init)(6), torch.as_tensor(XS),
                               gsum=lambda x: torch.sum(x, dim=0), count=len(XS))
    j2 = getattr(jwarm, merge)(getattr(jwarm, init)(6), jnp.asarray(XS))
    for a, b in zip(t2, j2):
        close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("burn", [0, 100, 149, 150, 300, 1000])
def test_schedule_matches_jax(burn):
    for a, b in zip(twarm.build_schedule(burn), jwarm.build_schedule(burn)):
        np.testing.assert_array_equal(a, b)
    for start, length in ((0, burn + 10), (burn // 3, 57), (burn, 5)):
        for a, b in zip(twarm.schedule_flags(burn, start, length),
                        jwarm.schedule_flags(burn, start, length)):
            np.testing.assert_array_equal(a, np.asarray(b))


def flat_target():
    jp, tp = jnp.asarray(PREC), torch.as_tensor(PREC)
    return lambda t: -0.5 * t @ jp @ t, lambda t: -0.5 * t @ tp @ t


def tree_target():
    scale = {"a": np.array([0.5, 2.0], np.float32), "b": np.array([[1.0, 3.0], [0.7, 1.5]], np.float32)}

    def j_lp(t):
        return -0.5 * sum(jnp.sum((t[k] / scale[k]) ** 2) for k in scale)

    def t_lp(t):
        return -0.5 * sum(torch.sum((t[k] / torch.as_tensor(scale[k])) ** 2) for k in scale)

    theta0 = {"a": np.full(2, 0.5, np.float32), "b": np.full((2, 2), -0.5, np.float32)}
    return j_lp, t_lp, theta0


def compare_warm(t_warm, j_warm, rtol, atol):
    t_leaves = tree_leaves(t_warm)
    j_leaves = jax.tree_util.tree_leaves(j_warm)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        close(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode,form", [(True, "flat"), ("diag", "flat"), ("dense", "flat"),
                                       ("diag", "tree")])
def test_run_hmc_chains_windowed_matches_jax(mode, form):
    if form == "flat":
        j_lp, t_lp = flat_target()
        j_theta0, t_theta0, dim = jnp.full(4, 0.5), torch.full((4,), 0.5), 4
    else:
        j_lp, t_lp, theta0 = tree_target()
        j_theta0 = jax.tree_util.tree_map(jnp.asarray, theta0)
        t_theta0 = {k: torch.as_tensor(v) for k, v in theta0.items()}
        dim = 6
    cfg = dict(num_samples=SAMPLES, num_steps_per_sample=4, step_size=0.35, burn=BURN,
               adapt_mass=mode)
    key = jax.random.key(21)
    j_res = jht.run_hmc_chains(key, j_lp, j_theta0, jht.MCMCConfig(**cfg), CHAINS)
    t_res = tht.run_hmc_chains(0, t_lp, t_theta0, tht.MCMCConfig(**cfg), CHAINS,
                               _noise=jax_driver_noise(key, CHAINS, SAMPLES, dim))
    acc = np.asarray(j_res.stats.accepted)
    assert 0 < acc.mean() < 1
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), acc)
    for a, b in zip(tree_leaves(t_res.samples), jax.tree_util.tree_leaves(j_res.samples)):
        close(a, b, atol=1e-5)
    compare_warm(t_res.final_warm, j_res.final_warm, rtol=1e-4, atol=1e-5)
    # the adapted metric is not the identity it started from
    metric = t_res.final_warm[1][0] if mode == "dense" else t_res.final_warm[1]
    assert not torch.allclose(metric, torch.ones_like(metric))


def noise64(key, num_chains, num_samples, dim):
    """jax_driver_noise in float64 (the JAX driver draws in the state's dtype)."""

    def one(k, n):
        k_prop, k_mh = jax.random.split(jax.random.fold_in(k, n))
        return (jax.random.normal(k_prop, (dim,), jnp.float64),
                jnp.log(jax.random.uniform(k_mh, (), jnp.float64)))

    keys = jax.random.split(key, num_chains)
    z, log_u = jax.vmap(lambda k: jax.vmap(lambda n: one(k, n))(jnp.arange(num_samples)))(keys)
    return (torch.as_tensor(np.asarray(z).transpose(1, 0, 2).copy()),
            torch.as_tensor(np.asarray(log_u).T.copy()))


@pytest.mark.parametrize("mode,form", [(True, "flat"), ("dense", "flat"), ("diag", "tree")])
def test_windowed_step_size_adaptation_matches_jax_in_float64(mode, form):
    import hamiltorch_tpu.ops.mass as jmass

    from hamiltorch_tpu_torch.ops.mass import make_mass_tree

    draws, burn = 32, 26
    collect, end = np.zeros(draws, bool), np.zeros(draws, bool)
    collect[4:20], end[[9, 19]] = True, True
    cfg = dict(num_samples=draws, num_steps_per_sample=4, step_size=0.35, burn=burn,
               adapt_mass=mode, adapt_step_size=True)
    prec = PREC.astype(np.float64)
    scale = {"a": np.array([0.5, 2.0]), "b": np.array([[1.0, 3.0], [0.7, 1.5]])}
    with jax.enable_x64(True):
        key = jax.random.key(21)
        if form == "flat":
            jp, dim = jnp.asarray(prec), 4
            j_lp = lambda t: -0.5 * t @ jp @ t  # noqa: E731
            j_theta0, j_mass = jnp.full((CHAINS, 4), 0.5, jnp.float64), jmass.make_mass(None, 4)
        else:
            dim = 6
            j_lp = lambda t: -0.5 * sum(jnp.sum((t[k] / scale[k]) ** 2) for k in scale)  # noqa: E731
            template = {"a": jnp.full(2, 0.5), "b": jnp.full((2, 2), -0.5)}
            j_theta0 = {k: jnp.broadcast_to(v, (CHAINS,) + v.shape) for k, v in template.items()}
            j_mass = jmass.make_mass_tree(None, template)
        j_cfg = jht.MCMCConfig(**cfg)
        j_res = jax.vmap(lambda k, t: jhmc._run_hmc_jit(
            k, t, j_lp, j_cfg, j_mass, collect_flags=jnp.asarray(collect),
            end_flags=jnp.asarray(end)))(jax.random.split(key, CHAINS), j_theta0)
        noise = noise64(key, CHAINS, draws, dim)
        j_res = jax.tree_util.tree_map(np.asarray, j_res)
    if form == "flat":
        tp = torch.as_tensor(prec)
        t_lp = lambda t: -0.5 * t @ tp @ t  # noqa: E731
        t_theta0, t_mass = torch.full((CHAINS, 4), 0.5, dtype=torch.float64), make_mass(None, 4)
    else:
        t_lp = lambda t: -0.5 * sum(  # noqa: E731
            torch.sum((t[k] / torch.as_tensor(scale[k])) ** 2) for k in scale)
        t_theta0 = {k: torch.as_tensor(np.asarray(v)).clone() for k, v in j_theta0.items()}
        t_mass = make_mass_tree(None, {k: v[0] for k, v in t_theta0.items()})
    t_res = _run_hmc_batched(0, t_theta0, t_lp, tht.MCMCConfig(**cfg), t_mass,
                             collect_flags=collect, end_flags=end, _noise=noise)
    assert t_res.stats.step_size.dtype == torch.float64
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), j_res.stats.accepted)
    assert 0 < j_res.stats.accepted.mean() < 1
    for a, b in zip(tree_leaves(t_res.samples), jax.tree_util.tree_leaves(j_res.samples)):
        close(a, b, atol=1e-5)
    close(t_res.stats.step_size, j_res.stats.step_size, rtol=1e-6)
    compare_warm(t_res.final_warm, j_res.final_warm, rtol=0, atol=1e-8)


@pytest.mark.parametrize("mode", ["diag", "dense"])
def test_run_hmc_single_chain_windowed_matches_jax(mode):
    """run_hmc draws with the chain's key itself; final_warm has no chain axis."""
    j_lp, t_lp = flat_target()
    cfg = dict(num_samples=SAMPLES, num_steps_per_sample=4, step_size=0.35, burn=BURN,
               adapt_mass=mode)
    key = jax.random.key(4)
    j_res = jht.run_hmc(key, j_lp, jnp.full(4, 0.5), jht.MCMCConfig(**cfg))
    ks = [jax.random.split(jax.random.fold_in(key, n)) for n in range(SAMPLES)]
    z = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k[0], (4,))) for k in ks]))
    log_u = torch.as_tensor(np.stack([np.log(np.asarray(jax.random.uniform(k[1], ())))
                                      for k in ks]))
    t_res = tht.run_hmc(0, t_lp, torch.full((4,), 0.5), tht.MCMCConfig(**cfg), _noise=(z, log_u))
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    close(t_res.samples, j_res.samples, atol=1e-5)
    compare_warm(t_res.final_warm, j_res.final_warm, rtol=1e-4, atol=1e-5)
    assert t_res.final_warm[0].count.shape == ()


@pytest.mark.parametrize("mode", ["diag", "dense"])
def test_chunked_warmup_continues_exactly(mode):
    """Two chunks through a window end equal the straight run bit for bit,
    the second starting from the first's state, DA, warmup carry and its
    slice of the global schedule (as the JAX checkpointer drives it)."""
    _, t_lp = flat_target()
    cfg = lambda n: tht.MCMCConfig(num_samples=n, num_steps_per_sample=3, step_size=0.3,  # noqa: E731
                                   burn=BURN, adapt_mass=mode, adapt_step_size=True)
    theta0 = torch.full((2, 4), 0.5)
    mass = make_mass(None, 4)
    whole = _run_hmc_batched(6, theta0, t_lp, cfg(SAMPLES), mass)
    first = _run_hmc_batched(6, theta0, t_lp, cfg(100), mass,
                             collect_flags=twarm.schedule_flags(BURN, 0, 100)[0],
                             end_flags=twarm.schedule_flags(BURN, 0, 100)[1])
    flags = twarm.schedule_flags(BURN, 100, SAMPLES - 100)
    second = _run_hmc_batched(6, theta0, t_lp, cfg(SAMPLES - 100), mass,
                              init_state=first.final_state, init_da=first.final_da,
                              start_iter=100, init_warm=first.final_warm,
                              collect_flags=flags[0], end_flags=flags[1])
    assert torch.equal(torch.cat([first.samples, second.samples], dim=1), whole.samples)
    assert torch.equal(second.final_step_size, whole.final_step_size)
    for a, b in zip(tree_leaves(second.final_warm), tree_leaves(whole.final_warm)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["diag", "dense"])
def test_chunk_without_flags_takes_its_slice_of_the_schedule(mode):
    """A chunk from start_iter > 0 given no flags runs the draws' slice of
    the global schedule, not the first chunk's."""
    _, t_lp = flat_target()
    cfg = lambda n: tht.MCMCConfig(num_samples=n, num_steps_per_sample=3, step_size=0.3,  # noqa: E731
                                   burn=BURN, adapt_mass=mode, adapt_step_size=True)
    theta0 = torch.full((2, 4), 0.5)
    mass = make_mass(None, 4)
    whole = _run_hmc_batched(6, theta0, t_lp, cfg(SAMPLES), mass)
    first = _run_hmc_batched(6, theta0, t_lp, cfg(100), mass)
    second = _run_hmc_batched(6, theta0, t_lp, cfg(SAMPLES - 100), mass,
                              init_state=first.final_state, init_da=first.final_da,
                              start_iter=100, init_warm=first.final_warm)
    assert torch.equal(torch.cat([first.samples, second.samples], dim=1), whole.samples)
    for a, b in zip(tree_leaves(second.final_warm), tree_leaves(whole.final_warm)):
        assert torch.equal(a, b)


def test_tree_and_diag_tree_mass_reject_dense_warmup_alike():
    template = {"a": torch.zeros(2), "b": torch.zeros(3)}
    with pytest.raises(ValueError) as by_driver:
        tht.run_hmc(0, lambda t: -t["a"].sum() - t["b"].sum(), template,
                    tht.MCMCConfig(num_samples=2, burn=1, adapt_mass="dense"))
    with pytest.raises(ValueError) as by_mass:
        make_diag_mass_tree(None, template, "HMC", dense_requested=True)
    assert str(by_driver.value) == str(by_mass.value)


def test_adapt_mass_without_burn_is_plain_hmc():
    _, t_lp = flat_target()
    cfg = dict(num_samples=12, num_steps_per_sample=3, step_size=0.3)
    plain = tht.run_hmc_chains(2, t_lp, torch.zeros(4), tht.MCMCConfig(**cfg), 2)
    warm = tht.run_hmc_chains(2, t_lp, torch.zeros(4), tht.MCMCConfig(adapt_mass=True, **cfg), 2)
    assert torch.equal(plain.samples, warm.samples) and warm.final_warm is None


def errors(fn):
    with pytest.raises(Exception) as err:
        fn()
    return err.type, str(err.value)


@pytest.mark.parametrize("case", ["dense_tree", "diag_with_dense", "diag_with_blocks",
                                  "dense_with_blocks", "bad_mode"])
def test_adapt_mass_errors_match_jax(case):
    eye4 = np.eye(4, dtype=np.float32)
    blocks = [np.eye(2, dtype=np.float32), 2 * np.eye(2, dtype=np.float32)]
    tree = {"a": np.zeros(2, np.float32), "b": np.zeros(2, np.float32)}
    mode, inv_mass, theta = {
        "dense_tree": ("dense", None, tree),
        "diag_with_dense": ("diag", eye4, np.zeros(4, np.float32)),
        "diag_with_blocks": (True, blocks, np.zeros(4, np.float32)),
        "dense_with_blocks": ("dense", blocks, np.zeros(4, np.float32)),
        "bad_mode": ("full", None, np.zeros(4, np.float32)),
    }[case]

    def jax_run():
        if case == "bad_mode":
            return jwarm.validate_adapt_mass(mode, None)
        th = jax.tree_util.tree_map(jnp.asarray, theta)
        return jht.run_hmc(jax.random.key(0), lambda t: 0.0, th,
                           jht.MCMCConfig(num_samples=4, burn=2, adapt_mass=mode),
                           inv_mass=inv_mass)

    def torch_run():
        if case == "bad_mode":
            return twarm.validate_adapt_mass(mode, None)
        th = {k: torch.as_tensor(v) for k, v in theta.items()} if isinstance(theta, dict) \
            else torch.as_tensor(theta)
        return tht.run_hmc(0, lambda t: torch.zeros(()), th,
                           tht.MCMCConfig(num_samples=4, burn=2, adapt_mass=mode),
                           inv_mass=inv_mass)

    assert errors(torch_run) == errors(jax_run)
    if case == "bad_mode":
        assert errors(lambda: tht.MCMCConfig(num_samples=4, adapt_mass=mode))[0] is ValueError
    else:  # run_hmc_chains checks the same
        th = {k: torch.as_tensor(v) for k, v in theta.items()} if isinstance(theta, dict) \
            else torch.as_tensor(theta)
        chains = errors(lambda: tht.run_hmc_chains(
            0, lambda t: torch.zeros(()), th,
            tht.MCMCConfig(num_samples=4, burn=2, adapt_mass=mode), 2, inv_mass=inv_mass))
        assert chains == errors(jax_run)


def test_sample_passes_adapt_mass_to_run_hmc():
    """sample(adapt_mass=...) is run_hmc with the windowed warmup, as in the
    JAX façade: the kept draws are run_hmc's after burn, bit for bit."""
    _, t_lp = flat_target()
    kw = dict(num_samples=200, num_steps_per_sample=3, step_size=0.3, burn=160)
    got = tht.sample(t_lp, torch.zeros(4), sampler=tht.Sampler.HMC_NUTS, adapt_mass="diag",
                     key=8, verbose=False, **kw)
    res = tht.run_hmc(8, t_lp, torch.zeros(4), tht.MCMCConfig(
        adapt_step_size=True, adapt_mass="diag", **kw))
    assert torch.equal(got[1:], res.samples[161:])
    plain = tht.sample(t_lp, torch.zeros(4), sampler=tht.Sampler.HMC_NUTS, key=8,
                       verbose=False, **kw)
    assert not torch.equal(got, plain)
