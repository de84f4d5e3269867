"""MCLMC: ``run_mclmc`` / ``run_mclmc_chains`` against the JAX package.

(a) Draw for draw.  The test builds the JAX package's own normals with
    ``jax.random.normal(jax.random.fold_in(k, index), ...)`` in the JAX
    code's namespaces (main steps: the global step index; tuning step i:
    2**31 + i; the initial velocity: 2**32 - 1; ``k`` is the run's key for
    ``run_mclmc`` and chain c's ``split`` key for ``run_mclmc_chains``) and
    hands them to the port through ``_noise``.  Both packages then run the
    same arithmetic, differing only in rounding (sum order, exp, expm1,
    pow) and in the precision of the rotation's scalars (float64 in the
    port, float32 in the JAX code; at d <= 41 that moves dE by ~1e-6).
    Tolerances, after 20 tuning and 10 main steps:
    * tuned (eps, L): rtol 1e-5 (seen: 1e-6);
    * samples and final velocity: rtol 2e-4 / atol 2e-4.  On the Gaussian
      (linear dynamics) they agree to 6e-6, but the BNN's nonlinear
      trajectories amplify the last-bit differences of the two packages'
      autodiff gradients (seen: 1.8e-4 on one element);
    * energy_change (values of order 1): atol 1e-3, since the flagship's
      gradient (norm of order 10) turns a 2e-4 difference of state into
      ~1e-3 of dE (seen: 1.7e-4).
    The tuner feeds log(dE^2) back into eps, which amplifies the rounding
    of dE: hence the short tuning window and a seed step of 2.0.  At the
    default 0.2, dE starts near 1e-5 on these targets, float32 rounding
    noise that differs by a few percent between the packages and moves eps
    by ~1e-3 within 20 steps.  Each comparison also runs the port with the
    potential's gradient scaled by 1.01 and asserts that the samples move
    far beyond the tolerance (25x), so a wrong gradient fails.
(b) Mechanics, after ``tests/test_mclmc.py``: resume is bit-exact, thin,
    tree states, a start at the mode stays finite, divergences are flagged
    not raised, fixed scales are respected, chains start from distinct
    points, and the validation errors.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.models import flagship as jflag
from hamiltorch_tpu.samplers import mclmc as jm
from hamiltorch_tpu_torch import MCLMCConfig, run_mclmc, run_mclmc_chains
from hamiltorch_tpu_torch.models import flagship as tflag
from test_torch_hmc import jax_flagship_data

TUNE, MAIN, SEED_STEP = 20, 10, 2.0
RTOL, ATOL = 2e-4, 2e-4
STDS = np.linspace(0.5, 3.0, 6).astype(np.float32)
TINY = (8, 4, 16)  # in_dim, hidden, n_data


def jax_normals(k, dims, tune_steps, main_steps):
    """The JAX code's normals for one chain key: (init, tune (T, D), main (S, D))."""
    def draw(index):
        return np.array(jax.random.normal(jax.random.fold_in(k, jnp.uint32(index)), (dims,)))
    init = draw(2**32 - 1)
    tune = np.stack([draw(2**31 + i) for i in range(tune_steps)]) if tune_steps else None
    main = np.stack([draw(i) for i in range(main_steps)])
    return init, tune, main


def chains_noise(key, num_chains, dims, tune_steps, main_steps):
    per = [jax_normals(k, dims, tune_steps, main_steps) for k in jax.random.split(key, num_chains)]
    init = torch.as_tensor(np.stack([p[0] for p in per]))
    tune = None if not tune_steps else torch.as_tensor(np.stack([p[1] for p in per], axis=1))
    main = torch.as_tensor(np.stack([p[2] for p in per], axis=1))
    return init, tune, main


def targets(form):
    """(jax lp, jax theta0, port lp, port theta0) on shared data."""
    if form == "gauss":
        theta0 = np.full(6, 0.7, np.float32)
        return (lambda t: -0.5 * jnp.sum((t / STDS) ** 2), jnp.asarray(theta0),
                lambda t: -0.5 * torch.sum((t / torch.as_tensor(STDS)) ** 2),
                torch.as_tensor(theta0))
    x, y, flat0 = jax_flagship_data(*TINY)
    # start away from the prior's mode so that the likelihood gradient matters
    flat0 = (flat0 + 0.3 * np.random.RandomState(0).randn(flat0.size)).astype(np.float32)
    if form == "tiny_flat":
        j_lp, _ = jflag.make_flagship_potential(*TINY)
        t_lp, t_theta0 = tflag.make_flagship_potential(*TINY, x=x, y=y, theta0=flat0, device="cpu")
        return j_lp, jnp.asarray(flat0), t_lp, t_theta0
    j_lp, _ = jflag.make_flagship_potential_tree(*TINY)
    t_lp, t_theta0 = tflag.make_flagship_potential_tree(*TINY, x=x, y=y, theta0=flat0, device="cpu")
    return j_lp, {k: jnp.asarray(v.numpy()) for k, v in t_theta0.items()}, t_lp, t_theta0


def leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def assert_matches(t_res, j_res, chains):
    """The port's result against the JAX package's, at the stated tolerances."""
    for a, b in zip(leaves(jax.tree_util.tree_map(lambda t: t.numpy(), t_res.samples)),
                    leaves(j_res.samples)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_res.final_u.numpy(), np.asarray(j_res.final_u), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_res.stats.energy_change.numpy(),
                               np.asarray(j_res.stats.energy_change), atol=1e-3)
    for name in ("step_size", "trajectory_length"):
        np.testing.assert_allclose(getattr(t_res, name).numpy(), np.asarray(getattr(j_res, name)),
                                   rtol=1e-5)
    np.testing.assert_array_equal(t_res.stats.divergent.numpy(), np.asarray(j_res.stats.divergent))
    assert t_res.final_step.tolist() == ([MAIN] * chains if chains else MAIN)


def assert_sees_gradient(run, good):
    """A potential whose gradient is 1% off moves the samples far beyond the tolerance (>= 25x)."""
    bad = run(1.01)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        jax.tree_util.tree_leaves(good.samples), jax.tree_util.tree_leaves(bad.samples)))
    assert moved > 25 * ATOL, moved


FORMS = ["gauss", "tiny_flat", "tiny_tree"]


@pytest.mark.parametrize("form", FORMS)
def test_run_mclmc_matches_jax_draw_for_draw(form):
    j_lp, j_theta0, t_lp, t_theta0 = targets(form)
    key = jax.random.key(3)
    j_cfg = jm.MCLMCConfig(num_samples=MAIN, tune_steps=TUNE, step_size=SEED_STEP)
    j_res = jm.run_mclmc(key, j_lp, j_theta0, j_cfg)
    dims = int(jax.flatten_util.ravel_pytree(j_theta0)[0].size)
    noise = tuple(torch.as_tensor(z.copy()) for z in jax_normals(key, dims, TUNE, MAIN))
    cfg = MCLMCConfig(num_samples=MAIN, tune_steps=TUNE, step_size=SEED_STEP)

    def run(scale):
        return run_mclmc(0, lambda t: scale * t_lp(t), t_theta0, cfg, _noise=noise)

    t_res = run(1.0)
    assert_matches(t_res, j_res, None)
    assert_sees_gradient(run, t_res)


@pytest.mark.parametrize("form", FORMS)
def test_run_mclmc_chains_matches_jax_draw_for_draw(form):
    j_lp, j_theta0, t_lp, t_theta0 = targets(form)
    key, chains = jax.random.key(4), 3
    j_cfg = jm.MCLMCConfig(num_samples=MAIN, tune_steps=TUNE, step_size=SEED_STEP)
    j_res = jm.run_mclmc_chains(key, j_lp, j_theta0, j_cfg, num_chains=chains)
    dims = int(jax.flatten_util.ravel_pytree(j_theta0)[0].size)
    noise = chains_noise(key, chains, dims, TUNE, MAIN)
    cfg = MCLMCConfig(num_samples=MAIN, tune_steps=TUNE, step_size=SEED_STEP)

    def run(scale):
        return run_mclmc_chains(0, lambda t: scale * t_lp(t), t_theta0, cfg, chains, _noise=noise)

    t_res = run(1.0)
    assert_matches(t_res, j_res, chains)
    assert_sees_gradient(run, t_res)


def iso_lp(t):
    return -0.5 * torch.sum(t**2)


def test_resume_bit_exact():
    """Tune once, sample in two chunks at the frozen (eps, L) == one run."""
    t0 = torch.full((8,), 0.5)
    full = run_mclmc(0, iso_lp, t0, MCLMCConfig(num_samples=200, tune_steps=300))
    c1 = run_mclmc(0, iso_lp, t0, MCLMCConfig(num_samples=100, tune_steps=300))
    c2 = run_mclmc(
        0, iso_lp, c1.final_theta,
        MCLMCConfig(num_samples=100, tune_steps=0, step_size=float(c1.step_size),
                    trajectory_length=float(c1.trajectory_length)),
        init_u=c1.final_u, start_step=int(c1.final_step),
    )
    assert torch.equal(torch.cat([c1.samples, c2.samples]), full.samples)
    assert torch.equal(c1.step_size, full.step_size)
    assert torch.equal(c1.trajectory_length, full.trajectory_length)
    assert torch.equal(c2.final_u, full.final_u)


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_chains_resume_bit_exact(form):
    """resume_from continues every chain at its OWN tuned (eps, L)."""
    if form == "flat":
        t0, lp = torch.full((6,), 0.5), iso_lp
    else:
        t0 = {"a": torch.zeros(3), "b": torch.ones(())}
        lp = lambda t: -0.5 * (torch.sum(t["a"] ** 2) + t["b"] ** 2)  # noqa: E731
    full = run_mclmc_chains(0, lp, t0, MCLMCConfig(num_samples=80, tune_steps=100), 3)
    c1 = run_mclmc_chains(0, lp, t0, MCLMCConfig(num_samples=40, tune_steps=100), 3)
    c2 = run_mclmc_chains(0, lp, None, MCLMCConfig(num_samples=40, tune_steps=0), 3,
                          resume_from=c1)
    if form == "flat":
        glued, want = torch.cat([c1.samples, c2.samples], dim=1), full.samples
    else:
        glued, want = torch.cat([c1.samples["a"], c2.samples["a"]], dim=1), full.samples["a"]
    assert torch.equal(glued, want)
    assert torch.equal(c2.step_size, full.step_size)
    assert c2.final_step.tolist() == [80, 80, 80]


def test_resume_requires_frozen_config():
    c1 = run_mclmc_chains(0, iso_lp, torch.full((4,), 0.5),
                          MCLMCConfig(num_samples=20, tune_steps=30), 2)
    with pytest.raises(ValueError, match="tune_steps=0"):
        run_mclmc_chains(0, iso_lp, None, MCLMCConfig(num_samples=20, tune_steps=10), 2,
                         resume_from=c1)


def test_thin():
    """thin=k keeps every k-th state of the identical trajectory."""
    t0 = torch.full((8,), 0.5)
    full = run_mclmc(0, iso_lp, t0, MCLMCConfig(num_samples=200, tune_steps=300))
    thinned = run_mclmc(0, iso_lp, t0, MCLMCConfig(num_samples=200, tune_steps=300, thin=2))
    assert thinned.samples.shape == (100, 8)
    assert torch.equal(thinned.samples, full.samples[1::2])


def test_tree_state():
    """Tree thetas ravel at the boundary; samples keep leaf shapes."""
    tree0 = {"w": torch.ones(3, 2) * 0.2, "b": torch.zeros(4)}

    def lp(t):
        return -0.5 * (torch.sum(t["w"] ** 2) + torch.sum((t["b"] - 1.0) ** 2))

    r = run_mclmc(0, lp, tree0, MCLMCConfig(num_samples=400, tune_steps=400))
    assert r.samples["w"].shape == (400, 3, 2)
    assert r.samples["b"].shape == (400, 4)
    np.testing.assert_allclose(r.samples["b"].numpy().mean(0), 1.0, atol=0.35)
    assert r.final_theta["w"].shape == (3, 2)


def test_tree_chains():
    tree0 = {"a": torch.zeros(3), "b": torch.zeros(())}

    def lp(t):
        return -0.5 * (torch.sum(t["a"] ** 2) + t["b"] ** 2)

    r = run_mclmc_chains(0, lp, tree0, MCLMCConfig(num_samples=50, tune_steps=100), 4)
    assert r.samples["a"].shape == (4, 50, 3)
    assert r.samples["b"].shape == (4, 50)
    assert r.step_size.shape == (4,)


def test_mode_start_is_finite():
    """A chain seeded exactly at the mode sees a zero gradient on its first
    velocity update: the guarded 0/0 must give the identity rotation."""
    r = run_mclmc(0, iso_lp, torch.zeros(8), MCLMCConfig(num_samples=200, tune_steps=200))
    assert bool(torch.all(torch.isfinite(r.samples)))
    assert float(torch.std(r.samples)) > 0.3


def test_divergence_flagged_not_raised():
    """Non-finite proposals are skipped (state held) and flagged."""

    def sharp(t):
        return -0.5 * torch.sum((t * 100.0) ** 2) - torch.sum(t**4)

    r = run_mclmc(0, sharp, torch.full((4,), 3.0),
                  MCLMCConfig(num_samples=50, tune_steps=0, step_size=1e6, trajectory_length=1.0))
    assert bool(torch.all(torch.isfinite(r.samples)))
    assert bool(r.stats.divergent.any())


def test_fixed_scales_respected():
    r = run_mclmc(0, iso_lp, torch.ones(4),
                  MCLMCConfig(num_samples=20, tune_steps=0, step_size=0.37, trajectory_length=2.5))
    assert float(r.step_size) == pytest.approx(0.37)
    assert float(r.trajectory_length) == pytest.approx(2.5)


def test_chains_distinct_starts():
    t0 = torch.stack([torch.full((6,), -1.0), torch.full((6,), 1.0)])
    r = run_mclmc_chains(0, iso_lp, t0, MCLMCConfig(num_samples=40, tune_steps=50), 2)
    assert r.samples.shape == (2, 40, 6)
    assert not torch.equal(r.samples[0], r.samples[1])


def test_bad_config():
    with pytest.raises(ValueError, match="num_samples"):
        MCLMCConfig(num_samples=0)
    with pytest.raises(ValueError, match="step_size"):
        MCLMCConfig(num_samples=10, step_size=0.0)
    with pytest.raises(ValueError, match="integrator"):
        MCLMCConfig(num_samples=10, integrator="verlet")
    with pytest.raises(ValueError, match="divisible"):
        MCLMCConfig(num_samples=10, thin=3)
    with pytest.raises(ValueError, match="trajectory_length"):
        MCLMCConfig(num_samples=10, trajectory_length=-1.0)
    with pytest.raises(ValueError, match="tune_steps"):
        MCLMCConfig(num_samples=10, tune_steps=-1)
    with pytest.raises(ValueError, match="desired_energy_var"):
        MCLMCConfig(num_samples=10, desired_energy_var=0.0)


@pytest.mark.parametrize("bad", ["dim", "matrix", "pass_grad"])
def test_bad_inputs(bad):
    cfg = MCLMCConfig(num_samples=10)
    with pytest.raises(ValueError, match={"dim": "dimension >= 2", "matrix": "1-d",
                                          "pass_grad": "pass_grad"}[bad]):
        if bad == "dim":
            run_mclmc(0, iso_lp, torch.zeros(1), cfg)
        elif bad == "matrix":
            run_mclmc(0, iso_lp, torch.zeros(2, 3), cfg)
        else:
            run_mclmc(0, lambda t: -torch.sum(t["a"] ** 2), {"a": torch.zeros(3)}, cfg,
                      pass_grad=lambda t: t)


def test_leapfrog_integrator_and_data_argument():
    """The one-gradient integrator runs, and ``data=`` reaches the potential."""
    scale = torch.tensor(2.0)
    r = run_mclmc(0, lambda t, s: -0.5 * torch.sum((t / s) ** 2), torch.ones(5),
                  MCLMCConfig(num_samples=300, tune_steps=300, integrator="leapfrog"), data=scale)
    assert bool(torch.all(torch.isfinite(r.samples)))
    assert 1.0 < float(r.samples[100:].std()) < 3.0
