"""Port vs JAX package: elliptical slice sampling (``samplers/elliptical.py``).

The port runs on the JAX sampler's own randomness, replayed: draw g splits
``fold_in(key, g)`` three ways into the prior normal, the slice-level
uniform and the angle key k_t, whose ``uniform`` is the first angle and
whose ``fold_in(k_t, n + 1)`` gives shrink iteration n's; the chains runner
gives chain c the key ``split(key, C)[c]``.  The port takes the unit draws
(``jax.random.uniform``'s own [0, 1) floats) in ``_noise={"nu", "u", "t0",
"t_shrink"}`` and scales them as ``jax.random.uniform`` does.

* Float64 (``jax.enable_x64``): positions within 1e-10, identical shrink
  counts and divergence flags, log-likelihoods (float32 in both packages)
  within 1e-6 relative; every slice test at least 1e-4 from its other
  outcome (the ``_margins`` hook) so that float32 rounding of the
  likelihood cannot flip it.
* Float32: positions within 1e-5 relative, the same decisions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import elliptical as je
from hamiltorch_tpu_torch.samplers import elliptical as te

MARGIN = 1e-4


def lik(xp, shift=1.0, sd=0.5):
    total = jnp.sum if xp is jnp else torch.sum
    return lambda t: -0.5 * total(((t - shift) / sd) ** 2)


def jax_noise(key, draws, d, max_shrink, dtype, chains=None):
    """The JAX runner's draws in the port's ``_noise`` layout."""
    def one(k):
        def draw(g):
            k_nu, k_u, k_t = jax.random.split(jax.random.fold_in(k, g), 3)
            shrink = jax.vmap(lambda n: jax.random.uniform(jax.random.fold_in(k_t, n + 1), (),
                                                           jnp.float32))
            return (jax.random.normal(k_nu, (d,), dtype), jax.random.uniform(k_u, (), jnp.float32),
                    jax.random.uniform(k_t, (), jnp.float32), shrink(jnp.arange(max_shrink)))
        return jax.vmap(draw)(jnp.arange(draws))

    out = one(key) if chains is None else [
        jnp.swapaxes(a, 0, 1) for a in jax.vmap(one)(jax.random.split(key, chains))]
    return dict(zip(("nu", "u", "t0", "t_shrink"), (torch.as_tensor(np.array(a)) for a in out)))


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def assert_close(port, ref, rel):
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def assert_elliptical_match(port, ref, margins, rel):
    assert min(float(m) for m in margins) >= MARGIN
    np.testing.assert_array_equal(port.stats.shrinks.numpy(), np.asarray(ref.stats.shrinks))
    np.testing.assert_array_equal(port.stats.divergent.numpy(), np.asarray(ref.stats.divergent))
    assert_close(port.samples, ref.samples, rel)
    assert_close(port.final_theta, ref.final_theta, rel)
    assert_close(port.stats.loglik, ref.stats.loglik, max(rel, 1e-6))
    assert_close(port.final_loglik, ref.final_loglik, max(rel, 1e-6))
    np.testing.assert_array_equal(port.final_step.numpy(), np.asarray(ref.final_step))


def prior_form(form, d, dtype):
    """(prior_scale, prior_mean) of each form, numpy."""
    rng = np.random.RandomState(d)
    if form == "scalar":
        return 1.0, None
    if form == "diag-mean":
        return np.linspace(0.5, 2.0, d).astype(dtype), rng.randn(d).astype(dtype)
    a = rng.randn(d, d)
    return np.linalg.cholesky(a @ a.T / d + np.eye(d)).astype(dtype), None


# (name, dtype, prior form, config kwargs, chains, seed)
CASES = [
    ("f64-scalar", np.float64, "scalar", dict(num_samples=60), None, 1),
    ("f64-diag-mean-thin", np.float64, "diag-mean", dict(num_samples=60, thin=3), None, 2),
    ("f64-cholesky", np.float64, "cholesky", dict(num_samples=50), None, 3),
    ("f64-chains", np.float64, "diag-mean", dict(num_samples=40, thin=2), 4, 4),
    ("f64-chains-cholesky", np.float64, "cholesky", dict(num_samples=30), 3, 5),
    ("f32-scalar", np.float32, "scalar", dict(num_samples=60), None, 6),
    ("f32-chains", np.float32, "diag-mean", dict(num_samples=40), 4, 7),
]


@pytest.mark.parametrize("name,dtype,form,cfg_kw,chains,seed", CASES, ids=[c[0] for c in CASES])
def test_elliptical_matches_jax(name, dtype, form, cfg_kw, chains, seed):
    d = 4
    scale, mean = prior_form(form, d, dtype)
    cfg_j, cfg_t = je.EllipticalConfig(**cfg_kw), te.EllipticalConfig(**cfg_kw)
    start = np.random.RandomState(seed).randn(d).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.key(seed)
        kw = dict(prior_scale=jnp.asarray(scale),
                  prior_mean=None if mean is None else jnp.asarray(mean))
        if chains is None:
            ref = je.run_elliptical(key, lik(jnp), jnp.asarray(start), cfg_j, **kw)
        else:
            ref = je.run_elliptical_chains(key, lik(jnp), jnp.asarray(start), cfg_j, chains, **kw)
        noise = jax_noise(key, cfg_kw["num_samples"], d, cfg_j.max_shrink, jnp.dtype(dtype),
                          chains)
    kw = dict(prior_scale=torch.as_tensor(scale),
              prior_mean=None if mean is None else torch.as_tensor(mean))
    margins = []
    if chains is None:
        port = te.run_elliptical(0, lik(torch), torch.as_tensor(start), cfg_t, **kw,
                                 _noise=noise, _margins=margins)
    else:
        port = te.run_elliptical_chains(0, lik(torch), torch.as_tensor(start), cfg_t, chains, **kw,
                                        _noise=noise, _margins=margins)
    assert_elliptical_match(port, ref, margins, 1e-10 if dtype == np.float64 else 1e-5)
    assert int(port.stats.shrinks.max()) >= 2  # the shrink loop was exercised


def test_tree_state_with_per_leaf_scales_matches_jax():
    def ll(xp):
        total = jnp.sum if xp is jnp else torch.sum
        return lambda t: -0.5 * (total((t["a"] - 1.0) ** 2) + (t["b"] + 1.0) ** 2)

    scale = {"a": 1.0, "b": 3.0}
    cfg_kw = dict(num_samples=50)
    with jax.enable_x64(True):
        key = jax.random.key(8)
        ref = je.run_elliptical(key, ll(jnp), {"a": jnp.zeros(2), "b": jnp.zeros(())},
                                je.EllipticalConfig(**cfg_kw), prior_scale=scale,
                                prior_mean={"a": 0.5, "b": -0.5})
        noise = jax_noise(key, 50, 3, 64, jnp.float64)
    margins = []
    port = te.run_elliptical(0, ll(torch), {"a": torch.zeros(2, dtype=torch.float64),
                                            "b": torch.zeros((), dtype=torch.float64)},
                             te.EllipticalConfig(**cfg_kw), prior_scale=scale,
                             prior_mean={"a": 0.5, "b": -0.5}, _noise=noise, _margins=margins)
    assert port.samples["a"].shape == (50, 2) and port.samples["b"].shape == (50,)
    assert_elliptical_match(port, ref, margins, 1e-10)


def test_support_and_shrink_cap_match_jax():
    # -inf and NaN outside a hard support shrink away, never divergent
    def support(xp):
        where, total = (jnp.where, jnp.sum) if xp is jnp else (torch.where, torch.sum)
        return lambda t: where((t > 0.0).all(), -0.5 * total(t ** 2),
                               where(t[0] > -0.5, -np.inf, np.nan))

    # a support far narrower than the shrinking bracket: every lane hits the cap
    def needle(xp):
        where, total, absolute = ((jnp.where, jnp.sum, jnp.abs) if xp is jnp
                                  else (torch.where, torch.sum, torch.abs))
        return lambda t: where(total(absolute(t - 0.5)) < 1e-3, 0.0, -np.inf)

    for lik_fn, cfg_kw, cap in ((support, dict(num_samples=40), False),
                                (needle, dict(num_samples=6, max_shrink=5), True)):
        with jax.enable_x64(True):
            key = jax.random.key(9)
            ref = je.run_elliptical(key, lik_fn(jnp), jnp.full(2, 0.5),
                                    je.EllipticalConfig(**cfg_kw))
            noise = jax_noise(key, cfg_kw["num_samples"], 2, cfg_kw.get("max_shrink", 64),
                              jnp.float64)
        margins = []
        port = te.run_elliptical(0, lik_fn(torch), torch.full((2,), 0.5, dtype=torch.float64),
                                 te.EllipticalConfig(**cfg_kw), _noise=noise, _margins=margins)
        assert_elliptical_match(port, ref, margins, 1e-10)
        assert bool(port.stats.divergent.all()) == cap
        if cap:
            assert bool((port.samples == 0.5).all()) and bool((port.stats.shrinks == 5).all())
        else:
            assert bool((port.samples > 0).all()) and not bool(port.stats.divergent.any())


def test_resume_and_data_match_jax():
    x = np.linspace(-1.0, 1.0, 12)

    def ll(xp):
        total = jnp.sum if xp is jnp else torch.sum
        return lambda t, data: -0.5 * total((data * t[0] + t[1] - 0.3) ** 2) / 0.25

    with jax.enable_x64(True):
        key = jax.random.key(10)
        ref = je.run_elliptical(key, ll(jnp), jnp.zeros(2), je.EllipticalConfig(num_samples=40),
                                data=jnp.asarray(x))
        noise = jax_noise(key, 40, 2, 64, jnp.float64)
    cfg = te.EllipticalConfig(num_samples=20)
    xt = torch.as_tensor(x)
    c1 = te.run_elliptical(0, ll(torch), torch.zeros(2, dtype=torch.float64), cfg, data=xt,
                           _noise={k: v[:20] for k, v in noise.items()})
    c2 = te.run_elliptical(0, ll(torch), c1.final_theta, cfg, data=xt,
                           init_loglik=c1.final_loglik, start_step=c1.final_step,
                           _noise={k: v[20:] for k, v in noise.items()})
    assert_close(torch.cat([c1.samples, c2.samples]), ref.samples, 1e-10)
    assert int(c2.final_step) == 40


def test_default_noise_is_chunk_reproducible_and_chains_are_one_batch():
    ll = lik(torch)
    cfg = te.EllipticalConfig(num_samples=30, thin=3)
    full = te.run_elliptical_chains(2, ll, torch.zeros(3), cfg, 4)
    # a chunk of one chain per call is not the batch's stream; the batch's own
    # chunks are (the noise of a draw depends on the seed, the draw and the batch)
    c1 = te._run_elliptical(2, torch.zeros(4, 3), ll, dataclasses.replace(cfg, num_samples=12),
                            torch.tensor(1.0), torch.zeros(3))
    c2 = te._run_elliptical(2, c1.final_theta, ll, dataclasses.replace(cfg, num_samples=18),
                            torch.tensor(1.0), torch.zeros(3), init_loglik=c1.final_loglik,
                            start_step=12)
    assert torch.equal(torch.cat([c1.samples, c2.samples], dim=1), full.samples)
    assert not torch.equal(full.samples[0], full.samples[1])
    one = te.run_elliptical(2, ll, torch.zeros(3), te.EllipticalConfig(num_samples=30, thin=3))
    assert one.samples.shape == (10, 3) and one.final_loglik.shape == ()


def test_validation_matches_jax():
    for mod in (je, te):
        with pytest.raises(ValueError, match="num_samples"):
            mod.EllipticalConfig(num_samples=0)
        with pytest.raises(ValueError, match="divisible"):
            mod.EllipticalConfig(num_samples=10, thin=3)
        with pytest.raises(ValueError, match="max_shrink"):
            mod.EllipticalConfig(num_samples=10, max_shrink=0)
    ll = lik(torch)
    with pytest.raises(ValueError, match="prior_scale"):
        te.run_elliptical(0, ll, torch.zeros(3), te.EllipticalConfig(num_samples=5),
                          prior_scale=torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="1-d"):
        te.run_elliptical(0, ll, torch.zeros((4, 3)), te.EllipticalConfig(num_samples=5))
