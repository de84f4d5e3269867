"""Port vs JAX package: MAP, Laplace and ADVI (``optim.py``).

optax becomes ``torch.optim``: ``optax.adam`` and ``torch.optim.Adam``
compute the same update, so the fits agree to rounding.  ADVI's Monte
Carlo normals at step i are the JAX package's ``normal(fold_in(key, i),
(num_mc_samples, D))``, replayed into the port's ``_noise``; the samplers'
normals are ``normal(key, (n, D))``.

* Float64 (``jax.enable_x64``): Adam against optax within 1e-10 after 200
  steps on a quadratic (``map_estimate``, flat and tree), ADVI mean-field
  and full-rank within 1e-10 after 200 steps, the Laplace mean, covariance,
  precision and evidence within 1e-10.
* Float32: within 1e-5 relative.
* Non-finite steps: the same steps rejected, the same best iterate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu import optim as jo
from hamiltorch_tpu_torch import optim as to

MU = np.array([1.0, -2.0, 0.5])
S2 = np.array([0.5, 1.0, 2.0])


def quad(xp, dtype=None):
    if xp is jnp:
        return lambda t: -0.5 * jnp.sum((t - MU.astype(t.dtype)) ** 2 / S2.astype(t.dtype))
    return lambda t: -0.5 * torch.sum((t - torch.as_tensor(MU, dtype=t.dtype)) ** 2
                                      / torch.as_tensor(S2, dtype=t.dtype))


def corr_gauss(xp, d=3, rho=0.6):
    cov = rho ** np.abs(np.subtract.outer(np.arange(d), np.arange(d)))
    prec = np.linalg.inv(cov)
    mu = np.linspace(-1.0, 1.0, d)
    if xp is jnp:
        return lambda t: -0.5 * (t - mu.astype(t.dtype)) @ prec.astype(t.dtype) @ (
            t - mu.astype(t.dtype))
    return lambda t: -0.5 * (t - torch.as_tensor(mu, dtype=t.dtype)) @ torch.as_tensor(
        prec, dtype=t.dtype) @ (t - torch.as_tensor(mu, dtype=t.dtype))


def tree_lp(xp):
    total = jnp.sum if xp is jnp else torch.sum
    return lambda t: -0.5 * (total((t["a"] - 1.0) ** 2 / 0.25) + total((t["b"] + 2.0) ** 2 / 4.0))


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def assert_close(port, ref, rel, unit=1e-30):
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(np.abs(b).max()), unit)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def advi_noise(key, steps, mc, d, dtype):
    z = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(key, i), (mc, d), dtype))(
        jnp.arange(steps))
    return torch.as_tensor(np.array(z))


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("form", ["flat", "tree"])
def test_map_estimate_adam_matches_optax(dtype, rel, form):
    with jax.enable_x64(dtype == np.float64):
        if form == "flat":
            start = np.zeros(3, dtype)
            ref = jo.map_estimate(quad(jnp), jnp.asarray(start), num_steps=200,
                                  learning_rate=0.05)
        else:
            start = {"a": np.zeros((), dtype), "b": np.zeros(2, dtype)}
            ref = jo.map_estimate(tree_lp(jnp), {k: jnp.asarray(v) for k, v in start.items()},
                                  num_steps=200, learning_rate=0.05)
    if form == "flat":
        port = to.map_estimate(quad(torch), torch.as_tensor(start), num_steps=200,
                               learning_rate=0.05)
    else:
        port = to.map_estimate(tree_lp(torch), {k: torch.as_tensor(v) for k, v in start.items()},
                               num_steps=200, learning_rate=0.05)
    assert_close(port.theta, ref.theta, rel)
    assert_close(port.final_theta, ref.final_theta, rel)
    assert_close(port.log_prob_trace, ref.log_prob_trace, max(rel, 1e-6), unit=1.0)
    assert_close(port.log_prob, ref.log_prob, max(rel, 1e-6), unit=1.0)
    assert int(port.num_rejected) == int(ref.num_rejected) == 0
    assert port.log_prob_trace.dtype == torch.float32


def test_map_rejects_the_non_finite_steps_jax_rejects():
    def cliff(xp):
        where, absolute, total = ((jnp.where, jnp.abs, jnp.sum) if xp is jnp
                                  else (torch.where, torch.abs, torch.sum))
        return lambda t: where(absolute(t).max() < 1.0, -0.5 * total((t - 0.9) ** 2),
                               np.inf if xp is jnp else torch.inf) * 1.0

    # +inf beyond the box: the gradient there is finite (0), the value is not,
    # so the best-iterate tracking must skip it; a gradient of NaN makes the
    # Adam state non-finite and the step is rejected
    def nan_grad(xp):
        sqrt, total = (jnp.sqrt, jnp.sum) if xp is jnp else (torch.sqrt, torch.sum)
        return lambda t: -0.5 * total((t - 1.5) ** 2) + 0.1 * sqrt(1.0 - t[0])

    with jax.enable_x64(True):
        refs = [jo.map_estimate(f(jnp), jnp.zeros(2), num_steps=60, learning_rate=0.2)
                for f in (cliff, nan_grad)]
    for f, ref in zip((cliff, nan_grad), refs):
        port = to.map_estimate(f(torch), torch.zeros(2, dtype=torch.float64), num_steps=60,
                               learning_rate=0.2)
        assert int(port.num_rejected) == int(ref.num_rejected)
        assert_close(port.theta, ref.theta, 1e-10)
        assert_close(port.final_theta, ref.final_theta, 1e-10)
        assert bool(torch.isfinite(port.theta).all()) and bool(torch.isfinite(port.log_prob))
    assert int(port.num_rejected) > 0


def test_map_custom_optimizer_and_data_match_jax():
    optax = pytest.importorskip("optax")
    x = np.random.RandomState(0).randn(8, 3)
    y = x @ np.array([0.5, -1.0, 2.0])

    def lp(xp):
        total = jnp.sum if xp is jnp else torch.sum
        return lambda t, data: -0.5 * total((data[0] @ t - data[1]) ** 2) - 0.5 * total(t ** 2)

    with jax.enable_x64(True):
        ref = jo.map_estimate(lp(jnp), jnp.zeros(3), num_steps=150, optimizer=optax.sgd(0.01),
                              data=(jnp.asarray(x), jnp.asarray(y)))
    port = to.map_estimate(lp(torch), torch.zeros(3, dtype=torch.float64), num_steps=150,
                           optimizer=lambda p: torch.optim.SGD(p, lr=0.01),
                           data=(torch.as_tensor(x), torch.as_tensor(y)))
    assert_close(port.theta, ref.theta, 1e-10)


@pytest.mark.parametrize("case", ["quadratic", "correlated", "tree", "saddle"])
def test_laplace_matches_jax(case):
    with jax.enable_x64(True):
        if case == "quadratic":
            args_j, args_t = (quad(jnp), jnp.asarray(MU)), (quad(torch), torch.as_tensor(MU))
        elif case == "correlated":
            args_j = (corr_gauss(jnp, 4), jnp.full(4, 0.1))
            args_t = (corr_gauss(torch, 4), torch.full((4,), 0.1, dtype=torch.float64))
        elif case == "tree":
            mode = {"a": np.ones(()), "b": np.full(2, -2.0)}
            args_j = (tree_lp(jnp), {k: jnp.asarray(v) for k, v in mode.items()})
            args_t = (tree_lp(torch), {k: torch.as_tensor(v) for k, v in mode.items()})
        else:  # a saddle: the spectrum is clipped to a PD covariance
            args_j = (lambda t: -0.5 * t[0] ** 2 + 0.5 * t[1] ** 2, jnp.zeros(2))
            args_t = (lambda t: -0.5 * t[0] ** 2 + 0.5 * t[1] ** 2,
                      torch.zeros(2, dtype=torch.float64))
        ref = jo.laplace_approx(*args_j)
        draws_j = jo.laplace_sample(jax.random.key(3), ref, 50)
        z = np.asarray(jax.random.normal(jax.random.key(3), (50, ref.mean.shape[0])))
    port = to.laplace_approx(*args_t)
    for f, unit in (("mean", 1.0), ("cov", 1e-30), ("prec", 1e-30), ("log_evidence", 1.0)):
        assert_close(getattr(port, f), getattr(ref, f), 1e-10, unit=unit)
    assert (port.unravel is None) == (ref.unravel is None)
    draws = to.laplace_sample(0, port, 50, _noise=torch.as_tensor(z))
    assert_close(draws, draws_j, 1e-10)
    assert bool((torch.linalg.eigvalsh(port.cov) > 0).all())
    if case == "quadratic":  # a Gaussian's Laplace approximation is exact
        np.testing.assert_allclose(float(port.log_evidence),
                                   float(np.sum(0.5 * np.log(2 * np.pi * S2))), atol=1e-10)


# (name, dtype, method, form, steps)
ADVI_CASES = [
    ("f64-meanfield", np.float64, "meanfield", "flat", 200),
    ("f64-fullrank", np.float64, "fullrank", "flat", 200),
    ("f64-meanfield-tree", np.float64, "meanfield", "tree", 100),
    ("f32-meanfield", np.float32, "meanfield", "flat", 100),
    ("f32-fullrank", np.float32, "fullrank", "flat", 100),
]


@pytest.mark.parametrize("name,dtype,method,form,steps", ADVI_CASES,
                         ids=[c[0] for c in ADVI_CASES])
def test_advi_matches_jax(name, dtype, method, form, steps):
    mc, rel = 4, (1e-10 if dtype == np.float64 else 1e-5)
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.key(5)
        if form == "flat":
            lp_j, lp_t = corr_gauss(jnp), corr_gauss(torch)
            start_j, start_t = jnp.zeros(3, dtype), torch.as_tensor(np.zeros(3, dtype))
        else:
            lp_j, lp_t = tree_lp(jnp), tree_lp(torch)
            start_j = {"a": jnp.zeros((), dtype), "b": jnp.zeros(2, dtype)}
            start_t = {"a": torch.zeros((), dtype=torch.float64),
                       "b": torch.zeros(2, dtype=torch.float64)}
        ref = jo.advi(lp_j, start_j, num_steps=steps, learning_rate=0.05, num_mc_samples=mc,
                      key=key, method=method)
        noise = advi_noise(key, steps, mc, 3, jnp.dtype(dtype))
        z = np.asarray(jax.random.normal(jax.random.key(6), (40, 3), jnp.dtype(dtype)))
        draws_j = jo.advi_sample(jax.random.key(6), ref, 40)
        cov_j = jo.advi_cov(ref)
    port = to.advi(lp_t, start_t, num_steps=steps, learning_rate=0.05, num_mc_samples=mc,
                   method=method, _noise=noise)
    assert_close(port.mean, ref.mean, rel, unit=1.0)
    assert_close(port.log_std, ref.log_std, rel, unit=1.0)
    assert_close(port.elbo_trace, ref.elbo_trace, rel, unit=1.0)
    assert_close(port.elbo, ref.elbo, rel, unit=1.0)
    assert (port.scale_tril is None) == (method == "meanfield")
    if method == "fullrank":
        assert_close(port.scale_tril, ref.scale_tril, rel, unit=1.0)
    assert_close(to.advi_cov(port), cov_j, rel, unit=1.0)
    draws = to.advi_sample(0, port, 40, _noise=torch.as_tensor(z))
    assert_close(draws, draws_j, rel, unit=1.0)


def test_advi_rejects_non_finite_steps_as_jax_does():
    # the objective is NaN where a Monte Carlo draw leaves the box
    def boxed(xp):
        where, absolute, total = ((jnp.where, jnp.abs, jnp.sum) if xp is jnp
                                  else (torch.where, torch.abs, torch.sum))
        return lambda t: where(absolute(t).max() < 1.5, -0.5 * total(t ** 2), np.nan)

    with jax.enable_x64(True):
        key = jax.random.key(7)
        ref = jo.advi(boxed(jnp), jnp.zeros(2), num_steps=80, learning_rate=0.05, key=key,
                      init_log_std=-0.5)
        noise = advi_noise(key, 80, 4, 2, jnp.float64)
    port = to.advi(boxed(torch), torch.zeros(2, dtype=torch.float64), num_steps=80,
                   learning_rate=0.05, init_log_std=-0.5, _noise=noise)
    assert bool(torch.isnan(port.elbo_trace).any())
    assert_close(port.mean, ref.mean, 1e-10, unit=1.0)
    assert_close(port.log_std, ref.log_std, 1e-10, unit=1.0)


def test_default_streams_and_statistics():
    r = to.advi(quad(torch), torch.zeros(3), num_steps=1500, learning_rate=0.02,
                num_mc_samples=8)
    again = to.advi(quad(torch), torch.zeros(3), num_steps=1500, learning_rate=0.02,
                    num_mc_samples=8, key=0)
    assert torch.equal(r.mean, again.mean)  # the default key is 0
    np.testing.assert_allclose(r.mean.numpy(), MU, atol=0.1)
    np.testing.assert_allclose(torch.exp(r.log_std).numpy(), np.sqrt(S2), rtol=0.15)
    np.testing.assert_allclose(float(r.elbo), float(np.sum(0.5 * np.log(2 * np.pi * S2))),
                               atol=0.2)
    d1, d2 = to.advi_sample(1, r, 1000), to.advi_sample(1, r, 1000)
    assert torch.equal(d1, d2) and not torch.equal(d1, to.advi_sample(2, r, 1000))
    tree = to.advi(tree_lp(torch), {"a": torch.zeros(()), "b": torch.zeros(2)}, num_steps=50)
    draws = to.advi_sample(3, tree, 7)
    assert draws["a"].shape == (7,) and draws["b"].shape == (7, 2)


def test_validation_matches_jax():
    for mod, start in ((jo, jnp.zeros(3)), (to, torch.zeros(3))):
        lp = quad(jnp if mod is jo else torch)
        with pytest.raises(ValueError, match="num_steps"):
            mod.map_estimate(lp, start, num_steps=0)
        with pytest.raises(ValueError, match="num_steps"):
            mod.advi(lp, start, num_steps=0)
        with pytest.raises(ValueError, match="num_mc_samples"):
            mod.advi(lp, start, num_mc_samples=0)
        with pytest.raises(ValueError, match="method"):
            mod.advi(lp, start, method="structured")
