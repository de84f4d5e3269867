"""Port vs JAX package: WAIC, PSIS-LOO and compare() (``model_comparison.py``).

Both packages get the same (S, N) log-likelihood matrices, drawn with numpy
from a seed: a conjugate Gaussian-mean posterior (every Pareto k well below
0.7), a column with a Pareto(1) tail beside Gaussian ones (k above 0.7),
a trace too short to smooth (k = inf), and one wider than the smoothing's
1024-column block.

Tolerances: the PSIS weights, the Pareto k and the LOO pointwise values run
in float64 on both sides (the JAX package smooths in host numpy), rtol 1e-9;
WAIC, which the JAX package reduces in float32, rtol 1e-5 (sums over N)
and atol 1e-5 pointwise; the LOO ``p_eff`` (a difference of two sums over
N, one of them a float32 logsumexp in the JAX package) rtol 1e-9 against
numpy in float64 and within 1e-6 per observation of the JAX package's.
The port reduces in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu.model_comparison as jmc
import hamiltorch_tpu_torch.model_comparison as tmc
from hamiltorch_tpu_torch.models.bnn import log_likelihood


def conjugate(num_draws=4000, n_obs=40, seed=0):
    """mu ~ N(0, 1), y_i ~ N(mu, 1): draws of the exact posterior."""
    rng = np.random.default_rng(seed)
    y = 0.7 + rng.normal(size=n_obs)
    m, v = y.sum() / (n_obs + 1), 1.0 / (n_obs + 1)
    mus = m + np.sqrt(v) * rng.normal(size=num_draws)
    return -0.5 * np.log(2 * np.pi) - 0.5 * (y[None, :] - mus[:, None]) ** 2


def heavy_tail(num_draws=4000, seed=3):
    rng = np.random.default_rng(seed)
    lw_pareto = -np.log1p(-rng.uniform(size=num_draws))  # GPD tail with k = 1
    return np.concatenate([-lw_pareto[:, None], rng.normal(size=(num_draws, 10))], axis=1)


MATRICES = {
    "conjugate": lambda: conjugate(),
    "heavy_tail": lambda: heavy_tail(),
    "short": lambda: conjugate(num_draws=12),
    "wide": lambda: conjugate(num_draws=300, n_obs=2100, seed=5),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_psis_loo_matches_jax(name):
    ll = MATRICES[name]()
    j = jmc.psis_loo(ll)
    t = tmc.psis_loo(torch.as_tensor(ll))
    np.testing.assert_allclose(t.pointwise.numpy(), j.pointwise, rtol=1e-9)
    np.testing.assert_array_equal(np.isinf(t.pareto_k.numpy()), np.isinf(j.pareto_k))
    finite = np.isfinite(j.pareto_k)
    np.testing.assert_allclose(t.pareto_k.numpy()[finite], j.pareto_k[finite], rtol=1e-9)
    np.testing.assert_allclose(t.elpd, j.elpd, rtol=1e-9)
    np.testing.assert_allclose(t.se, j.se, rtol=1e-9)
    # p_eff = sum_i (lppd_i - pointwise_i): the JAX package takes each lppd_i
    # by a float32 logsumexp over S draws (~1e-6 of rounding); the port's is float64
    lppd = np.logaddexp.reduce(ll, axis=0) - np.log(ll.shape[0])
    np.testing.assert_allclose(t.p_eff, np.sum(lppd - j.pointwise), rtol=1e-9)
    np.testing.assert_allclose(t.p_eff, j.p_eff, rtol=0, atol=1e-6 * ll.shape[1])
    if name == "heavy_tail":
        assert t.pareto_k[0] > 0.7 and bool((t.pareto_k[1:] < 0.7).all())
    if name == "short":
        assert bool(torch.isinf(t.pareto_k).all())


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_psis_weights_match_jax(name):
    ll = MATRICES[name]()
    j_lw, j_k = jmc.psis_smooth_weights(ll)
    t_lw, t_k = tmc.psis_smooth_weights(torch.as_tensor(ll))
    np.testing.assert_allclose(t_lw.numpy(), j_lw, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.isinf(t_k.numpy()), np.isinf(j_k))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_waic_matches_jax(name):
    ll = MATRICES[name]().astype(np.float32)
    j = jmc.waic(jnp.asarray(ll))
    t = tmc.waic(torch.as_tensor(ll))
    assert t.pointwise.dtype == torch.float64
    np.testing.assert_allclose(t.pointwise.numpy(), j.pointwise, rtol=1e-5, atol=1e-5)
    for field in ("elpd", "p_eff", "se"):
        np.testing.assert_allclose(getattr(t, field), getattr(j, field), rtol=1e-5)


def test_gpd_fit_matches_jax_and_recovers_the_shape():
    m, k_true, sigma_true = 2000, 0.5, 1.3
    q = (np.arange(1, m + 1) - 0.5) / m
    z = np.sort(sigma_true * (np.power(1 - q, -k_true) - 1.0) / k_true)[:, None]
    j_k, j_sigma = jmc._gpd_fit(z)
    t_k, t_sigma = tmc._gpd_fit(torch.as_tensor(z))
    np.testing.assert_allclose(t_k.numpy(), j_k, rtol=1e-9)
    np.testing.assert_allclose(t_sigma.numpy(), j_sigma, rtol=1e-9)
    assert abs(float(t_k[0]) - k_true) < 0.05 and abs(float(t_sigma[0]) - sigma_true) < 0.15


def test_compare_matches_jax():
    rng = np.random.default_rng(9)
    y = rng.normal(size=30)
    mats = {
        "true": -0.5 * np.log(2 * np.pi) - 0.5 * (y[None] - rng.normal(0, 0.1, (2000, 1))) ** 2,
        "wide": -0.5 * np.log(2 * np.pi * 4) - 0.125 * (y[None] - rng.normal(0, 0.1, (2000, 1))) ** 2,
        "shifted": -0.5 * np.log(2 * np.pi) - 0.5 * (y[None] - 1 - rng.normal(0, 0.1, (2000, 1))) ** 2,
    }
    for fn in ("psis_loo", "waic"):
        j = jmc.compare({k: getattr(jmc, fn)(v) for k, v in mats.items()})
        t = tmc.compare({k: getattr(tmc, fn)(torch.as_tensor(v)) for k, v in mats.items()})
        assert [r["name"] for r in t] == [r["name"] for r in j]
        assert t[0]["name"] == "true" and t[0]["d_elpd"] == 0.0 and t[0]["d_se"] == 0.0
        for tr, jr in zip(t, j):
            for field in ("elpd", "se", "d_elpd", "d_se"):
                np.testing.assert_allclose(tr[field], jr[field], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="same observations"):
        tmc.compare({"a": tmc.waic(torch.zeros(4, 3)), "b": tmc.waic(torch.zeros(4, 2))})
    with pytest.raises(ValueError, match="at least one"):
        tmc.compare({})


ZOO_PREDS = {
    "binary_class_linear_output": (1, lambda r: r.randint(0, 2, (7, 1)).astype(np.float32)),
    "multi_class_linear_output": (4, lambda r: r.randint(0, 4, 7).astype(np.float32)),
    "multi_class_log_softmax_output": (4, lambda r: r.randint(0, 4, 7).astype(np.float32)),
    "regression": (2, lambda r: r.randn(7, 2).astype(np.float32)),
}


@pytest.mark.parametrize("loss", sorted(ZOO_PREDS))
def test_pointwise_from_predictions_matches_jax(loss):
    width, targets = ZOO_PREDS[loss]
    r = np.random.RandomState(4)
    preds = r.randn(5, 7, width).astype(np.float32)
    if loss == "multi_class_log_softmax_output":
        preds = preds - np.log(np.exp(preds).sum(-1, keepdims=True))
    y = targets(r)
    j = jmc.pointwise_log_lik_from_predictions(jnp.asarray(preds), jnp.asarray(y), loss, 1.5)
    t = tmc.pointwise_log_lik_from_predictions(torch.as_tensor(preds), torch.as_tensor(y), loss, 1.5)
    assert tuple(t.shape) == (5, 7)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    if loss in ("binary_class_linear_output", "multi_class_linear_output"):
        # sums to the sampling-time likelihood, whose constants agree here
        zoo = log_likelihood(torch.as_tensor(preds[0]), torch.as_tensor(y), loss, 1.5)
        np.testing.assert_allclose(float(t[0].sum()), float(zoo), rtol=1e-5)


def test_pointwise_log_lik_matches_jax_and_blocks():
    rng = np.random.RandomState(6)
    x, y = rng.randn(9).astype(np.float32), rng.randn(9).astype(np.float32)
    samples = rng.randn(12, 2).astype(np.float32)

    def j_fn(theta, data):
        return -0.5 * (data[1] - theta[0] - theta[1] * data[0]) ** 2

    def t_fn(theta, data):
        return -0.5 * (data[1] - theta[0] - theta[1] * data[0]) ** 2

    j = jmc.pointwise_log_lik(j_fn, jnp.asarray(samples), (jnp.asarray(x), jnp.asarray(y)))
    t_data = (torch.as_tensor(x), torch.as_tensor(y))
    t = tmc.pointwise_log_lik(t_fn, torch.as_tensor(samples), t_data)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    blocked = tmc.pointwise_log_lik(t_fn, torch.as_tensor(samples), t_data, block_size=4)
    assert torch.equal(blocked, t)
    tree = {"a": torch.as_tensor(samples[:, 0]), "b": torch.as_tensor(samples[:, 1])}
    on_tree = tmc.pointwise_log_lik(lambda p: t_fn(torch.stack([p["a"], p["b"]]), t_data), tree,
                                    block_size=6)
    torch.testing.assert_close(on_tree, t)
    with pytest.raises(ValueError, match="divide"):
        tmc.pointwise_log_lik(t_fn, torch.as_tensor(samples), t_data, block_size=5)


def test_input_validation():
    with pytest.raises(ValueError, match="S, N"):
        tmc.waic(torch.zeros(4))
    with pytest.raises(ValueError, match="S, N"):
        tmc.psis_loo(torch.zeros(4, 3, 2))
    with pytest.raises(NotImplementedError):
        tmc.pointwise_log_lik_from_predictions(torch.zeros(2, 3, 1), torch.zeros(3), "nope")
