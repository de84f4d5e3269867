"""Port vs JAX package: thermodynamic integration (``samplers/ti.py``).

The port runs on the JAX sampler's own randomness, replayed: draw ``n``
splits ``fold_in(key, n)`` three ways into the momentum key (split once per
leaf: each leaf's (K, ...) normal), the Metropolis key (K uniforms) and the
swap key (K uniforms, the lower index of each pair used); they go into the
port's ``_noise={"z", "u_mh", "u_swap"}`` (``z`` a tree of (S, K, ...)
leaves for a tree state).  Both packages get the same numpy starts.

* Float32 over 20 draws, K = 3 and 4, flat and two-leaf tree states, with
  and without swaps, with a ``data=`` operand: identical swap outcomes,
  positions, log-likelihoods and evidence within 1e-5 relative, and every
  Metropolis and swap decision at least 1e-4 from its other outcome.
* Float64 (``jax.enable_x64``) with per-rung dual averaging across ``burn``
  (the step switches to the averaged one at draw ``burn``): within 1e-10.
* ``evidence_from_loglik_draws`` on synthetic draws (constant, and random
  against the JAX function); the validation errors of ``tests/test_ti.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import ti as jti
from hamiltorch_tpu_torch.samplers import ti as tti

MARGIN = 1e-4
LAM = 4.0


def model(xp, tree=False):
    """(log_prior, log_lik): N(0, I) prior, a non-Gaussian likelihood."""
    total = jnp.sum if xp is jnp else torch.sum

    def flat(t):
        if not tree:
            return t
        return (jnp.concatenate([t["a"], t["b"][None]]) if xp is jnp
                else torch.cat([t["a"], t["b"][None]]))

    def log_prior(t):
        x = flat(t)
        return -0.5 * total(x ** 2) - 0.5 * x.shape[0] * float(np.log(2 * np.pi))

    def log_lik(t, data=None):
        x = flat(t)
        shift = 0.3 if data is None else data
        return -0.5 * LAM * total((x - shift) ** 2) + 0.2 * total(xp.cos(2.0 * x))
    return log_prior, log_lik


def jax_ti_noise(key, draws, shapes, dtype, start=0):
    """The JAX runner's draws: per leaf (S, K, ...) normals, and (S, K)
    Metropolis and swap uniforms."""
    k = shapes[0][0]

    def one(n):
        k_mom, k_mh, k_swap = jax.random.split(jax.random.fold_in(key, n), 3)
        mom_keys = jax.random.split(k_mom, len(shapes))
        zs = [jax.random.normal(mk, shape, dtype) for mk, shape in zip(mom_keys, shapes)]
        return zs, jax.random.uniform(k_mh, (k,), dtype), jax.random.uniform(k_swap, (k,), dtype)

    zs, u_mh, u_swap = jax.vmap(one)(start + jnp.arange(draws))
    return [torch.as_tensor(np.array(z)) for z in zs], torch.as_tensor(
        np.array(u_mh)), torch.as_tensor(np.array(u_swap))


def starts(form, k, dtype, seed):
    block = (0.8 * np.random.RandomState(seed).randn(k, 3)).astype(dtype)
    if form == "flat":
        return jnp.asarray(block), torch.as_tensor(block)
    return ({"a": jnp.asarray(block[:, :2]), "b": jnp.asarray(block[:, 2])},
            {"a": torch.as_tensor(block[:, :2]), "b": torch.as_tensor(block[:, 2])})


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


def run_both(form, k, cfg_kw, dtype, seed=0, data=None):
    cfg_j, cfg_t = jti.TIConfig(**cfg_kw), tti.TIConfig(**cfg_kw)
    j_t0, t_t0 = starts(form, k, dtype, seed)
    tree = form == "tree"
    j_prior, j_lik = model(jnp, tree)
    t_prior, t_lik = model(torch, tree)
    key = jax.random.key(seed + 21)
    shapes = [(k, 2), (k,)] if tree else [(k, 3)]
    zs, u_mh, u_swap = jax_ti_noise(key, cfg_kw["num_samples"], shapes, jnp.dtype(dtype))
    z = {"a": zs[0], "b": zs[1]} if tree else zs[0]
    margins = []
    j_data = t_data = None
    if data is not None:
        j_data, t_data = jnp.asarray(data, dtype), torch.as_tensor(np.asarray(data, dtype))
    ref = jti.run_ti(key, j_prior, j_lik, j_t0, cfg_j, data=j_data)
    port = tti.run_ti(0, t_prior, t_lik, t_t0, cfg_t, data=t_data,
                      _noise={"z": z, "u_mh": u_mh, "u_swap": u_swap}, _margins=margins)
    return port, ref, margins


def assert_ti_match(port, ref, rel):
    np.testing.assert_array_equal(port.info.swap_accept.numpy(), np.asarray(ref.info.swap_accept))
    assert_close(port.samples, ref.samples, rel)
    assert_close(port.loglik_draws, ref.loglik_draws, rel)
    np.testing.assert_allclose(port.info.accept_prob.numpy(), np.asarray(ref.info.accept_prob),
                               rtol=0, atol=rel)
    for f in ("log_evidence", "log_evidence_ti", "log_evidence_ti_plain"):
        np.testing.assert_allclose(float(getattr(port, f)), float(getattr(ref, f)), rtol=rel)
    for f in ("betas", "step_sizes", "rung_mean_loglik", "rung_var_loglik"):
        np.testing.assert_allclose(getattr(port.info, f).numpy(),
                                   np.asarray(getattr(ref.info, f)), rtol=rel, atol=rel)


# (form, K, swap, data)
F32_CASES = [
    ("flat", 3, True, None),
    ("flat", 4, True, None),
    ("tree", 3, True, None),
    ("tree", 4, False, None),
    ("flat", 4, True, 0.1),
]


@pytest.mark.parametrize("form,k,swap,data", F32_CASES,
                         ids=[f"{c[0]}-K{c[1]}-swap{c[2]}-data{c[3]}" for c in F32_CASES])
def test_float32_matches_jax(form, k, swap, data):
    cfg_kw = dict(num_samples=20, num_steps_per_sample=4, step_size=0.3, num_temps=k,
                  schedule_power=2.0, burn=4, swap=swap, adapt_step_size=False)
    port, ref, margins = run_both(form, k, cfg_kw, np.float32, data=data)
    assert min(float(m) for m in margins) >= MARGIN
    assert_ti_match(port, ref, 1e-5)
    swaps = port.info.swap_accept.numpy()
    if swap:
        assert swaps.any() and not swaps.all()
    else:
        assert not swaps.any()
    assert (port.info.accept_prob.numpy() < 1.0).any()


# (form, K)
F64_CASES = [("flat", 3), ("flat", 4), ("tree", 4)]


@pytest.mark.parametrize("form,k", F64_CASES, ids=[f"{c[0]}-K{c[1]}" for c in F64_CASES])
def test_float64_dual_averaging_matches_jax(form, k):
    """Per-rung dual averaging over burn 20 of 36 draws; from draw 20 on every
    rung steps with exp(log_eps_bar).  Acceptance target 0.95, where dual
    averaging does not amplify a last-bit difference (see
    tests/test_torch_tempering.py)."""
    cfg_kw = dict(num_samples=36, num_steps_per_sample=4, step_size=0.3, num_temps=k,
                  schedule_power=2.0, burn=20, desired_accept_rate=0.95)
    with jax.enable_x64(True):
        port, ref, _ = run_both(form, k, cfg_kw, np.float64, seed=1)
    assert_ti_match(port, ref, 1e-10)
    assert port.loglik_draws.dtype == torch.float64


def test_evidence_from_synthetic_draws():
    """Constant draws reduce every estimator to the integral of a constant
    (tests/test_ti.py:102); random draws agree with the JAX function."""
    betas = tti.ti_ladder(6, 1.0)
    llik = torch.full((100, 6), -2.5)
    for v in tti.evidence_from_loglik_draws(llik, betas):
        assert abs(float(v) + 2.5) < 1e-5
    rng = np.random.RandomState(3)
    for dtype in (np.float32, np.float64):
        draws = (rng.randn(50, 7) * 3.0 - 10.0).astype(dtype)
        b = (np.arange(7) / 6.0) ** 3
        with jax.enable_x64(dtype == np.float64):
            want = jti.evidence_from_loglik_draws(jnp.asarray(draws), jnp.asarray(b, dtype))
            got = tti.evidence_from_loglik_draws(torch.as_tensor(draws),
                                                 torch.as_tensor(b.astype(dtype)))
            for g, w in zip(got, want):
                np.testing.assert_allclose(float(g), float(w),
                                           rtol=1e-5 if dtype == np.float32 else 1e-12)


def test_ladder_matches_jax():
    for k, power in ((16, 5.0), (5, 1.0), (2, 3.0)):
        b = tti.ti_ladder(k, power)
        np.testing.assert_allclose(b.numpy(), np.asarray(jti.ti_ladder(k, power)), rtol=1e-6)
        assert float(b[0]) == 0.0 and float(b[-1]) == 1.0
        assert bool((torch.diff(b) > 0).all())


def test_validation_errors():
    with pytest.raises(ValueError, match="num_temps"):
        tti.TIConfig(num_samples=10, num_temps=1, burn=1)
    with pytest.raises(ValueError, match="schedule_power"):
        tti.TIConfig(num_samples=10, schedule_power=0.0, burn=1)
    with pytest.raises(ValueError, match="burn"):
        tti.TIConfig(num_samples=10, adapt_step_size=True, burn=0)
    with pytest.raises(ValueError, match="desired_accept_rate"):
        tti.TIConfig(num_samples=10, burn=1, desired_accept_rate=1.0)
    log_prior, log_lik = model(torch)
    with pytest.raises(RuntimeError, match="burn"):
        tti.run_ti(0, log_prior, log_lik, torch.zeros(3), tti.TIConfig(num_samples=10, burn=10))
    with pytest.raises(ValueError, match="rungs"):
        tti.run_ti(0, log_prior, log_lik, torch.zeros(3, 3),
                   tti.TIConfig(num_samples=10, num_temps=8, burn=1))


def test_default_noise_is_keyed_and_repeatable():
    log_prior, log_lik = model(torch)
    cfg = tti.TIConfig(num_samples=10, num_steps_per_sample=3, step_size=0.3, num_temps=4, burn=3)
    a = tti.run_ti(3, log_prior, log_lik, torch.zeros(3), cfg)
    b = tti.run_ti(3, log_prior, log_lik, torch.zeros(3), cfg)
    c = tti.run_ti(4, log_prior, log_lik, torch.zeros(3), cfg)
    assert torch.equal(a.samples, b.samples) and torch.equal(a.loglik_draws, b.loglik_draws)
    assert not torch.equal(a.samples, c.samples)
    assert a.samples.shape == (7, 3) and a.info.swap_accept.shape == (7, 3)
    assert np.isfinite(float(a.log_evidence))
