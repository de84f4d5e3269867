"""Port vs JAX package: the affine-invariant stretch move (``samplers/stretch.py``).

The port runs on the JAX sampler's own randomness, replayed: iteration g
splits ``fold_in(key, g)`` into the two halves' keys, each split three ways
into the z uniforms (the state's dtype), the partner indices (``randint``)
and the Metropolis uniforms (float32).  They go into the port's
``_noise={"u_z", "j", "u_mh"}`` with a (2, K/2) row per iteration.  A
(D,) centre is jittered from ``fold_in(key, 2**32 - 1)`` in the JAX
package and from the port's own stream in the port, so the JAX run's
jittered walkers go to the port as an explicit matrix (or a stacked tree
with distinct rows, which the port does not jitter).

* Float64 (``jax.enable_x64``): positions and log-densities within 1e-10,
  identical accept fractions and divergence flags.
* Float32: within 1e-5 relative, identical decisions, each at least 1e-4
  from its other outcome (the ``_margins`` hook).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import stretch as js
from hamiltorch_tpu_torch.samplers import stretch as ts

MARGIN = 1e-4
STDS = np.array([0.5, 1.0, 2.0])


def aniso(xp):
    if xp is jnp:
        return lambda t: -0.5 * jnp.sum((t / jnp.asarray(STDS, t.dtype)) ** 2)
    return lambda t: -0.5 * torch.sum((t / torch.as_tensor(STDS, dtype=t.dtype)) ** 2)


def tree_lp(xp):
    total = jnp.sum if xp is jnp else torch.sum

    def lp(t):
        return -0.5 * (total(t["a"] ** 2) + (t["b"] - 1.0) ** 2)
    return lp


def jax_noise(key, iters, half, dtype, start=0):
    """The JAX runner's draws in the port's ``_noise`` layout."""
    def draw(g):
        out = []
        for kh in jax.random.split(jax.random.fold_in(key, g)):
            k_z, k_j, k_u = jax.random.split(kh, 3)
            out.append((jax.random.uniform(k_z, (half,), dtype),
                        jax.random.randint(k_j, (half,), 0, half),
                        jax.random.uniform(k_u, (half,), jnp.float32)))
        return [jnp.stack([out[0][i], out[1][i]]) for i in range(3)]

    u_z, j, u_mh = jax.vmap(draw)(jnp.arange(start, start + iters))
    return {"u_z": torch.as_tensor(np.array(u_z)), "j": torch.as_tensor(np.array(j, np.int64)),
            "u_mh": torch.as_tensor(np.array(u_mh))}


def jax_jittered(key, centre, k, jitter):
    noise = jax.random.normal(jax.random.fold_in(key, 2**32 - 1), (k,) + centre.shape,
                              centre.dtype)
    return np.asarray(centre[None, :] + jitter * noise)


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def assert_close(port, ref, rel):
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def assert_stretch_match(port, ref, margins, rel):
    if margins is not None:
        assert min(float(m) for m in margins) >= MARGIN
    # identical accept counts (XLA divides by K as a product with 1/K: the
    # last bit may differ)
    np.testing.assert_allclose(port.stats.accept_frac.numpy(), np.asarray(ref.stats.accept_frac),
                               rtol=1e-6)
    np.testing.assert_array_equal(port.stats.divergent.numpy(), np.asarray(ref.stats.divergent))
    assert_close(port.samples, ref.samples, rel)
    assert_close(port.final_walkers, ref.final_walkers, rel)
    assert_close(port.final_logp, ref.final_logp, rel)
    np.testing.assert_allclose(float(port.acc_rate), float(ref.acc_rate), rtol=1e-6)
    assert int(port.final_step) == int(ref.final_step)


# (name, dtype, start form, config kwargs, num_walkers, seed)
CASES = [
    ("f64-centre", np.float64, "centre", dict(num_samples=60), 16, 1),
    ("f64-matrix-thin", np.float64, "matrix", dict(num_samples=60, thin=3), 16, 2),
    ("f64-a3", np.float64, "matrix", dict(num_samples=40, a=3.0), 8, 3),
    ("f32-centre", np.float32, "centre", dict(num_samples=60), 16, 4),
    ("f32-matrix-thin", np.float32, "matrix", dict(num_samples=40, thin=2), 12, 5),
]


@pytest.mark.parametrize("name,dtype,form,cfg_kw,k,seed", CASES, ids=[c[0] for c in CASES])
def test_run_stretch_matches_jax(name, dtype, form, cfg_kw, k, seed):
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.key(seed)
        if form == "centre":
            start_j = jnp.zeros(3, dtype)
            walkers = jax_jittered(key, start_j, k, 0.1)
        else:
            walkers = np.random.RandomState(seed).randn(k, 3).astype(dtype)
            start_j = jnp.asarray(walkers)
        ref = js.run_stretch(key, aniso(jnp), start_j, js.StretchConfig(**cfg_kw),
                             num_walkers=k, init_jitter=0.1)
        noise = jax_noise(key, cfg_kw["num_samples"], k // 2, jnp.dtype(dtype))
    margins = [] if dtype == np.float32 else None
    port = ts.run_stretch(0, aniso(torch), torch.as_tensor(walkers), ts.StretchConfig(**cfg_kw),
                          num_walkers=k, _noise=noise, _margins=margins)
    assert_stretch_match(port, ref, margins, 1e-10 if dtype == np.float64 else 1e-5)
    assert 0.0 < float(port.acc_rate) < 1.0


def test_tree_walkers_match_jax():
    with jax.enable_x64(True):
        key = jax.random.key(7)
        tree0 = {"a": jnp.zeros(2), "b": jnp.ones(())}
        ref = js.run_stretch(key, tree_lp(jnp), tree0, js.StretchConfig(num_samples=50),
                             num_walkers=8)
        flat = jax_jittered(key, jnp.array([0.0, 0.0, 1.0]), 8, 1e-2)
        noise = jax_noise(key, 50, 4, jnp.float64)
    start = {"a": torch.as_tensor(flat[:, :2]), "b": torch.as_tensor(flat[:, 2])}
    port = ts.run_stretch(0, tree_lp(torch), start, ts.StretchConfig(num_samples=50),
                          num_walkers=8, _noise=noise)
    assert port.samples["a"].shape == (50, 8, 2) and port.samples["b"].shape == (50, 8)
    assert port.final_walkers["a"].shape == (8, 2)
    assert_stretch_match(port, ref, None, 1e-10)


@pytest.mark.parametrize("target", ["nan-cliff", "hard-support", "staircase"])
def test_irregular_targets_match_jax(target):
    def lp(xp):
        total, where, floor, absolute = ((jnp.sum, jnp.where, jnp.floor, jnp.abs) if xp is jnp
                                         else (torch.sum, torch.where, torch.floor, torch.abs))
        if target == "nan-cliff":  # NaN outside the box: auto-rejected, flags divergent
            return lambda t: where((absolute(t) < 1.0).all(), -0.5 * total(t ** 2), np.nan)
        if target == "hard-support":  # -inf outside: any non-finite proposal flags too
            return lambda t: where(t[0] > 0.0, -0.5 * total(t ** 2), -np.inf)
        # quantised: the gradient is 0 almost everywhere, the stretch move does not care
        return lambda t: -0.5 * floor(total(t ** 2) * 4.0) / 4.0

    with jax.enable_x64(True):
        key = jax.random.key(11)
        walkers = np.abs(np.random.RandomState(11).rand(16, 2)) * 0.5
        ref = js.run_stretch(key, lp(jnp), jnp.asarray(walkers), js.StretchConfig(num_samples=60),
                             num_walkers=16)
        noise = jax_noise(key, 60, 8, jnp.float64)
    port = ts.run_stretch(0, lp(torch), torch.as_tensor(walkers), ts.StretchConfig(num_samples=60),
                          num_walkers=16, _noise=noise)
    assert_stretch_match(port, ref, None, 1e-10)
    assert bool(torch.isfinite(port.samples).all())
    assert bool(port.stats.divergent.any()) == (target != "staircase")


def test_resume_and_data_match_jax():
    x = np.random.RandomState(3).randn(10, 3)

    def lp_j(t, data):
        return -0.5 * jnp.sum((data @ t) ** 2) - 0.5 * jnp.sum(t ** 2)

    def lp_t(t, data):
        return -0.5 * torch.sum((data @ t) ** 2) - 0.5 * torch.sum(t ** 2)

    with jax.enable_x64(True):
        key = jax.random.key(13)
        walkers = np.random.RandomState(13).randn(8, 3)
        ref = js.run_stretch(key, lp_j, jnp.asarray(walkers), js.StretchConfig(num_samples=40),
                             num_walkers=8, data=jnp.asarray(x))
        noise = jax_noise(key, 40, 4, jnp.float64)
    half = ts.StretchConfig(num_samples=20)
    c1 = ts.run_stretch(0, lp_t, torch.as_tensor(walkers), half, num_walkers=8,
                        data=torch.as_tensor(x), _noise={k: v[:20] for k, v in noise.items()})
    c2 = ts.run_stretch(0, lp_t, c1.final_walkers, half, num_walkers=8, data=torch.as_tensor(x),
                        init_logp=c1.final_logp, start_step=c1.final_step,
                        _noise={k: v[20:] for k, v in noise.items()})
    assert_close(torch.cat([c1.samples, c2.samples]), ref.samples, 1e-10)
    assert_close(c2.final_logp, ref.final_logp, 1e-10)
    assert int(c2.final_step) == 40


def test_default_noise_is_chunk_reproducible_and_the_jitter_is_keyed():
    lp = aniso(torch)
    cfg = ts.StretchConfig(num_samples=30, thin=2)
    full = ts.run_stretch(3, lp, torch.zeros(3), cfg, num_walkers=8)
    c1 = ts.run_stretch(3, lp, torch.zeros(3), dataclasses.replace(cfg, num_samples=10),
                        num_walkers=8)
    c2 = ts.run_stretch(3, lp, c1.final_walkers, dataclasses.replace(cfg, num_samples=20),
                        num_walkers=8, init_logp=c1.final_logp, start_step=c1.final_step)
    assert torch.equal(torch.cat([c1.samples, c2.samples]), full.samples)
    # the jitter of a centre: draw_seed(key, 1, STRETCH_STREAM) normals
    explicit = 1e-2 * ts._jitter(3, (8, 3), torch.float32, torch.device("cpu"))
    again = ts.run_stretch(3, lp, explicit, cfg, num_walkers=8)
    assert torch.equal(again.samples, full.samples)
    assert not torch.equal(ts.run_stretch(4, lp, torch.zeros(3), cfg, num_walkers=8).samples,
                           full.samples)
    assert not torch.equal(full.samples[:, 0], full.samples[:, 1])  # walkers decorrelate


def test_validation_matches_jax():
    for mod in (js, ts):
        with pytest.raises(ValueError, match="num_samples"):
            mod.StretchConfig(num_samples=0)
        with pytest.raises(ValueError, match="stretch scale"):
            mod.StretchConfig(num_samples=10, a=1.0)
        with pytest.raises(ValueError, match="divisible"):
            mod.StretchConfig(num_samples=10, thin=3)
    lp = aniso(torch)
    for k in (7, 2):
        with pytest.raises(ValueError, match="EVEN"):
            ts.run_stretch(0, lp, torch.zeros(3), ts.StretchConfig(num_samples=5), num_walkers=k)
    with pytest.raises(ValueError, match="rows"):
        ts.run_stretch(0, lp, torch.zeros((8, 3)), ts.StretchConfig(num_samples=5),
                       num_walkers=16)
    with pytest.raises(ValueError, match="num_walkers, D"):
        ts.run_stretch(0, lp, torch.zeros((2, 8, 3)), ts.StretchConfig(num_samples=5),
                       num_walkers=8)


def test_bfloat16_walkers_keep_float32_log_densities():
    r = ts.run_stretch(0, aniso(torch), torch.zeros(3, dtype=torch.bfloat16),
                       ts.StretchConfig(num_samples=10), num_walkers=8)
    assert r.samples.dtype == torch.bfloat16 and r.final_logp.dtype == torch.float32
