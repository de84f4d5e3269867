"""Port vs JAX package: ChEES-HMC (``samplers/chees.py``).

The port runs on the JAX sampler's own randomness, replayed: draw ``n``
splits ``fold_in(key, n)`` into the momentum key (split once per chain:
each chain's (D,) normal), the jitter key (one uniform shared by every
chain) and the Metropolis key (one uniform per chain); they go into the
port's ``_noise=(z, log_u, u)``.  Starts are passed stacked, so that the
JAX sampler uses its key for nothing else.

* Float64 (``jax.enable_x64``) with adaptation: a short warmup schedule
  with two slow windows handed to both runners (``_run_chees_jit`` /
  ``_run_chees``), flat and tree states, jitter ``uniform`` and
  ``halton``, ``adapt_mass`` False / ``"diag"`` / ``"dense"``, ``thin``,
  and ``run_chees``'s own schedule over 160 draws: identical leapfrog
  counts, divergences and accept decisions (which chains moved), and
  positions, step sizes, trajectory lengths and the adapted metric within
  1e-10 relative of the JAX run's.  These runs target an acceptance of
  0.95: dual averaging feeds each draw's mean acceptance back into the
  step size, and its slope in log eps (about 4 (1 - alpha) on a Gaussian)
  decides whether a last-bit difference (XLA's exp and log, the order of a
  sum) shrinks or grows from draw to draw: near an acceptance of 1 the
  slope is small and the differences stay at rounding level, while at the
  default 0.651 the feedback amplifies them draw after draw, past the 1e-10
  gate within these 60 draws.
* Float32 without adaptation: positions within 1e-5 of the largest
  |theta|; ``trace_dtype="bfloat16"`` stores exactly the float32 run's
  draws rounded, and within one bfloat16 ulp of the JAX trace.
* ``_vdc_base2`` equals the JAX package's for every n in [0, 2**16) and at
  reversals near 2**32 (float32 rounds 2**32 - 128 and above to 1.0).
* The overflow guard of the criterion gradient, the leapfrog cap, the
  validation errors (the JAX package's types) and the moments of the
  correlated Gaussian of ``tests/test_chees.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu_torch as tht
from hamiltorch_tpu.ops import mass as jmass
from hamiltorch_tpu.samplers import chees as jch
from hamiltorch_tpu_torch.ops import mass as tmass
from hamiltorch_tpu_torch.samplers import chees as tch

SCALES = np.array([1.0, 1.5, 0.8])
CHAINS = 8
COV = np.array([[1.0, 0.7], [0.7, 1.0]])


def flat_lp(xp, dtype):
    scales = jnp.asarray(SCALES, dtype) if xp is jnp else torch.as_tensor(SCALES, dtype=dtype)

    def lp(t):
        return -0.5 * xp.sum((t / scales) ** 2) + 0.05 * xp.sum(xp.sin(t))
    return lp


def tree_lp(xp, dtype):
    """The flat target on {"a": (2,), "b": ()}: leaf order a, b."""
    flat = flat_lp(xp, dtype)

    def lp(t):
        return flat(xp.concatenate([t["a"], t["b"][None]]) if xp is jnp
                    else torch.cat([t["a"], t["b"][None]]))
    return lp


def starts(form, dtype_np=np.float64, seed=0):
    block = np.random.RandomState(seed).randn(CHAINS, 3).astype(dtype_np)
    if form == "flat":
        return jnp.asarray(block), torch.as_tensor(block)
    return ({"a": jnp.asarray(block[:, :2]), "b": jnp.asarray(block[:, 2])},
            {"a": torch.as_tensor(block[:, :2]), "b": torch.as_tensor(block[:, 2])})


def jax_chees_noise(key, draws, c, d, dtype, start=0):
    """(z (S, C, D), log_u (S, C), u (S,)) of the JAX runner's draws."""

    def one(n):
        k_mom, k_jit, k_mh = jax.random.split(jax.random.fold_in(key, n), 3)
        z = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype))(jax.random.split(k_mom, c))
        return (z, jnp.log(jax.random.uniform(k_mh, (c,), dtype)),
                jax.random.uniform(k_jit, (), dtype))

    return tuple(torch.as_tensor(np.array(a)) for a in jax.vmap(one)(start + jnp.arange(draws)))


def short_schedule(n):
    """Two slow windows inside burn 50: [10, 25) and [25, 45)."""
    collect, end = np.zeros(n, bool), np.zeros(n, bool)
    collect[10:45] = True
    end[[24, 44]] = True
    return collect, end


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def moved(samples):
    """(N-1, C): which chains moved at each kept draw after the first."""
    parts = [np.asarray(l, np.float64).reshape(l.shape[0], l.shape[1], -1) for l in
             leaves(samples)]
    s = np.concatenate(parts, axis=-1)
    return np.any(s[:, 1:] != s[:, :-1], axis=-1).T


def to_np(x):
    """A tensor or JAX array on the host; bfloat16 as its float32 values."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return to_np(tree)


def assert_close(port, ref, rel):
    for a, b in zip(leaves(np_tree(port)), leaves(np_tree(ref))):
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def assert_runs_match(port, ref, rel):
    np.testing.assert_array_equal(port.info.num_leapfrog.numpy(), np.asarray(ref.info.num_leapfrog))
    np.testing.assert_array_equal(port.info.divergent.numpy(), np.asarray(ref.info.divergent))
    np.testing.assert_array_equal(moved(np_tree(port.samples)), moved(np_tree(ref.samples)))
    assert_close(port.samples, ref.samples, rel)
    for f in ("step_size", "trajectory_length"):
        np.testing.assert_allclose(getattr(port.info, f).numpy(),
                                   np.asarray(getattr(ref.info, f)), rtol=rel)
    np.testing.assert_allclose(port.info.accept_prob.numpy(), np.asarray(ref.info.accept_prob),
                               rtol=0, atol=rel)
    np.testing.assert_allclose(float(port.final_step_size), float(ref.final_step_size), rtol=rel)
    np.testing.assert_allclose(float(port.final_trajectory_length),
                               float(ref.final_trajectory_length), rtol=rel)
    metric_p = port.final_carry.metric
    metric_r = ref.final_carry.metric
    for a, b in zip(metric_p if isinstance(metric_p, tuple) else (metric_p,),
                    metric_r if isinstance(metric_r, tuple) else (metric_r,)):
        assert_close(a, b, rel)


def assert_inference_dicts_match(port, ref, rel):
    """``diagnostics.to_inference_dict`` of both results: the same names,
    shapes and dtypes, values within ``rel``."""
    from hamiltorch_tpu import diagnostics as jdiag
    from hamiltorch_tpu_torch import diagnostics as tdiag

    got, want = tdiag.to_inference_dict(port), jdiag.to_inference_dict(ref)
    for part in ("posterior", "sample_stats"):
        assert sorted(got[part]) == sorted(want[part])
        for name, w in want[part].items():
            g, w = got[part][name], np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=rel, atol=rel)


# (form, jitter, adapt_mass, thin, inv_mass)
F64_CASES = [
    ("flat", "uniform", False, 1, None),
    ("flat", "uniform", "diag", 1, SCALES**2),
    ("flat", "uniform", "dense", 1, None),
    ("flat", "halton", "diag", 1, None),
    ("flat", "uniform", "diag", 3, None),
    ("tree", "uniform", False, 1, "tree"),
    ("tree", "uniform", "diag", 1, None),
    ("tree", "halton", False, 1, None),
]


@pytest.mark.parametrize("form,jitter,adapt_mass,thin,inv_mass", F64_CASES,
                         ids=["-".join(map(str, c[:4])) + ("-mass" if c[4] is not None else "")
                              for c in F64_CASES])
def test_float64_adaptation_matches_jax(form, jitter, adapt_mass, thin, inv_mass):
    draws = 60
    cfg_kw = dict(num_samples=draws, step_size=0.1, burn=50, adapt_mass=adapt_mass,
                  trajectory_jitter=jitter, thin=thin, desired_accept_rate=0.95)
    collect, end = short_schedule(draws)
    with jax.enable_x64(True):
        key = jax.random.key(1)
        j_t0, t_t0 = starts(form)
        if form == "flat":
            j_lp, t_lp = flat_lp(jnp, jnp.float64), flat_lp(torch, torch.float64)
            j_mass = jmass.make_mass(None if inv_mass is None else jnp.asarray(inv_mass), 3)
            t_mass = tmass.make_mass(None if inv_mass is None else torch.as_tensor(inv_mass), 3)
        else:
            j_lp, t_lp = tree_lp(jnp, jnp.float64), tree_lp(torch, torch.float64)
            j_inv = t_inv = None
            if inv_mass == "tree":
                j_inv = {"a": jnp.asarray([1.0, 4.0]), "b": jnp.asarray(0.25)}
                t_inv = {"a": torch.tensor([1.0, 4.0], dtype=torch.float64),
                         "b": torch.tensor(0.25, dtype=torch.float64)}
            j_mass = jmass.make_diag_mass_tree(j_inv, jax.tree_util.tree_map(lambda l: l[0], j_t0),
                                               "ChEES ensembles")
            t_mass = tmass.make_diag_mass_tree(t_inv, {k: v[0] for k, v in t_t0.items()},
                                               "ChEES ensembles")
        ref = jch._run_chees_jit(key, j_t0, j_lp, jch.ChEESConfig(**cfg_kw), j_mass,
                                 collect_flags=jnp.asarray(collect), end_flags=jnp.asarray(end))
        noise = jax_chees_noise(key, draws, CHAINS, 3, jnp.float64)
        port = tch._run_chees(0, t_t0, t_lp, tch.ChEESConfig(**cfg_kw), t_mass,
                              collect_flags=collect, end_flags=end, _noise=noise)
    assert int(port.info.num_leapfrog.max()) > 1
    assert_runs_match(port, ref, 1e-10)
    if adapt_mass:  # the windows adopted an estimate
        metric = port.final_carry.metric
        adopted = metric[0] if adapt_mass == "dense" else metric
        seed = torch.ones(3, dtype=torch.float64) if inv_mass is None else torch.as_tensor(
            inv_mass)
        assert not torch.allclose(adopted if adapt_mass != "dense" else adopted.diagonal(), seed)


def test_run_chees_default_schedule_matches_jax_in_float64():
    """``run_chees`` with diagonal windowed warmup over Stan's schedule
    (burn 150: one slow window [75, 100)) and 10 draws after it."""
    cfg_kw = dict(num_samples=160, step_size=0.1, burn=150, adapt_mass=True,
                  desired_accept_rate=0.95)
    with jax.enable_x64(True):
        key = jax.random.key(2)
        j_t0, t_t0 = starts("flat", seed=1)
        ref = jch.run_chees(key, flat_lp(jnp, jnp.float64), j_t0, jch.ChEESConfig(**cfg_kw),
                            num_chains=CHAINS)
        noise = jax_chees_noise(key, 160, CHAINS, 3, jnp.float64)
        port = tht.run_chees(0, flat_lp(torch, torch.float64), t_t0, tch.ChEESConfig(**cfg_kw),
                             num_chains=CHAINS, _noise=noise)
    assert_runs_match(port, ref, 1e-10)
    assert_inference_dicts_match(port, ref, 1e-10)
    # frozen after burn: one step size and trajectory length from draw 151 on
    assert len(set(port.info.step_size[151:].tolist())) == 1
    assert len(set(port.info.trajectory_length[151:].tolist())) == 1


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_float32_without_adaptation_matches_jax(form):
    cfg_kw = dict(num_samples=30, step_size=0.3, adapt=False, init_trajectory_length=1.5)
    key = jax.random.key(3)
    j_t0, t_t0 = starts(form, np.float32, 2)
    lp = flat_lp if form == "flat" else tree_lp
    ref = jch.run_chees(key, lp(jnp, jnp.float32), j_t0, jch.ChEESConfig(**cfg_kw),
                        num_chains=CHAINS)
    noise = jax_chees_noise(key, 30, CHAINS, 3, jnp.float32)
    port = tht.run_chees(0, lp(torch, torch.float32), t_t0, tch.ChEESConfig(**cfg_kw),
                         num_chains=CHAINS, _noise=noise)
    np.testing.assert_array_equal(port.info.num_leapfrog.numpy(), np.asarray(ref.info.num_leapfrog))
    np.testing.assert_array_equal(moved(np_tree(port.samples)), moved(np_tree(ref.samples)))
    assert_close(port.samples, ref.samples, 1e-5)

    # the same run storing a bfloat16 trace
    bf = dict(cfg_kw, trace_dtype="bfloat16")
    ref_bf = jch.run_chees(key, lp(jnp, jnp.float32), j_t0, jch.ChEESConfig(**bf),
                           num_chains=CHAINS)
    port_bf = tht.run_chees(0, lp(torch, torch.float32), t_t0, tch.ChEESConfig(**bf),
                            num_chains=CHAINS, _noise=noise)
    for a, b in zip(leaves(port_bf.samples), leaves(port.samples)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    assert_close(port_bf.samples, ref_bf.samples, 2.0**-7)


def test_vdc_base2_matches_jax():
    ns = np.arange(2**16)
    want = np.asarray(jax.vmap(jch._vdc_base2)(jnp.asarray(ns, jnp.int32)))
    got = np.array([tch._vdc_base2(int(n)) for n in ns], np.float32)
    np.testing.assert_array_equal(got, want)
    # n + 1 ending in 24, 25 and 26 one bits reverses to 2**32 - 256 (exact
    # in float32), 2**32 - 128 and 2**32 - 64 (both round to 1.0)
    near = np.array([2**24 - 2, 2**25 - 2, 2**26 - 2, 2**31 - 2, 2**31 - 1 - 2**7,
                     2**30 + 2**25 - 2], np.int64)
    want = np.asarray(jax.vmap(jch._vdc_base2)(jnp.asarray(near, jnp.int32)))
    got = np.array([tch._vdc_base2(int(n)) for n in near], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] < 1.0 and got[1] == 1.0 and got[2] == 1.0
    # the JAX package's own test values: the radical inverse of 1..8
    np.testing.assert_array_equal([tch._vdc_base2(n) for n in range(8)],
                                  [0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875, 0.0625])


def test_overflowing_criterion_gradient_does_not_kill_adaptation():
    """Coordinates near 1e18 make the criterion's fourth-order product
    (~1e54) overflow float32 with both signs across chains; unmasked, the
    summed gradient would be NaN and log T NaN for the rest of the run.
    The port's guard keeps T finite, as the JAX package's does, draw for
    draw."""
    scale = 1e18
    cfg_kw = dict(num_samples=20, step_size=1e17, burn=15, init_trajectory_length=1e18)
    key = jax.random.key(4)
    block = (scale * np.random.RandomState(3).randn(CHAINS, 2)).astype(np.float32)

    def lp(xp):
        return lambda t: -0.5 * xp.sum((t / scale) ** 2)

    ref = jch.run_chees(key, lp(jnp), jnp.asarray(block), jch.ChEESConfig(**cfg_kw),
                        num_chains=CHAINS)
    noise = jax_chees_noise(key, 20, CHAINS, 2, jnp.float32)
    port = tht.run_chees(0, lp(torch), torch.as_tensor(block), tch.ChEESConfig(**cfg_kw),
                         num_chains=CHAINS, _noise=noise)
    assert bool(torch.isfinite(port.info.trajectory_length).all())
    assert bool(torch.isfinite(port.final_trajectory_length))
    assert np.isfinite(np.asarray(ref.info.trajectory_length)).all()
    np.testing.assert_array_equal(port.info.num_leapfrog.numpy(), np.asarray(ref.info.num_leapfrog))
    np.testing.assert_allclose(port.info.trajectory_length.numpy(),
                               np.asarray(ref.info.trajectory_length), rtol=1e-5)


def test_leapfrog_count_never_exceeds_the_cap():
    cfg = tch.ChEESConfig(num_samples=40, burn=20, step_size=0.001, init_trajectory_length=5.0,
                          max_leapfrog_steps=25)
    r = tht.run_chees(5, lambda t: -0.5 * torch.sum(t**2), torch.zeros(2), cfg, num_chains=8)
    assert r.info.num_leapfrog.shape == (40,)  # one L a draw, shared by the chains
    assert int(r.info.num_leapfrog.max()) == 25


def _raises(exc, match, *calls):
    for call in calls:
        with pytest.raises(exc, match=match):
            call()


def test_validation_raises_as_in_jax():
    j_lp, t_lp = (lambda t: -0.5 * jnp.sum(t**2)), (lambda t: -0.5 * torch.sum(t**2))
    key = jax.random.key(0)
    for jcfg, tcfg, kw, match in [
        (dict(num_samples=4, trajectory_jitter="Halton"), None, {}, "trajectory_jitter"),
        (dict(num_samples=10, thin=3), None, {}, "divisible by thin"),
        (dict(num_samples=8, burn=4, adapt_mass=True), None, {"dense": True}, "DIAGONAL"),
        (dict(num_samples=8, burn=4, adapt_mass="bogus"), None, {}, "adapt_mass"),
        (dict(num_samples=8, burn=4, adapt_mass="dense"), None, {"block": True},
         "block-diagonal"),
    ]:
        j_inv = t_inv = None
        if kw.get("dense"):
            j_inv, t_inv = jnp.eye(2) + 0.1, torch.eye(2) + 0.1
        if kw.get("block"):
            j_inv, t_inv = [jnp.eye(1), jnp.eye(1)], [torch.eye(1), torch.eye(1)]
        _raises(ValueError, match,
                lambda: jch.run_chees(key, j_lp, jnp.zeros(2), jch.ChEESConfig(**jcfg),
                                      num_chains=4, inv_mass=j_inv),
                lambda: tht.run_chees(0, t_lp, torch.zeros(2), tch.ChEESConfig(**jcfg),
                                      num_chains=4, inv_mass=t_inv))
    # configuration errors at construction
    for bad, match in [(dict(num_samples=0), "num_samples"), (dict(num_samples=4, step_size=0),
                                                              "step_size"),
                       (dict(num_samples=4, trace_dtype="int32"), "trace_dtype")]:
        _raises(ValueError, match, lambda: jch.ChEESConfig(**bad), lambda: tch.ChEESConfig(**bad))
    # tree states take diagonal metrics only
    cfg = dict(num_samples=8, burn=4, adapt_mass="dense")
    _raises(ValueError, "pytree",
            lambda: jch.run_chees(key, lambda t: -0.5 * jnp.sum(t["x"] ** 2),
                                  {"x": jnp.zeros(2)}, jch.ChEESConfig(**cfg), num_chains=4),
            lambda: tht.run_chees(0, lambda t: -0.5 * torch.sum(t["x"] ** 2),
                                  {"x": torch.zeros(2)}, tch.ChEESConfig(**cfg), num_chains=4))
    # the sharded ensemble's hooks: a mesh dimension name needs a mesh, and
    # chain_keys must be the batch's consecutive global indices
    with pytest.raises(ValueError, match="needs a mesh"):
        tch._run_chees(0, torch.zeros(4, 2), t_lp, tch.ChEESConfig(num_samples=2),
                       tmass.make_mass(None, 2), axis_name="chains")
    with pytest.raises(ValueError, match="consecutive"):
        tch._run_chees(0, torch.zeros(4, 2), t_lp, tch.ChEESConfig(num_samples=2),
                       tmass.make_mass(None, 2), chain_keys=[0, 2, 4, 6])


def test_single_start_is_spread_from_the_key():
    """A (D,) start (and an unstacked tree) is spread to the chains by
    0.01 N(0, 1) from the key's spread seed, the same on every call."""
    from hamiltorch_tpu_torch.utils.pytree import stack_param_tree
    from hamiltorch_tpu_torch.utils.rng import SPREAD_STREAM, draw_seed

    cfg = tch.ChEESConfig(num_samples=3, step_size=0.3)
    lp = flat_lp(torch, torch.float32)
    from_one = tht.run_chees(6, lp, torch.zeros(3), cfg, num_chains=5)
    _, spread = stack_param_tree(torch.zeros(3), 5, key=draw_seed(6, 0, SPREAD_STREAM),
                                 noise=0.01, stacked=False)
    stacked = tht.run_chees(6, lp, spread, cfg, num_chains=5)
    assert torch.equal(from_one.samples, stacked.samples)
    assert 0.0 < float(spread.std()) < 0.02
    tree = tht.run_chees(6, tree_lp(torch, torch.float32), {"a": torch.zeros(2),
                                                             "b": torch.zeros(())}, cfg,
                         num_chains=5)
    assert tree.samples["a"].shape == (5, 3, 2) and tree.samples["b"].shape == (5, 3)


def test_tree_matches_flat_per_draw():
    """A tree state and its flat layout draw the same momenta (drawn flat,
    split into leaves): without adaptation the runs agree draw for draw."""
    cfg = tch.ChEESConfig(num_samples=30, step_size=0.25, adapt=False)
    j, flat = starts("flat", np.float64, 4)
    _, tree = starts("tree", np.float64, 4)
    r_flat = tht.run_chees(7, flat_lp(torch, torch.float64), flat, cfg, num_chains=CHAINS)
    r_tree = tht.run_chees(7, tree_lp(torch, torch.float64), tree, cfg, num_chains=CHAINS)
    torch.testing.assert_close(r_tree.samples["a"], r_flat.samples[:, :, :2], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(r_tree.samples["b"], r_flat.samples[:, :, 2], rtol=1e-12,
                               atol=1e-12)


def test_correlated_gaussian_moments_and_acceptance():
    """``tests/test_chees.py``'s correlated 2-D Gaussian: 16 chains, burn
    500 of 1200 draws; pooled moments of the second half and the post-burn
    acceptance within its gates (0.45 < mean < 0.9)."""
    prec = torch.linalg.inv(torch.as_tensor(COV, dtype=torch.float32))
    cfg = tch.ChEESConfig(num_samples=1200, step_size=0.3, burn=500)
    r = tht.run_chees(8, lambda t: -0.5 * t @ prec @ t, torch.zeros(2), cfg, num_chains=16)
    assert r.samples.shape == (16, 1200, 2)
    pooled = r.samples[:, 600:].reshape(-1, 2).double().numpy()
    np.testing.assert_allclose(pooled.mean(0), [0, 0], atol=0.1)
    np.testing.assert_allclose(np.cov(pooled.T), COV, atol=0.12)
    post = float(r.info.accept_prob[700:].mean())
    assert 0.45 < post < 0.9


def test_progress_lines_change_no_draw(capsys, monkeypatch):
    """``progress_every`` prints a bar line every N draws through
    ``utils/progress.py`` and leaves the draws as they are."""
    import re

    from hamiltorch_tpu_torch.utils import progress

    monkeypatch.setattr(progress, "_REFRESH", -1.0)  # a line at every update
    lp = flat_lp(torch, torch.float32)
    cfg = tch.ChEESConfig(num_samples=12, step_size=0.3, burn=4, thin=2)
    plain = tht.run_chees(9, lp, torch.zeros(3), cfg, num_chains=4)
    capsys.readouterr()
    shown = tht.run_chees(9, lp, torch.zeros(3), tch.ChEESConfig(
        num_samples=12, step_size=0.3, burn=4, thin=2, progress_every=5), num_chains=4)
    assert torch.equal(shown.samples, plain.samples)
    out = capsys.readouterr().out
    assert out.startswith("Sampling\n")
    assert re.findall(r"\| +(\d+)/12 \|", out) == ["0", "5", "10", "11"]
