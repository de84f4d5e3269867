"""Port vs JAX package: parallel tempering (``samplers/tempering.py``).

The port runs on the JAX sampler's own randomness, replayed: draw ``n`` of
a ladder splits ``fold_in(key, n)`` three ways into the momentum key (split
K ways, one ``mass.sample`` normal a replica), the Metropolis key (K
uniforms) and the swap key (K uniforms, the lower index of each pair used);
``run_pt_chains`` first splits the key once per ensemble.  They go into the
port's ``_noise={"z", "u_mh", "u_swap"}``.  Both packages get the same numpy
starts.

* Float32 over 20 draws, K = 3 and 4, flat (identity, diagonal and dense
  mass) and two-leaf tree states, one ladder and E = 2 ensembles: identical
  swap outcomes, positions, acceptance and ladder within 1e-5 relative,
  and every Metropolis and swap decision at least 1e-4 from its other
  outcome (the port's ``_margins`` hook).
* Float64 (``jax.enable_x64``) with dual averaging and ladder adaptation
  across ``burn``: within 1e-10 (at an acceptance target of 0.95, where
  dual averaging does not amplify rounding; see the test).
* ``run_pt_chains`` equals E single ladders given the same noise; the
  validation errors of ``tests/test_tempering.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import tempering as jpt
from hamiltorch_tpu_torch.samplers import tempering as tpt

MARGIN = 1e-4
D = 3


def mixture_lp(xp):
    """Two modes at +-1.5 with scale 0.6, and a sine ripple."""
    if xp is jnp:
        lae = jnp.logaddexp
        def total(t): return jnp.sum(t)  # noqa: E704
    else:
        lae = torch.logaddexp
        def total(t): return torch.sum(t)  # noqa: E704

    def lp(t):
        return lae(-0.5 * total(((t - 1.5) / 0.6) ** 2),
                   -0.5 * total(((t + 1.5) / 0.6) ** 2)) + 0.05 * total(xp.sin(t))
    return lp


def tree_lp(xp):
    """The mixture on {"a": (2,), "b": ()}: leaf order a, b."""
    flat = mixture_lp(xp)

    def lp(t):
        if xp is jnp:
            return flat(jnp.concatenate([t["a"], t["b"][None]]))
        return flat(torch.cat([t["a"], t["b"][None]]))
    return lp


def jax_pt_noise(key, draws, k, d, dtype, ensembles=None, start=0):
    """The JAX runner's draws as the port's ``_noise``: (S, [E,] K, D)
    normals and (S, [E,] K) uniforms."""

    def one(kk, n):
        k_mom, k_mh, k_swap = jax.random.split(jax.random.fold_in(kk, n), 3)
        z = jax.vmap(lambda km: jax.random.normal(km, (d,), dtype))(jax.random.split(k_mom, k))
        return (z, jax.random.uniform(k_mh, (k,), dtype), jax.random.uniform(k_swap, (k,), dtype))

    ns = start + jnp.arange(draws)
    if ensembles is None:
        out = jax.vmap(lambda n: one(key, n))(ns)
    else:
        keys = jax.random.split(key, ensembles)
        out = jax.vmap(lambda n: jax.vmap(lambda kk: one(kk, n))(keys))(ns)
    return {name: torch.as_tensor(np.array(a)) for name, a in zip(("z", "u_mh", "u_swap"), out)}


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


def assert_pt_match(port, ref, rel):
    np.testing.assert_array_equal(port.info.swap_accept.numpy(), np.asarray(ref.info.swap_accept))
    assert_close(port.replica_samples, ref.replica_samples, rel)
    assert_close(port.samples, ref.samples, rel)
    np.testing.assert_allclose(port.info.accept_prob.numpy(), np.asarray(ref.info.accept_prob),
                               rtol=0, atol=rel)
    for f in ("betas", "swap_rate_ema", "step_sizes"):
        np.testing.assert_allclose(getattr(port.info, f).numpy(),
                                   np.asarray(getattr(ref.info, f)), rtol=rel, atol=0)
    carry_p, carry_r = port.final_carry, ref.final_carry
    np.testing.assert_allclose(carry_p.s.numpy(), np.asarray(carry_r.s), rtol=rel, atol=rel)
    assert_close(carry_p.logps, carry_r.logps, rel)
    assert_close(carry_p.grads, carry_r.grads, rel)


def starts(form, k, dtype, seed=0, ensembles=None):
    """numpy starts: (K, D) per replica (or (E, K, D)), or the tree split."""
    lead = (k,) if ensembles is None else (ensembles, k)
    block = (1.2 * np.random.RandomState(seed).randn(*lead, D)).astype(dtype)
    if form == "flat":
        return jnp.asarray(block), torch.as_tensor(block)
    return ({"a": jnp.asarray(block[..., :2]), "b": jnp.asarray(block[..., 2])},
            {"a": torch.as_tensor(block[..., :2]), "b": torch.as_tensor(block[..., 2])})


def inv_masses(kind, dtype):
    """(JAX, port) inv_mass of each kind."""
    if kind is None:
        return None, None
    if kind == "diag":
        m = np.array([1.0, 0.6, 1.4], dtype)
    elif kind == "dense":
        m = np.array([[1.0, 0.3, 0.0], [0.3, 0.8, 0.1], [0.0, 0.1, 1.2]], dtype)
    else:  # a tree of per-leaf diagonals
        return ({"a": jnp.asarray(np.array([1.0, 0.6], dtype)), "b": jnp.asarray(dtype(1.4))},
                {"a": torch.as_tensor(np.array([1.0, 0.6], dtype)),
                 "b": torch.as_tensor(dtype(1.4))})
    return jnp.asarray(m), torch.as_tensor(m)


def run_both(form, k, cfg_kw, inv, dtype, ensembles=None, seed=0):
    cfg_j, cfg_t = jpt.PTConfig(**cfg_kw), tpt.PTConfig(**cfg_kw)
    j_t0, t_t0 = starts(form, k, dtype, seed, ensembles)
    j_inv, t_inv = inv_masses(inv, dtype)
    xp_lp = mixture_lp if form == "flat" else tree_lp
    key = jax.random.key(seed + 11)
    noise = jax_pt_noise(key, cfg_kw["num_samples"], k, D, jnp.dtype(dtype), ensembles)
    margins = []
    if ensembles is None:
        ref = jpt.run_parallel_tempering(key, xp_lp(jnp), j_t0, cfg_j, inv_mass=j_inv)
        port = tpt.run_parallel_tempering(0, xp_lp(torch), t_t0, cfg_t, inv_mass=t_inv,
                                          _noise=noise, _margins=margins)
    else:
        ref = jpt.run_pt_chains(key, xp_lp(jnp), j_t0, cfg_j, ensembles, inv_mass=j_inv)
        port = tpt.run_pt_chains(0, xp_lp(torch), t_t0, cfg_t, ensembles, inv_mass=t_inv,
                                 _noise=noise, _margins=margins)
    return port, ref, margins, noise


# (form, K, inv_mass, ensembles)
F32_CASES = [
    ("flat", 3, None, None),
    ("flat", 4, "diag", None),
    ("flat", 4, "dense", None),
    ("tree", 3, "tree", None),
    ("flat", 3, None, 2),
    ("tree", 4, None, 2),
]


@pytest.mark.parametrize("form,k,inv,ens", F32_CASES,
                         ids=[f"{c[0]}-K{c[1]}-{c[2]}-E{c[3]}" for c in F32_CASES])
def test_float32_matches_jax(form, k, inv, ens):
    cfg_kw = dict(num_samples=20, num_steps_per_sample=4, step_size=0.25, num_temps=k,
                  max_temp=12.0, burn=5)
    port, ref, margins, _ = run_both(form, k, cfg_kw, inv, np.float32, ens)
    assert min(float(m) for m in margins) >= MARGIN
    assert_pt_match(port, ref, 1e-5)
    # both outcomes of both decisions occur
    swaps = port.info.swap_accept.numpy()
    acc = port.info.accept_prob.numpy()
    assert swaps.any() and not swaps.all()
    assert (acc < 1.0).any()


# (form, K, inv_mass, ensembles)
F64_CASES = [
    ("flat", 3, None, None),
    ("flat", 4, "diag", None),
    ("tree", 4, "tree", None),
    ("flat", 4, None, 2),
    ("tree", 3, None, 2),
]


@pytest.mark.parametrize("form,k,inv,ens", F64_CASES,
                         ids=[f"{c[0]}-K{c[1]}-{c[2]}-E{c[3]}" for c in F64_CASES])
def test_float64_adaptation_matches_jax(form, k, inv, ens):
    """Dual averaging and ladder adaptation across burn (frozen at draw 25).
    The runs target an acceptance of 0.95: dual averaging feeds each draw's
    acceptance back into the step size, and near an acceptance of 1 a
    last-bit difference (XLA's exp and log, the order of a sum) stays at
    rounding level, while at 0.9 the feedback grows it past 1e-10 within
    these draws (as in tests/test_torch_chees.py)."""
    cfg_kw = dict(num_samples=40, num_steps_per_sample=4, step_size=0.25, num_temps=k,
                  max_temp=12.0, burn=25, adapt_ladder=True, adapt_step_size=True,
                  desired_accept_rate=0.95)
    with jax.enable_x64(True):
        port, ref, margins, _ = run_both(form, k, cfg_kw, inv, np.float64, ens, seed=1)
    assert_pt_match(port, ref, 1e-10)
    assert port.samples is not None and port.info.betas.dtype == torch.float64


@pytest.mark.parametrize("ens", [None, 3])
def test_float64_dual_averaging_amplifies_a_last_bit_difference(ens):
    """Why the float64 comparisons target an acceptance of 0.95, shown on
    the CPU alone: the same run with the potential's sums taken in reverse
    order (a last-bit difference an evaluation, as another device's
    reductions make) keeps every swap and accept, but at the default target
    of 0.8 dual averaging feeds the difference back into the step sizes
    and the positions drift apart past 1e-10 of max |theta|, while at 0.95
    they stay within 1e-11."""
    k, draws = 4, 40
    lead = (draws,) if ens is None else (draws, ens)
    rng = np.random.RandomState(8)
    noise = {"z": torch.as_tensor(rng.randn(*lead, k, D)),
             "u_mh": torch.as_tensor(rng.rand(*lead, k)),
             "u_swap": torch.as_tensor(rng.rand(*lead, k))}
    start = torch.as_tensor(rng.randn(*lead[1:], k, D))
    lp = mixture_lp(torch)

    def rsum(t):
        return torch.sum(t.flip(-1))

    def lp_reversed(t):
        return (torch.logaddexp(-0.5 * rsum(((t - 1.5) / 0.6) ** 2),
                                -0.5 * rsum(((t + 1.5) / 0.6) ** 2)) + 0.05 * rsum(torch.sin(t)))

    drift = {}
    for target in (0.8, 0.95):
        cfg = tpt.PTConfig(num_samples=draws, num_steps_per_sample=4, step_size=0.25,
                           num_temps=k, max_temp=12.0, burn=25, adapt_ladder=True,
                           adapt_step_size=True, desired_accept_rate=target)
        a, b = (tpt.run_parallel_tempering(0, f, start, cfg, _noise=noise) if ens is None
                else tpt.run_pt_chains(0, f, start, cfg, ens, _noise=noise)
                for f in (lp, lp_reversed))
        assert torch.equal(a.info.swap_accept, b.info.swap_accept)
        ra, rb = a.replica_samples, b.replica_samples
        assert torch.equal(ra[..., 1:, :, :] != ra[..., :-1, :, :],
                           rb[..., 1:, :, :] != rb[..., :-1, :, :])
        drift[target] = float((ra - rb).abs().max()) / float(ra.abs().max())
    assert drift[0.8] > 1e-10 and drift[0.95] < 1e-11, drift


def test_ensembles_equal_single_ladders_on_the_same_noise():
    """run_pt_chains' E ladders, one batch of E*K lanes, are E single
    ladders run one by one on each ensemble's noise."""
    cfg = tpt.PTConfig(num_samples=15, num_steps_per_sample=3, step_size=0.3, num_temps=3,
                       burn=6, adapt_ladder=True, adapt_step_size=True)
    gen = torch.Generator().manual_seed(3)
    noise = {"z": torch.randn(15, 2, 3, D, generator=gen),
             "u_mh": torch.rand(15, 2, 3, generator=gen),
             "u_swap": torch.rand(15, 2, 3, generator=gen)}
    start = torch.randn(2, 3, D, generator=gen)
    lp = mixture_lp(torch)
    both = tpt.run_pt_chains(0, lp, start, cfg, 2, _noise=noise)
    for e in range(2):
        one = tpt.run_parallel_tempering(0, lp, start[e], cfg,
                                         _noise={k: v[:, e] for k, v in noise.items()})
        assert torch.equal(both.replica_samples[e], one.replica_samples)
        assert torch.equal(both.info.swap_accept[e], one.info.swap_accept)
        assert torch.equal(both.info.betas[e], one.info.betas)
        assert torch.equal(both.info.step_sizes[e], one.info.step_sizes)
    # the port's own noise: ensemble 0 is the single ladder run with the key
    assert torch.equal(tpt.run_pt_chains(5, lp, start, cfg, 2).replica_samples[0],
                       tpt.run_parallel_tempering(5, lp, start[0], cfg).replica_samples)


def test_betas_from_log_gaps_and_partners():
    for k in (2, 3, 4, 5):
        s = np.random.RandomState(k).randn(k - 1).astype(np.float32)
        np.testing.assert_allclose(
            tpt.betas_from_log_gaps(torch.as_tensor(s), 30.0).numpy(),
            np.asarray(jpt.betas_from_log_gaps(jnp.asarray(s), 30.0)), rtol=1e-6)
        b = tpt.betas_from_log_gaps(torch.as_tensor(s), 30.0)
        assert float(b[0]) == 1.0 and abs(float(b[-1]) - 1 / 30) < 1e-7
        for parity in (0, 1):
            partner, pair_lo, attempted = tpt.swap_partners(k, "cpu")[parity]
            assert torch.equal(partner[partner], torch.arange(k))  # an involution
            assert torch.equal(pair_lo, torch.minimum(torch.arange(k), partner))
            assert attempted.tolist() == [bool(partner[i] == i + 1) for i in range(k - 1)]
            # even draws pair (0,1),(2,3),..., odd draws (1,2),(3,4),...
            assert attempted.tolist() == [i % 2 == parity for i in range(k - 1)]


def test_default_noise_is_chunk_reproducible_and_keyed():
    cfg = tpt.PTConfig(num_samples=12, num_steps_per_sample=3, step_size=0.3, num_temps=4)
    lp = mixture_lp(torch)
    a = tpt.run_parallel_tempering(7, lp, torch.zeros(D), cfg)
    b = tpt.run_parallel_tempering(7, lp, torch.zeros(D), cfg)
    c = tpt.run_parallel_tempering(8, lp, torch.zeros(D), cfg)
    assert torch.equal(a.replica_samples, b.replica_samples)
    assert not torch.equal(a.replica_samples, c.replica_samples)
    assert torch.isfinite(a.replica_samples).all()


def test_validation_errors():
    lp = lambda t: -0.5 * torch.sum(t ** 2)  # noqa: E731
    with pytest.raises(ValueError, match="replicas"):
        tpt.run_parallel_tempering(0, lp, torch.zeros(4, 2), tpt.PTConfig(num_samples=8,
                                                                           num_temps=8))
    with pytest.raises(ValueError, match="replicas"):
        tpt.run_pt_chains(0, lp, torch.zeros(3, 4, 2), tpt.PTConfig(num_samples=8, num_temps=8),
                          num_ensembles=3)
    with pytest.raises(RuntimeError, match="burn"):
        tpt.run_parallel_tempering(0, lp, torch.zeros(2), tpt.PTConfig(num_samples=50, burn=50))
    with pytest.raises(RuntimeError, match="burn"):
        tpt.run_pt_chains(0, lp, torch.zeros(2), tpt.PTConfig(num_samples=50, burn=50), 2)
    t0 = {"a": torch.zeros(1), "b": torch.zeros(2, 1)}
    tlp = lambda t: -0.5 * torch.sum(t["a"] ** 2) - 0.5 * torch.sum(t["b"] ** 2)  # noqa: E731
    with pytest.raises(ValueError, match="diagonal"):
        tpt.run_parallel_tempering(0, tlp, t0, tpt.PTConfig(num_samples=10, num_temps=4),
                                   inv_mass=torch.eye(3))
    with pytest.raises(ValueError, match="diagonal"):
        tpt.run_pt_chains(0, tlp, t0, tpt.PTConfig(num_samples=10, num_temps=4), 2,
                          inv_mass=torch.eye(3))
    with pytest.raises(ValueError, match="step_size"):
        tpt.PTConfig(num_samples=10, step_size=0.0)


def test_k_stacked_tree_broadcasts_the_ensemble_axis_only():
    """A per-replica (K, ...) tree through run_pt_chains: every ensemble
    starts from the same K replica states (as tests/test_tempering.py
    pins it)."""
    k = 4
    t0 = {"x": torch.arange(k, dtype=torch.float32)[:, None] * torch.ones(k, 2)}
    cfg = tpt.PTConfig(num_samples=3, num_steps_per_sample=2, step_size=0.1, num_temps=k)
    stacked, _ = tpt._pt_ensemble_stack(t0, cfg, 3, None)
    assert stacked["x"].shape == (3, k, 2)
    for e in range(3):
        assert torch.equal(stacked["x"][e], t0["x"])
    r = tpt.run_pt_chains(0, lambda t: -0.5 * torch.sum(t["x"] ** 2), t0, cfg, 3)
    assert r.replica_samples["x"].shape == (3, 3, k, 2)


def test_progress_lines(capsys, monkeypatch):
    from hamiltorch_tpu_torch.utils import progress

    monkeypatch.setattr(progress, "_REFRESH", -1)
    cfg = tpt.PTConfig(num_samples=6, num_steps_per_sample=2, step_size=0.2, num_temps=3,
                       progress_every=2)
    tpt.run_parallel_tempering(0, lambda t: -0.5 * torch.sum(t ** 2), torch.zeros(2), cfg)
    assert "Samples" in capsys.readouterr().out
