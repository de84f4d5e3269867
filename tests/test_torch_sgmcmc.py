"""Port vs JAX package: stochastic-gradient MCMC (``samplers/sgmcmc.py``):
SGLD (constant and decaying step), pSGLD, SGHMC with and without momentum
refresh, cSGLD / cSGHMC, single chains and batched chains, flat and tree
states, the ``data`` operand, the split-model ``term_fn`` protocol,
bfloat16 chains and rejected non-finite steps.

The port runs on the JAX samplers' own randomness, replayed: step ``g`` of a
chain keyed ``k`` splits ``fold_in(k, g)`` into the minibatch key (the term
``randint``), the noise key (``_leaf_noise``) and, for SGHMC, the refresh
key; chains take ``split(key, C)[c]``.  The replay goes into the port's
``_noise={"m", "z", "fresh"}``.

Tolerances: float64 runs at a constant step size agree within 1e-12 of the
largest |theta| (the update is the same arithmetic; the gradients sum in
another order).  XLA's float32 ``cos`` and ``pow`` differ from PyTorch's in
the last bits, so the decaying and the cyclical schedules' step sizes agree
within 5e-7 relative (4 float32 ulps; for the cyclical schedule, whose
cosine nears -1 at a cycle's end, or within 5e-7 of ``step_size``) and
those runs' float64 states within 1e-6 of their largest |entry|.  Gradient norms are float32 sums in
another order: 1e-6 relative.  Float32 runs agree within 1e-5 of the
largest |theta|.  Bfloat16 SGLD rounds once a step (its update runs in
float32 in both packages): within one bfloat16 ulp (2**-7 relative).
Bfloat16 SGHMC rounds every operation to bfloat16 in PyTorch while XLA
keeps a fusion's intermediates in float32: within four ulps (2**-5
relative) over its 20 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import sgmcmc as jsg
from hamiltorch_tpu_torch.samplers import sgmcmc as tsg

M = 4
MU = np.array([1.0, -2.0, 0.5])
S2 = np.array([0.5, 1.0, 2.0])
DELTA = np.array([[1.0, -1.0, 0.5], [-1.0, 1.0, -0.5], [0.5, 0.5, 1.0], [-0.5, -0.5, -1.0]])
CS = MU + DELTA  # term centres averaging to MU: genuinely noisy minibatch gradients


def consts(xp, dtype):
    if xp is jnp:
        return jnp.asarray(CS, dtype), jnp.asarray(S2, dtype)
    return torch.as_tensor(CS, dtype=dtype), torch.as_tensor(S2, dtype=dtype)


def flat_term(xp, dtype):
    cs, s2 = consts(xp, dtype)

    def term(t, m):
        return -0.125 * xp.sum((t - cs[m]) ** 2 / s2) + 0.05 * xp.sum(xp.sin(t))
    return term


def tree_term(xp, dtype):
    """The flat term over the tree {"a": (), "b": (2,)}."""
    cs, s2 = consts(xp, dtype)

    def term(t, m):
        return -0.125 * (xp.sum((t["a"] - cs[m][0]) ** 2 / s2[0])
                         + xp.sum((t["b"] - cs[m][1:]) ** 2 / s2[1:])) \
            + 0.05 * (xp.sum(xp.sin(t["a"])) + xp.sum(xp.sin(t["b"])))
    return term


def data_term(xp):
    """The flat term with its centres and scales passed as the data operand."""
    def term(t, m, d):
        return -0.125 * xp.sum((t - d["cs"][m]) ** 2 / d["s2"])
    return term


def start(form, xp, dtype, seed=0):
    v = np.random.RandomState(seed).randn(3) * 0.5 + MU
    if xp is jnp:
        arr = jnp.asarray(v, dtype)
        return arr if form == "flat" else {"a": arr[0], "b": arr[1:]}
    arr = torch.as_tensor(v, dtype=dtype)
    return arr if form == "flat" else {"a": arr[0], "b": arr[1:]}


def jax_noise(key, kind, steps, template, chains=None, num_terms=M):
    """The JAX runner's draws: {"m": (S[, C]), "z", "fresh": (S[, C], ...)
    leaves} for steps 0..steps-1."""
    sghmc = kind == "sghmc"

    def one(k, g):
        kk = jax.random.fold_in(k, g)
        if sghmc:
            k_batch, k_noise, k_mom = jax.random.split(kk, 3)
        else:
            k_batch, k_noise = jax.random.split(kk)
            k_mom = k_noise
        m = jax.random.randint(k_batch, (), 0, num_terms)
        return m, jsg._leaf_noise(k_noise, template), jsg._leaf_noise(k_mom, template)

    def run(k):
        return jax.vmap(lambda g: one(k, g))(jnp.arange(steps))

    if chains is None:
        out = run(key)
    else:
        out = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1),
                                     jax.vmap(run)(jax.random.split(key, chains)))
    m, z, fresh = jax.tree_util.tree_map(to_torch, out)
    return {"m": m, "z": z, "fresh": fresh}


def to_torch(a):
    """A JAX array as a CPU tensor (bfloat16 through its float32 values, exact)."""
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.as_tensor(np.array(a))


def leaves(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def assert_trees_close(port, ref, rel):
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (err, scale)


def assert_result_matches(port, ref, rel, eps_rtol=0.0, eps_atol=0.0):
    assert_trees_close(port.samples, ref.samples, rel)
    assert_trees_close(port.final_theta, ref.final_theta, rel)
    if ref.final_aux is not None:
        assert_trees_close(port.final_aux, ref.final_aux, max(rel, 1e-12))
    np.testing.assert_allclose(to_np(port.stats.step_size), to_np(ref.stats.step_size),
                               rtol=eps_rtol, atol=eps_atol)
    np.testing.assert_allclose(to_np(port.stats.grad_norm), to_np(ref.stats.grad_norm),
                               rtol=1e-6)
    np.testing.assert_array_equal(to_np(port.stats.divergent), to_np(ref.stats.divergent))


SGLD_CASES = {
    "constant": dict(num_samples=24, step_size=0.02),
    "decay": dict(num_samples=24, step_size=0.05, decay_gamma=0.55, decay_t0=10.0),
    "rmsprop": dict(num_samples=24, step_size=0.01, preconditioner="rmsprop", rmsprop_eps=1e-2),
    "thin_cold": dict(num_samples=24, step_size=0.02, thin=4, temperature=0.5),
}


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("case", list(SGLD_CASES) + ["inv_mass"])
def test_sgld_matches_jax_step_for_step(case, form):
    cfg_kw = SGLD_CASES.get(case, SGLD_CASES["constant"])
    with jax.enable_x64(True):
        key = jax.random.key(3)
        j_t0, t_t0 = start(form, jnp, jnp.float64), start(form, torch, torch.float64)
        j_term = (flat_term if form == "flat" else tree_term)(jnp, jnp.float64)
        t_term = (flat_term if form == "flat" else tree_term)(torch, torch.float64)
        j_mass = t_mass = None
        if case == "inv_mass":
            j_mass = jnp.asarray(S2) if form == "flat" else {"a": 0.5, "b": jnp.asarray(S2[1:])}
            t_mass = torch.as_tensor(S2) if form == "flat" else {"a": 0.5,
                                                                 "b": torch.as_tensor(S2[1:])}
        ref = jsg.run_sgld(key, j_term, M, j_t0, jsg.SGLDConfig(**cfg_kw), inv_mass=j_mass)
        noise = jax_noise(key, "sgld", cfg_kw["num_samples"], j_t0)
        port = tsg.run_sgld(0, t_term, M, t_t0, tsg.SGLDConfig(**cfg_kw), inv_mass=t_mass,
                            _noise=noise)
    decaying = case == "decay"
    assert_result_matches(port, ref, 1e-6 if decaying else 1e-12, 5e-7 if decaying else 0.0)
    assert int(port.final_step) == int(ref.final_step) == cfg_kw["num_samples"]


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("every,pre", [(0, False), (7, False), (5, True)])
def test_sghmc_matches_jax_step_for_step(every, pre, form):
    cfg = dict(num_samples=30, step_size=0.01, friction=0.1, thin=3,
               resample_momentum_every=every)
    with jax.enable_x64(True):
        key = jax.random.key(4)
        j_t0, t_t0 = start(form, jnp, jnp.float64, 1), start(form, torch, torch.float64, 1)
        j_term = (flat_term if form == "flat" else tree_term)(jnp, jnp.float64)
        t_term = (flat_term if form == "flat" else tree_term)(torch, torch.float64)
        j_mass = t_mass = None
        if pre:
            j_mass = jnp.asarray(S2) if form == "flat" else {"a": 0.5, "b": jnp.asarray(S2[1:])}
            t_mass = torch.as_tensor(S2) if form == "flat" else {"a": 0.5,
                                                                 "b": torch.as_tensor(S2[1:])}
        ref = jsg.run_sghmc(key, j_term, M, j_t0, jsg.SGHMCConfig(**cfg), inv_mass=j_mass)
        noise = jax_noise(key, "sghmc", cfg["num_samples"], j_t0)
        port = tsg.run_sghmc(0, t_term, M, t_t0, tsg.SGHMCConfig(**cfg), inv_mass=t_mass,
                             _noise=noise)
    assert_result_matches(port, ref, 1e-12)


@pytest.mark.parametrize("kind", ["sgld", "psgld", "sghmc"])
def test_chains_with_the_data_operand_match_jax(kind):
    """Three chains each drawing their own term every step (the port groups
    them by term), the centres passed as ``data``."""
    chains, steps = 3, 16
    with jax.enable_x64(True):
        key = jax.random.key(5)
        j_data = {"cs": jnp.asarray(CS), "s2": jnp.asarray(S2)}
        t_data = {"cs": torch.as_tensor(CS), "s2": torch.as_tensor(S2)}
        j_t0 = jnp.asarray(np.random.RandomState(2).randn(chains, 3))
        t_t0 = torch.as_tensor(np.array(j_t0))
        if kind == "sghmc":
            cfg = dict(num_samples=steps, step_size=0.01, friction=0.2, thin=2)
            ref = jsg.run_sghmc_chains(key, data_term(jnp), M, j_t0, jsg.SGHMCConfig(**cfg),
                                       chains, data=j_data)
            noise = jax_noise(key, kind, steps, j_t0[0], chains)
            port = tsg.run_sghmc_chains(0, data_term(torch), M, t_t0, tsg.SGHMCConfig(**cfg),
                                        chains, data=t_data, _noise=noise)
        else:
            cfg = dict(num_samples=steps, step_size=0.02, thin=2,
                       preconditioner="rmsprop" if kind == "psgld" else "none")
            ref = jsg.run_sgld_chains(key, data_term(jnp), M, j_t0, jsg.SGLDConfig(**cfg),
                                      chains, data=j_data)
            noise = jax_noise(key, kind, steps, j_t0[0], chains)
            port = tsg.run_sgld_chains(0, data_term(torch), M, t_t0, tsg.SGLDConfig(**cfg),
                                       chains, data=t_data, _noise=noise)
    assert len({tuple(row.tolist()) for row in noise["m"]}) > 1  # the chains' terms differ
    assert port.samples.shape == (chains, steps // 2, 3)
    assert_result_matches(port, ref, 1e-12)
    np.testing.assert_array_equal(port.final_step.numpy(), np.asarray(ref.final_step))
    assert_inference_dicts_match(port, ref, 1e-6)  # grad_norm is a float32 sum


@pytest.mark.parametrize("base", ["sgld", "sghmc"])
@pytest.mark.parametrize("form", ["flat", "tree"])
def test_cyclical_matches_jax_step_for_step(base, form):
    cfg = dict(num_cycles=3, cycle_length=12, step_size=0.05, exploration_frac=0.5, thin=2,
               base=base, friction=0.1)
    steps = 36
    with jax.enable_x64(True):
        key = jax.random.key(6)
        j_t0, t_t0 = start(form, jnp, jnp.float64, 2), start(form, torch, torch.float64, 2)
        j_term = (flat_term if form == "flat" else tree_term)(jnp, jnp.float64)
        t_term = (flat_term if form == "flat" else tree_term)(torch, torch.float64)
        ref = jsg.run_csgmcmc(key, j_term, M, j_t0, jsg.CSGMCMCConfig(**cfg))
        noise = jax_noise(key, "csgmcmc", steps, j_t0)
        port = tsg.run_csgmcmc(0, t_term, M, t_t0, tsg.CSGMCMCConfig(**cfg), _noise=noise)
    assert_result_matches(port, ref, 1e-6, 5e-7, 5e-7 * cfg["step_size"])
    np.testing.assert_array_equal(port.cycle.numpy(), np.asarray(ref.cycle))
    assert (port.final_aux is None) == (base == "sgld")


def test_cyclical_chains_with_inv_mass_match_jax():
    cfg = dict(num_cycles=2, cycle_length=10, step_size=0.05, exploration_frac=0.3, thin=7)
    chains = 2
    with jax.enable_x64(True):
        key = jax.random.key(7)
        j_t0 = jnp.asarray(MU)
        ref = jsg.run_csgmcmc_chains(key, flat_term(jnp, jnp.float64), M, j_t0,
                                     jsg.CSGMCMCConfig(**cfg), chains, inv_mass=jnp.asarray(S2))
        noise = jax_noise(key, "csgmcmc", 20, j_t0, chains)
        port = tsg.run_csgmcmc_chains(0, flat_term(torch, torch.float64), M,
                                      torch.as_tensor(MU), tsg.CSGMCMCConfig(**cfg), chains,
                                      inv_mass=torch.as_tensor(S2), _noise=noise)
    assert port.samples.shape == (chains, 2, 3) and port.cycle.shape == (chains, 2)
    assert_result_matches(port, ref, 1e-6, 5e-7, 5e-7 * cfg["step_size"])
    np.testing.assert_array_equal(port.cycle.numpy(), np.asarray(ref.cycle))
    assert_inference_dicts_match(port, ref, 1e-6)


def assert_inference_dicts_match(port, ref, rel):
    """``diagnostics.to_inference_dict`` of both results: the same names,
    shapes and dtypes (the cycle tag included), values within ``rel``."""
    from hamiltorch_tpu import diagnostics as jdiag
    from hamiltorch_tpu_torch import diagnostics as tdiag

    got, want = tdiag.to_inference_dict(port), jdiag.to_inference_dict(ref)
    for part in ("posterior", "sample_stats"):
        assert sorted(got[part]) == sorted(want[part])
        for name, w in want[part].items():
            g, w = got[part][name], np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=rel, atol=rel)


def test_float32_sgld_and_sghmc_match_jax():
    key = jax.random.key(8)
    j_t0, t_t0 = start("flat", jnp, jnp.float32), start("flat", torch, torch.float32)
    cfg = dict(num_samples=40, step_size=0.02)
    ref = jsg.run_sgld(key, flat_term(jnp, jnp.float32), M, j_t0, jsg.SGLDConfig(**cfg))
    port = tsg.run_sgld(0, flat_term(torch, torch.float32), M, t_t0, tsg.SGLDConfig(**cfg),
                        _noise=jax_noise(key, "sgld", 40, j_t0))
    assert_trees_close(port.samples, ref.samples, 1e-5)
    ref = jsg.run_sghmc(key, flat_term(jnp, jnp.float32), M, j_t0, jsg.SGHMCConfig(**cfg))
    port = tsg.run_sghmc(0, flat_term(torch, torch.float32), M, t_t0, tsg.SGHMCConfig(**cfg),
                         _noise=jax_noise(key, "sghmc", 40, j_t0))
    assert_trees_close(port.samples, ref.samples, 1e-5)


@pytest.mark.parametrize("case", ["constant", "decay", "rmsprop", "inv_mass", "sghmc"])
def test_bfloat16_chains_keep_their_dtype_and_match_jax(case):
    """SGLD computes a bfloat16 leaf's update in float32 (JAX's strong
    float32 step size promotes it) and casts back; SGHMC stays in the leaf's
    dtype."""
    key = jax.random.key(9)
    j_t0, t_t0 = jnp.zeros(3, jnp.bfloat16), torch.zeros(3, dtype=torch.bfloat16)
    j_term, t_term = flat_term(jnp, jnp.float32), flat_term(torch, torch.float32)
    steps = 20
    noise = jax_noise(key, "sghmc" if case == "sghmc" else "sgld", steps, j_t0)
    if case == "sghmc":
        cfg = dict(num_samples=steps, step_size=0.01)
        ref = jsg.run_sghmc(key, j_term, M, j_t0, jsg.SGHMCConfig(**cfg))
        port = tsg.run_sghmc(0, t_term, M, t_t0, tsg.SGHMCConfig(**cfg), _noise=noise)
    else:
        cfg = dict(num_samples=steps, step_size=0.01,
                   decay_gamma=0.55 if case == "decay" else 0.0,
                   preconditioner="rmsprop" if case == "rmsprop" else "none")
        mass = case == "inv_mass"
        ref = jsg.run_sgld(key, j_term, M, j_t0, jsg.SGLDConfig(**cfg),
                           inv_mass=jnp.ones(3) if mass else None)
        port = tsg.run_sgld(0, t_term, M, t_t0, tsg.SGLDConfig(**cfg),
                            inv_mass=torch.ones(3) if mass else None, _noise=noise)
    assert port.samples.dtype == port.final_theta.dtype == torch.bfloat16
    assert ref.samples.dtype == jnp.bfloat16
    assert_trees_close(port.samples, ref.samples, 2.0**-5 if case == "sghmc" else 2.0**-7)


def test_split_model_term_fn_protocol_matches_jax():
    """``define_split_model_log_prob``'s terms drive ``run_sgld`` in both
    packages from one ``nn.Sequential``: a split-HMC workload moves to SGLD
    by swapping the runner."""
    from hamiltorch_tpu.models.bnn import define_split_model_log_prob as j_split
    from hamiltorch_tpu_torch.models.bnn import define_split_model_log_prob as t_split

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(2, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1))
    rs = np.random.RandomState(1)
    x, y = rs.randn(32, 2).astype(np.float32), rs.randn(32, 1).astype(np.float32)
    loader = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]
    j_fn, m, j_flat, _, j_data = j_split(net, "regression", loader, num_splits=4, verbose=False)
    t_fn, m_t, t_flat, _, t_data = t_split(net, "regression", loader, num_splits=4,
                                           verbose=False, device="cpu")
    assert m == m_t == 4
    key = jax.random.key(10)
    cfg = dict(num_samples=12, step_size=1e-4, thin=3)
    ref = jsg.run_sgld(key, j_fn, m, j_flat, jsg.SGLDConfig(**cfg), data=j_data)
    port = tsg.run_sgld(0, t_fn, m, t_flat, tsg.SGLDConfig(**cfg), data=t_data,
                        _noise=jax_noise(key, "sgld", 12, j_flat))
    assert port.samples.shape == (4, t_flat.numel())
    assert_trees_close(port.samples, ref.samples, 1e-5)


def test_nonfinite_step_is_rejected_not_raised():
    """A term that overflows marks ``stats.divergent`` and keeps the last
    finite state, the same steps as in the JAX package."""
    key = jax.random.key(11)
    cfg = dict(num_samples=30, step_size=10.0, thin=3)

    def bad(xp):
        return lambda t, m: -xp.sum(xp.exp(80.0 * t**2))

    ref = jsg.run_sgld(key, bad(jnp), 2, jnp.ones(3), jsg.SGLDConfig(**cfg))
    noise = jax_noise(key, "sgld", 30, jnp.ones(3), num_terms=2)
    port = tsg.run_sgld(0, bad(torch), 2, torch.ones(3), tsg.SGLDConfig(**cfg), _noise=noise)
    assert bool(port.stats.divergent.any())
    assert bool(torch.isfinite(port.samples).all()) and bool(torch.isfinite(port.final_theta).all())
    np.testing.assert_array_equal(port.stats.divergent.numpy(), np.asarray(ref.stats.divergent))
    assert_trees_close(port.samples, ref.samples, 1e-6)


VALIDATION = [
    ("num_samples", lambda mod: mod.SGLDConfig(num_samples=0, step_size=0.1)),
    ("divisible", lambda mod: mod.SGLDConfig(num_samples=10, step_size=0.1, thin=3)),
    ("step_size", lambda mod: mod.SGLDConfig(num_samples=10, step_size=-1.0)),
    ("preconditioner", lambda mod: mod.SGLDConfig(num_samples=10, step_size=0.1,
                                                  preconditioner="adam")),
    ("rmsprop_alpha", lambda mod: mod.SGLDConfig(num_samples=10, step_size=0.1,
                                                 rmsprop_alpha=1.0)),
    ("decay_gamma", lambda mod: mod.SGLDConfig(num_samples=10, step_size=0.1, decay_gamma=-1)),
    ("temperature", lambda mod: mod.SGLDConfig(num_samples=10, step_size=0.1, temperature=0)),
    ("friction", lambda mod: mod.SGHMCConfig(num_samples=10, step_size=0.1, friction=2.0)),
    ("resample_momentum_every", lambda mod: mod.SGHMCConfig(num_samples=10, step_size=0.1,
                                                            resample_momentum_every=-1)),
    ("base", lambda mod: mod.CSGMCMCConfig(num_cycles=2, cycle_length=10, step_size=0.1,
                                           base="nuts")),
    ("divisible", lambda mod: mod.CSGMCMCConfig(num_cycles=2, cycle_length=10, step_size=0.1,
                                                exploration_frac=0.5, thin=3)),
    ("exploration_frac", lambda mod: mod.CSGMCMCConfig(num_cycles=2, cycle_length=10,
                                                       step_size=0.1, exploration_frac=1.0)),
    ("cycle_length", lambda mod: mod.CSGMCMCConfig(num_cycles=2, cycle_length=1,
                                                   step_size=0.1)),
]


@pytest.mark.parametrize("match,make", VALIDATION,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(VALIDATION)])
def test_config_validation_raises_as_in_jax(match, make):
    for mod in (jsg, tsg):
        with pytest.raises(ValueError, match=match):
            make(mod)


@pytest.mark.parametrize("what", ["num_terms", "mutually exclusive", "inv_mass shape"])
def test_entry_validation_raises_as_in_jax(what):
    kw = dict(num_samples=10, step_size=0.1)
    cases = {
        "num_terms": lambda mod, xp, z: mod.run_sgld(0, lambda t, m: -xp.sum(t**2), 0, z,
                                                     mod.SGLDConfig(**kw)),
        "mutually exclusive": lambda mod, xp, z: mod.run_sgld(
            0, lambda t, m: -xp.sum(t**2), 4, z,
            mod.SGLDConfig(preconditioner="rmsprop", **kw), inv_mass=z + 1),
        "inv_mass shape": lambda mod, xp, z: mod.run_sgld(
            0, lambda t, m: -xp.sum(t**2), 4, z, mod.SGLDConfig(**kw),
            inv_mass=xp.ones(4)),
    }
    with pytest.raises(ValueError, match=what):
        cases[what](jsg, jnp, jnp.zeros(3))
    with pytest.raises(ValueError, match=what):
        cases[what](tsg, torch, torch.zeros(3))


def test_sharded_arguments_raise():
    """``psum_axis`` names a mesh dimension: without a mesh it raises (the
    sharded runs are held in tests/test_torch_sharding.py)."""
    with pytest.raises(ValueError, match="needs a mesh"):
        tsg._run_sgld(0, torch.zeros(1, 3), lambda t, m: -torch.sum(t**2), 2,
                      tsg.SGLDConfig(num_samples=2, step_size=0.1), psum_axis="data")


def test_prior_fn_enters_once_beside_the_terms():
    """``prior_fn`` (the sharded runners' local prior) adds its gradient to
    ``num_terms`` times the term's: the run equals the one whose term
    carries ``prior / num_terms``, up to rounding."""
    prior = lambda t: -0.5 * torch.sum(t**2)  # noqa: E731

    def term(t, m):
        return -0.5 * (m + 1.0) * torch.sum((t - 1.0) ** 2)

    cfg = tsg.SGLDConfig(num_samples=6, step_size=0.05)
    got = tsg._run_sgld(3, torch.zeros(2, 3), term, 2, cfg, prior_fn=prior)
    want = tsg._run_sgld(3, torch.zeros(2, 3), lambda t, m: term(t, m) + prior(t) / 2, 2, cfg)
    torch.testing.assert_close(got.samples, want.samples, rtol=0, atol=1e-6)
    assert not torch.equal(got.samples, tsg._run_sgld(3, torch.zeros(2, 3), term, 2,
                                                      cfg).samples)


@pytest.mark.parametrize("kind", ["sgld", "psgld", "sghmc"])
def test_chunked_runs_resume_bit_for_bit(kind):
    """Two runs chained through ``final_theta`` / ``final_aux`` /
    ``final_step`` equal one straight run with the same key (every step's
    term and normals are keyed on the global step)."""
    term = flat_term(torch, torch.float32)
    if kind == "sghmc":
        run, cfg = tsg.run_sghmc, tsg.SGHMCConfig(num_samples=24, step_size=0.01, thin=2,
                                                  resample_momentum_every=5)
    else:
        run = tsg.run_sgld
        cfg = tsg.SGLDConfig(num_samples=24, step_size=0.02, thin=2,
                             preconditioner="rmsprop" if kind == "psgld" else "none")
    full = run(12, term, M, torch.zeros(3), cfg)
    a = run(12, term, M, torch.zeros(3), dataclasses.replace(cfg, num_samples=10))
    b = run(12, term, M, a.final_theta, dataclasses.replace(cfg, num_samples=14),
            init_aux=a.final_aux, start_step=int(a.final_step))
    assert torch.equal(torch.cat([a.samples, b.samples]), full.samples)
    assert torch.equal(b.final_theta, full.final_theta)
    for f in tsg.SGMCMCStats._fields:
        assert torch.equal(torch.cat([getattr(a.stats, f), getattr(b.stats, f)]),
                           getattr(full.stats, f))


def test_chains_differ_and_draw_their_own_streams():
    """Chain 0 of a batch draws what a single chain draws, the chains of a
    batch differ, and the term indices are a function of (seed, chain,
    step) alone."""
    from hamiltorch_tpu_torch.utils.rng import sg_term_indices

    term = flat_term(torch, torch.float32)
    cfg = tsg.SGLDConfig(num_samples=8, step_size=0.02)
    res = tsg.run_sgld_chains(13, term, M, torch.zeros(3), cfg, 2)
    assert not torch.equal(res.samples[0], res.samples[1])
    one = tsg.run_sgld(13, term, M, torch.zeros(3), cfg)
    assert torch.equal(one.samples, res.samples[0])
    idx = [sg_term_indices(13, g, 3, M) for g in range(200)]
    assert idx == [sg_term_indices(13, g, 3, M) for g in range(200)]
    assert {i for row in idx for i in row} == set(range(M))


def test_gaussian_recovery_with_noisy_gradients():
    """Pooled SGLD and SGHMC chains on the noisy-term Gaussian recover its
    mean and scales (``tests/test_sgmcmc.py``'s targets, shorter runs,
    looser gates)."""
    term = lambda t, m: -0.125 * torch.sum((t - torch.as_tensor(CS[m], dtype=t.dtype)) ** 2  # noqa: E731
                                           / torch.as_tensor(S2, dtype=t.dtype))
    for run, cfg in ((tsg.run_sgld_chains, tsg.SGLDConfig(num_samples=3000, step_size=0.02)),
                     (tsg.run_sghmc_chains, tsg.SGHMCConfig(num_samples=3000, step_size=5e-3,
                                                            friction=0.1))):
        r = run(14, term, M, torch.as_tensor(MU, dtype=torch.float32), cfg, 8,
                inv_mass=torch.as_tensor(S2, dtype=torch.float32))
        pooled = r.samples[:, 500:].reshape(-1, 3).double().numpy()
        np.testing.assert_allclose(pooled.mean(0), MU, atol=0.25)
        np.testing.assert_allclose(pooled.std(0), np.sqrt(S2), rtol=0.25)
        assert not bool(r.stats.divergent.any())

