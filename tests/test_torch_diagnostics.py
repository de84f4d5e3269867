"""Port vs JAX package: convergence diagnostics (``diagnostics.py``).

Every function runs on the same numpy traces in both packages: AR(1)
chains (C=4, N=301, D=3, one chain shifted so that R-hat sees it, every
third draw a repeat so that ranks have ties), single-chain (N, D) traces,
and parameter-tree traces.  The port computes in float64, the JAX code in
float32; the results agree within rtol 1e-5 (ESS, MCSE, R-hat, means)
and the structures (tree splits, ArviZ dicts) are identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.diagnostics as jdiag
import hamiltorch_tpu_torch as tht
import hamiltorch_tpu_torch.diagnostics as tdiag

RTOL = 1e-5


def ar1_trace(c=4, n=301, d=3, seed=0, rho=(0.2, 0.6, 0.9)):
    rng = np.random.default_rng(seed)
    x = np.zeros((c, n, d))
    x[:, 0] = rng.standard_normal((c, d))
    for t in range(1, n):
        x[:, t] = np.asarray(rho) * x[:, t - 1] + rng.standard_normal((c, d))
    x[:, 2::3] = x[:, 1:-1:3]  # rejected draws repeat the last state: ties
    x[-1] += 0.3
    return x.astype(np.float32)


TRACE = ar1_trace()
FUNCS = ["effective_sample_size", "potential_scale_reduction", "rank_normalized_rhat",
         "bulk_ess", "tail_ess", "mcse_mean"]


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("shape", ["chains", "single"])
@pytest.mark.parametrize("name", FUNCS)
def test_statistic_matches_jax(name, shape):
    trace = TRACE if shape == "chains" else TRACE[0]
    got = getattr(tdiag, name)(torch.as_tensor(trace))
    want = getattr(jdiag, name)(jnp.asarray(trace))
    assert got.dtype == torch.float64 and got.shape == tuple(want.shape)
    close(got, want)


def test_rank_normalize_matches_jax_with_ties():
    x = torch.as_tensor(TRACE).double()
    close(tdiag._rank_normalize(x), jdiag._rank_normalize(jnp.asarray(TRACE)), rtol=1e-5)


def test_autocovariance_matches_jax():
    """Lags near zero sit at the float32 FFT's rounding (~1e-7 of the lag-0
    value ~4): atol 1e-6 there."""
    x = TRACE[0, :, 2]
    np.testing.assert_allclose(tdiag._autocovariance(torch.as_tensor(x).double()).numpy(),
                               np.asarray(jdiag._autocovariance(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-6)


def test_e_bfmi_matches_jax():
    energies = TRACE[..., 0] * 3 + 10.0  # (C, N)
    close(tdiag.e_bfmi(torch.as_tensor(energies)), jdiag.e_bfmi(jnp.asarray(energies)))
    close(tdiag.e_bfmi(torch.as_tensor(energies[0])), jdiag.e_bfmi(jnp.asarray(energies[0])))


def test_summary_matches_jax():
    energies = TRACE[..., 0] * 3 + 10.0
    got = tdiag.summary(torch.as_tensor(TRACE), energies=torch.as_tensor(energies))
    want = jdiag.summary(jnp.asarray(TRACE), energies=jnp.asarray(energies))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])
    assert float(got["r_hat"].max()) > 1.01  # the shifted chain shows


def tree_trace(chains=True):
    """{"a": (C, N, 2), "b": (C, N, 1, 1)} cut from TRACE (no leading chain
    axis when chains=False)."""
    t = TRACE if chains else TRACE[0]
    return {"a": t[..., :2], "b": t[..., 2:].reshape(t.shape[:-1] + (1, 1))}


TEMPLATE = {"a": np.zeros(2, np.float32), "b": np.zeros((1, 1), np.float32)}


@pytest.mark.parametrize("chains", [True, False])
def test_tree_traces_match_jax(chains):
    tr = tree_trace(chains)
    t_tree = {k: torch.as_tensor(v) for k, v in tr.items()}
    j_tree = {k: jnp.asarray(v) for k, v in tr.items()}
    t_like = {k: torch.as_tensor(v) for k, v in TEMPLATE.items()}
    j_like = {k: jnp.asarray(v) for k, v in TEMPLATE.items()}
    flat = tdiag.as_flat_samples(t_tree, like=t_like)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jdiag.as_flat_samples(j_tree, like=j_like)))
    got = tdiag.summary_by_leaf(t_tree, t_like)
    want = jdiag.summary_by_leaf(j_tree, j_like)
    for stat in want:
        for leaf in ("a", "b"):
            assert tuple(got[stat][leaf].shape) == tuple(want[stat][leaf].shape)
            close(got[stat][leaf], want[stat][leaf])
    for name in FUNCS:
        close(getattr(tdiag, name)(t_tree, like=t_like), getattr(jdiag, name)(j_tree, like=j_like))


def test_tree_trace_axes_ambiguity_as_in_jax():
    square = {"a": TRACE[..., :2], "b": TRACE[..., 2:]}  # every leaf (C, N, ...)
    with pytest.raises(ValueError, match="ambiguous"):
        tdiag.as_flat_samples({k: torch.as_tensor(v) for k, v in square.items()})
    with pytest.raises(ValueError, match="ambiguous"):
        jdiag.as_flat_samples({k: jnp.asarray(v) for k, v in square.items()})
    # a 1-d leaf forces the single-chain reading in both
    single = {"a": TRACE[0, :, 0], "b": TRACE[0, :, 1:]}
    np.testing.assert_array_equal(
        tdiag.as_flat_samples({k: torch.as_tensor(v) for k, v in single.items()}).numpy(),
        np.asarray(jdiag.as_flat_samples({k: jnp.asarray(v) for k, v in single.items()})))
    with pytest.raises(ValueError, match="extra leading dims"):
        tdiag.as_flat_samples({"a": torch.zeros(5)}, like={"a": torch.zeros(5)})


def test_half_precision_trace_upcasts_to_float32():
    x = torch.as_tensor(TRACE).to(torch.bfloat16)
    assert tdiag.as_flat_samples(x).dtype == torch.float32
    assert tdiag.effective_sample_size(x).dtype == torch.float64


@functools.lru_cache(maxsize=None)
def _runs(form):
    """(port result, JAX result) of one small run of each family (run once
    a module: the results are read, never changed)."""
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    j_lp = lambda t: -0.5 * jnp.sum((t["w"] / scale) ** 2) if form == "tree" else \
        -0.5 * jnp.sum((t / scale) ** 2)  # noqa: E731
    ts = torch.as_tensor(scale)
    t_lp = lambda t: -0.5 * torch.sum((t["w"] / ts) ** 2) if form == "tree" else \
        -0.5 * torch.sum((t / ts) ** 2)  # noqa: E731
    j0 = {"w": jnp.ones(3)} if form == "tree" else jnp.ones(3)
    t0 = {"w": torch.ones(3)} if form == "tree" else torch.ones(3)
    key = jax.random.key(0)
    hmc = dict(num_samples=6, num_steps_per_sample=3, step_size=0.3)
    mclmc = dict(num_samples=6, tune_steps=0, trajectory_length=2.0)
    mams = dict(num_samples=6, num_steps_per_sample=3, adapt_step_size=False)
    chees = dict(num_samples=6, step_size=0.3, burn=3)
    sgld = dict(num_samples=6, step_size=0.01)
    cyc = dict(num_cycles=2, cycle_length=6, step_size=0.05, exploration_frac=0.5)

    pt = dict(num_samples=6, num_steps_per_sample=3, step_size=0.3, num_temps=3, burn=2)
    ti = dict(num_samples=6, num_steps_per_sample=3, step_size=0.3, num_temps=3, burn=2)
    smc = dict(num_particles=8, num_temps=3, mcmc_steps=2, leapfrog_steps=3)
    barker = dict(num_samples=6, burn=2)

    def j_prior(t):
        return -0.5 * sum(jnp.sum(leaf ** 2) for leaf in jax.tree_util.tree_leaves(t))

    def t_prior(t):
        return -0.5 * sum(torch.sum(leaf ** 2) for leaf in (t.values() if form == "tree" else [t]))

    def j_prior_sample(k, n):
        z = jax.random.normal(k, (n, 3))
        return {"w": z} if form == "tree" else z

    def t_prior_sample(seed, n):
        z = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))
        return {"w": z} if form == "tree" else z

    def j_term(t, m):
        return 0.5 * j_lp(t)

    def t_term(t, m):
        return 0.5 * t_lp(t)

    return {
        "hmc": (tht.run_hmc_chains(0, t_lp, t0, tht.MCMCConfig(**hmc), 2),
                jht.run_hmc_chains(key, j_lp, j0, jht.MCMCConfig(**hmc), 2)),
        "hmc_single": (tht.run_hmc(0, t_lp, t0, tht.MCMCConfig(**hmc)),
                       jht.run_hmc(key, j_lp, j0, jht.MCMCConfig(**hmc))),
        "mclmc": (tht.run_mclmc_chains(0, t_lp, t0, tht.MCLMCConfig(**mclmc), 2),
                  jht.run_mclmc_chains(key, j_lp, j0, jht.MCLMCConfig(**mclmc), 2)),
        "mams": (tht.run_mams_chains(0, t_lp, t0, tht.MAMSConfig(**mams), 2),
                 jht.run_mams_chains(key, j_lp, j0, jht.MAMSConfig(**mams), 2)),
        "mams_single": (tht.run_mams(0, t_lp, t0, tht.MAMSConfig(**mams)),
                        jht.run_mams(key, j_lp, j0, jht.MAMSConfig(**mams))),
        "chees": (tht.run_chees(0, t_lp, t0, tht.ChEESConfig(**chees), 4),
                  jht.run_chees(key, j_lp, j0, jht.ChEESConfig(**chees), 4)),
        "sgld": (tht.run_sgld_chains(0, t_term, 2, t0, tht.SGLDConfig(**sgld), 2),
                 jht.run_sgld_chains(key, j_term, 2, j0, jht.SGLDConfig(**sgld), 2)),
        "sghmc_single": (tht.run_sghmc(0, t_term, 2, t0, tht.SGHMCConfig(**sgld)),
                         jht.run_sghmc(key, j_term, 2, j0, jht.SGHMCConfig(**sgld))),
        "csgmcmc": (tht.run_csgmcmc_chains(0, t_term, 2, t0, tht.CSGMCMCConfig(**cyc), 2),
                    jht.run_csgmcmc_chains(key, j_term, 2, j0, jht.CSGMCMCConfig(**cyc), 2)),
        "csgmcmc_single": (tht.run_csgmcmc(0, t_term, 2, t0, tht.CSGMCMCConfig(**cyc)),
                           jht.run_csgmcmc(key, j_term, 2, j0, jht.CSGMCMCConfig(**cyc))),
        "pt": (tht.run_parallel_tempering(0, t_lp, t0, tht.PTConfig(**pt)),
               jht.run_parallel_tempering(key, j_lp, j0, jht.PTConfig(**pt))),
        "pt_chains": (tht.run_pt_chains(0, t_lp, t0, tht.PTConfig(**pt), 2),
                      jht.run_pt_chains(key, j_lp, j0, jht.PTConfig(**pt), 2)),
        "ti": (tht.run_ti(0, t_prior, t_lp, t0, tht.TIConfig(**ti)),
               jht.run_ti(key, j_prior, j_lp, j0, jht.TIConfig(**ti))),
        "smc": (tht.run_smc(0, t_prior, t_lp, t_prior_sample, tht.SMCConfig(**smc)),
                jht.run_smc(key, j_prior, j_lp, j_prior_sample, jht.SMCConfig(**smc))),
        "barker": (tht.run_barker(0, t_lp, t0, tht.BarkerConfig(**barker)),
                   jht.run_barker(key, j_lp, j0, jht.BarkerConfig(**barker))),
        "barker_chains": (tht.run_barker_chains(0, t_lp, t0, tht.BarkerConfig(**barker), 2),
                          jht.run_barker_chains(key, j_lp, j0, jht.BarkerConfig(**barker), 2)),
        "stretch": (tht.run_stretch(0, t_lp, t0, tht.StretchConfig(num_samples=5), 8),
                    jht.run_stretch(key, j_lp, j0, jht.StretchConfig(num_samples=5), 8)),
        "elliptical": (tht.run_elliptical(0, t_lp, t0, tht.EllipticalConfig(num_samples=5)),
                       jht.run_elliptical(key, j_lp, j0, jht.EllipticalConfig(num_samples=5))),
        "elliptical_chains": (
            tht.run_elliptical_chains(0, t_lp, t0, tht.EllipticalConfig(num_samples=5), 2),
            jht.run_elliptical_chains(key, j_lp, j0, jht.EllipticalConfig(num_samples=5), 2)),
    }


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_inference_dict_layout_matches_jax(form):
    for family, (t_res, j_res) in _runs(form).items():
        got, want = tdiag.to_inference_dict(t_res), jdiag.to_inference_dict(j_res)
        for part in ("posterior", "sample_stats"):
            assert sorted(got[part]) == sorted(want[part]), (family, part)
            for name in want[part]:
                g, w = got[part][name], np.asarray(want[part][name])
                assert isinstance(g, np.ndarray)
                assert g.shape == w.shape and g.dtype == w.dtype, (family, name)


@pytest.mark.parametrize("family", ["chees", "nuts"])
def test_inference_dict_of_a_bfloat16_trace(family):
    """A ``trace_dtype="bfloat16"`` trace exports as its float32 values
    (numpy has no bfloat16; the JAX package's dict holds ml_dtypes'
    bfloat16, the same values)."""
    lp = lambda t: -0.5 * torch.sum(t ** 2)  # noqa: E731
    if family == "chees":
        res = tht.run_chees(0, lp, torch.zeros(2), tht.ChEESConfig(
            num_samples=4, trace_dtype="bfloat16"), 4)
        trace = res.samples
    else:
        res = tht.run_nuts_chains(0, lp, torch.zeros(2), tht.NUTSConfig(
            num_samples=4, trace_dtype="bfloat16"), 3)
        trace = res[0].samples
    post = tdiag.to_inference_dict(res)["posterior"]["theta"]
    assert trace.dtype == torch.bfloat16 and post.dtype == np.float32
    np.testing.assert_array_equal(post, trace.float().numpy())


def test_inference_dict_of_the_tempered_families():
    """The PT, TI and SMC branches read the cold chain's acceptance (the
    last burn-sliced draws, chains first for ensembles), the beta=1 rung's
    acceptance and its pair's swaps, and the particles' log-weights."""
    runs = _runs("flat")
    pt = runs["pt"][0]
    d = tdiag.to_inference_dict(pt)
    np.testing.assert_array_equal(d["posterior"]["theta"], pt.samples.numpy()[None])
    np.testing.assert_array_equal(d["sample_stats"]["acceptance_rate"],
                                  pt.info.accept_prob.numpy()[None, :, 0])
    ens = runs["pt_chains"][0]
    d = tdiag.to_inference_dict(ens)
    assert d["posterior"]["theta"].shape == (2, 4, 3)
    np.testing.assert_array_equal(d["sample_stats"]["acceptance_rate"],
                                  ens.info.accept_prob.numpy()[:, :, 0])
    ti = runs["ti"][0]
    d = tdiag.to_inference_dict(ti)
    np.testing.assert_array_equal(d["sample_stats"]["acceptance_rate"],
                                  ti.info.accept_prob.numpy()[None, :, -1])
    np.testing.assert_array_equal(d["sample_stats"]["swap_accepted"],
                                  ti.info.swap_accept.numpy()[None, :, -1])
    smc = runs["smc"][0]
    d = tdiag.to_inference_dict(smc)
    assert d["posterior"]["theta"].shape == (1, 8, 3)
    np.testing.assert_array_equal(d["sample_stats"]["log_weight"], smc.log_weights.numpy()[None])


def test_inference_dict_of_the_gradient_free_families():
    """The stretch move's walkers export as chains with the ensemble's
    acceptance fraction broadcast to each; elliptical slice gives shrinks
    and log-likelihoods; Barker its acceptance and step size (tested before
    MAMS's branch: a BarkerResult also has final_da and final_theta)."""
    runs = _runs("flat")
    st = runs["stretch"][0]
    d = tdiag.to_inference_dict(st)
    np.testing.assert_array_equal(d["posterior"]["theta"], st.samples.numpy().swapaxes(0, 1))
    np.testing.assert_array_equal(d["sample_stats"]["acceptance_rate"],
                                  np.broadcast_to(st.stats.accept_frac.numpy(), (8, 5)))
    el = runs["elliptical_chains"][0]
    d = tdiag.to_inference_dict(el)
    np.testing.assert_array_equal(d["sample_stats"]["n_shrinks"], el.stats.shrinks.numpy())
    np.testing.assert_array_equal(d["sample_stats"]["loglik"], el.stats.loglik.numpy())
    el = runs["elliptical"][0]
    assert tdiag.to_inference_dict(el)["sample_stats"]["n_shrinks"].shape == (1, 5)
    ba = runs["barker"][0]
    d = tdiag.to_inference_dict(ba)
    assert sorted(d["sample_stats"]) == ["acceptance_rate", "diverging", "step_size"]
    np.testing.assert_array_equal(d["sample_stats"]["step_size"], ba.stats.step_size.numpy()[None])
    tree = tdiag.to_inference_dict(_runs("tree")["stretch"][0])
    assert tree["posterior"]["w"].shape == (8, 5, 3)


def test_inference_dict_refuses_families_not_ported():
    """Not a sampler's result: refused.  An SVGDResult (particles, no chains
    or statistics) is refused with a plain message, as the JAX function has
    no branch for it."""
    with pytest.raises(NotImplementedError, match="samplers' results"):
        tdiag.to_inference_dict(("result", "info"))
    with pytest.raises(NotImplementedError, match="not a sampler's result"):
        tdiag.to_inference_dict(type("Other", (), {"samples": 0, "stats": 0})())
    svgd = tht.run_svgd(0, lambda t: -torch.sum(t**2), torch.zeros(2),
                        tht.SVGDConfig(num_steps=2), 4)
    with pytest.raises(TypeError, match="SVGDResult"):
        tdiag.to_inference_dict(svgd)


def test_to_arviz_needs_arviz():
    try:
        import arviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="arviz"):
            tdiag.to_arviz(_runs("flat")["hmc"][0])
        pytest.skip("arviz is not installed")
    data = tdiag.to_arviz(_runs("flat")["hmc"][0])
    assert data.posterior["theta"].shape[:2] == (2, 6)
