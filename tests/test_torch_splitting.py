"""Port vs JAX package: symmetric-split minibatch HMC
(``integrators/splitting.py``, ``samplers/splitting.py``, the split
factories and ``sample_split_model`` of ``models/bnn.py``, and the
splitting branch of ``sample``).

Inputs are drawn with numpy from a seed; the samplers run on the JAX
driver's own noise, replayed here: ``split(fold_in(key, n))`` into a
proposal and a Metropolis key, the proposal key split into the momentum
normal and the SPLITTING_RAND permutation (chains take ``split(key, C)[c]``).
The BNN tests hand one ``nn.Sequential`` to both packages, as
``tests/test_torch_bnn_model.py`` does.

Tolerances: one trajectory within 1e-10 in float64; the samplers identical
accepts and samples within 1e-10 in float64, 1e-5 in float32 (both sum
float32 in another order); the split factories' term values within 1e-5
relative and their gradients within 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import hamiltorch_tpu as jht
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu.integrators import splitting as j_int
from hamiltorch_tpu.models import bnn as jbnn
from hamiltorch_tpu.ops.mass import make_mass as j_make_mass
from hamiltorch_tpu.ops.mass import make_mass_tree as j_make_mass_tree
from hamiltorch_tpu.samplers import splitting as j_split
from hamiltorch_tpu_torch.integrators import splitting as t_int
from hamiltorch_tpu_torch.models import bnn as tbnn
from hamiltorch_tpu_torch.ops.mass import make_mass as t_make_mass
from hamiltorch_tpu_torch.ops.mass import make_mass_tree as t_make_mass_tree
from hamiltorch_tpu_torch.samplers import driver as t_driver
from hamiltorch_tpu_torch.samplers import splitting as t_split

SCHEMES = ["SPLITTING", "SPLITTING_RAND", "SPLITTING_KMID"]
M = 3
DATA = np.random.RandomState(0).randn(M, 4, 2)
INV_DIAG = np.array([0.8, 1.3])


def terms(xp, dtype=None):
    """M minibatch terms of a non-Gaussian target on D=2."""
    data = [jnp.asarray(d) if xp is jnp else torch.as_tensor(d) for d in DATA]
    if dtype is not None:
        data = [d.astype(dtype) if xp is jnp else d.to(dtype) for d in data]

    def make(d):
        return lambda t: -0.5 * xp.sum((t - d) ** 2) / 3.0 + 0.1 * xp.sum(xp.sin(t))
    return [make(d) for d in data]


def stacked_term(xp):
    """The same terms as one term_fn(theta, m, data) over stacked data."""
    def term_fn(t, m, data):
        return -0.5 * xp.sum((t - data[m]) ** 2) / 3.0 + 0.1 * xp.sum(xp.sin(t))
    return term_fn


def tree_term(xp):
    """A term on the tree {"a": (1,), "b": (1,)}: the flat terms' values."""
    def term_fn(t, m, data):
        flat = xp.concatenate([t["a"], t["b"]])
        return stacked_term(xp)(flat, m, data)
    return term_fn


def split_noise(key, num_chains, num_samples, d, dtype, chains=True, num_terms=M):
    """The JAX split driver's (z, log_u, perm): (S, C, ...) for the chains
    runner, (S, ...) for a single chain run on the key itself."""

    def one(k, n):
        k_prop, k_mh = jax.random.split(jax.random.fold_in(k, n))
        k_mom, k_perm = jax.random.split(k_prop)
        return (jax.random.normal(k_mom, (d,), dtype),
                jnp.log(jax.random.uniform(k_mh, (), dtype)),
                jax.random.permutation(k_perm, num_terms))

    def per_key(k):
        return jax.vmap(lambda n: one(k, n))(jnp.arange(num_samples))

    if not chains:
        out = [np.array(a) for a in per_key(key)]
    else:
        out = [np.swapaxes(np.asarray(a), 0, 1).copy()
               for a in jax.vmap(per_key)(jax.random.split(key, num_chains))]
    out[2] = out[2].astype(np.int64)
    return tuple(torch.as_tensor(a) for a in out)


# --- the integrator ------------------------------------------------------------

@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_one_trajectory_matches_jax(scheme, form):
    """Every chain of a batch against the JAX integrator vmapped over chains,
    each chain with its own injected term order; a diagonal mass."""
    chains, eps, steps = 4, 0.3, 3
    rs = np.random.RandomState(1)
    theta, p = rs.randn(chains, 2), rs.randn(chains, 2)
    perm = np.stack([rs.permutation(M) for _ in range(chains)])
    integ_j, integ_t = getattr(jht.Integrator, scheme), getattr(tht.Integrator, scheme)
    with jax.enable_x64(True):
        j_data, t_data = jnp.asarray(DATA), torch.as_tensor(DATA)
        if form == "flat":
            j_grad = jax.grad(lambda t, m: stacked_term(jnp)(t, m, j_data))
            mass_j = j_make_mass(jnp.asarray(INV_DIAG), 2)
            mass_t = t_make_mass(torch.as_tensor(INV_DIAG), 2)
            j_th, j_p = jnp.asarray(theta), jnp.asarray(p)
            t_th, t_p = torch.as_tensor(theta), torch.as_tensor(p)
            t_fn = stacked_term(torch)
        else:
            j_grad = jax.grad(lambda t, m: tree_term(jnp)(t, m, j_data))
            tmpl_j = {"a": jnp.zeros(1), "b": jnp.zeros(1)}
            mass_j = j_make_mass_tree({"a": jnp.asarray(INV_DIAG[:1]),
                                       "b": jnp.asarray(INV_DIAG[1:])}, tmpl_j)
            tmpl_t = {"a": torch.zeros(1, dtype=torch.float64),
                      "b": torch.zeros(1, dtype=torch.float64)}
            mass_t = t_make_mass_tree({"a": torch.as_tensor(INV_DIAG[:1]),
                                       "b": torch.as_tensor(INV_DIAG[1:])}, tmpl_t)
            j_th = {"a": jnp.asarray(theta[:, :1]), "b": jnp.asarray(theta[:, 1:])}
            j_p = {"a": jnp.asarray(p[:, :1]), "b": jnp.asarray(p[:, 1:])}
            t_th = {"a": torch.as_tensor(theta[:, :1]), "b": torch.as_tensor(theta[:, 1:])}
            t_p = {"a": torch.as_tensor(p[:, :1]), "b": torch.as_tensor(p[:, 1:])}
            t_fn = tree_term(torch)
        want = jax.jit(jax.vmap(lambda th, mo, pm: j_int.splitting_leapfrog(
            j_grad, M, mass_j, th, mo, eps, steps, integ_j, perm=pm)))(
                j_th, j_p, jnp.asarray(perm))
    grads = [torch.func.vmap(torch.func.grad(lambda t, m=m: t_fn(t, m, t_data)))
             for m in range(M)]
    got = t_int.splitting_leapfrog(
        lambda th, m: grads[m](th), M, torch.func.vmap(mass_t.velocity), t_th, t_p,
        torch.full((chains,), eps, dtype=torch.float64), steps, integ_t,
        perm=torch.as_tensor(perm))
    for g, w in zip(got, want):
        for gl, wl in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)):
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-10)


@pytest.mark.parametrize("scheme", ["SPLITTING", "SPLITTING_KMID"])
def test_one_term_is_refused_by_the_symmetric_schemes(scheme):
    with pytest.raises(RuntimeError, match="greater than length 1"):
        t_split.run_split_hmc(0, terms(torch)[:1], torch.zeros(2), tht.MCMCConfig(num_samples=2),
                              integrator=getattr(tht.Integrator, scheme))
    with pytest.raises(RuntimeError, match="greater than length 1"):
        j_split.run_split_hmc(jax.random.key(0), terms(jnp)[:1], jnp.zeros(2),
                              jht.MCMCConfig(num_samples=2),
                              integrator=getattr(jht.Integrator, scheme))


# --- the samplers --------------------------------------------------------------

def assert_runs_match(t_res, j_res, atol):
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    for tl, jl in zip(jax.tree_util.tree_leaves(t_res.samples),
                      jax.tree_util.tree_leaves(j_res.samples)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)
    np.testing.assert_allclose(t_res.stats.energy_new.numpy(), np.asarray(j_res.stats.energy_new),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_split_hmc_matches_jax(scheme, dtype):
    """The list-of-closures entry, one chain on the key itself; with a
    diagonal mass and per-term user gradients in float64."""
    f64 = dtype == "float64"
    cfg = dict(num_samples=6, num_steps_per_sample=3, step_size=0.9)
    key = jax.random.key(3)
    integ = getattr(jht.Integrator, scheme)
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        kw_j = dict(inv_mass=jnp.asarray(INV_DIAG, jdt)) if f64 else {}
        j_res = j_split.run_split_hmc(key, terms(jnp, jdt), jnp.zeros(2, jdt) + 0.2,
                                      jht.MCMCConfig(**cfg), integrator=integ, **kw_j)
        noise = split_noise(key, 1, 6, 2, jdt, chains=False)
    tdt = getattr(torch, dtype)
    kw_t = {}
    if f64:
        kw_t = dict(inv_mass=torch.as_tensor(INV_DIAG),
                    pass_grad=[torch.func.grad(f) for f in terms(torch, tdt)])
    t_res = t_split.run_split_hmc(0, terms(torch, tdt), torch.zeros(2, dtype=tdt) + 0.2,
                                  tht.MCMCConfig(**cfg),
                                  integrator=getattr(tht.Integrator, scheme),
                                  _noise=noise if scheme == "SPLITTING_RAND" else noise[:2],
                                  **kw_t)
    assert 0 < np.asarray(j_res.stats.accepted).mean() < 1 or scheme != "SPLITTING_KMID"
    assert_runs_match(t_res, j_res, 1e-10 if f64 else 1e-5)


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_split_hmc_chains_on_stacked_data_matches_jax(scheme, form):
    chains = 3
    cfg = dict(num_samples=5, num_steps_per_sample=2, step_size=0.9)
    key = jax.random.key(5)
    integ = getattr(jht.Integrator, scheme)
    with jax.enable_x64(True):
        if form == "flat":
            j_fn, t_fn = stacked_term(jnp), stacked_term(torch)
            j0, t0 = jnp.zeros(2) + 0.1, torch.zeros(2, dtype=torch.float64) + 0.1
        else:
            j_fn, t_fn = tree_term(jnp), tree_term(torch)
            j0 = {"a": jnp.zeros(1) + 0.1, "b": jnp.zeros(1) + 0.1}
            t0 = {"a": torch.zeros(1, dtype=torch.float64) + 0.1,
                  "b": torch.zeros(1, dtype=torch.float64) + 0.1}
        j_res = j_split.run_split_hmc_chains(key, j_fn, M, j0, jht.MCMCConfig(**cfg), chains,
                                             integrator=integ, data=jnp.asarray(DATA))
        noise = split_noise(key, chains, 5, 2, jnp.float64)
    t_res = t_split.run_split_hmc_chains(
        0, t_fn, M, t0, tht.MCMCConfig(**cfg), chains,
        integrator=getattr(tht.Integrator, scheme), data=torch.as_tensor(DATA),
        _noise=noise if scheme == "SPLITTING_RAND" else noise[:2])
    assert_runs_match(t_res, j_res, 1e-10)


def test_split_chains_do_not_depend_on_the_chain_count():
    """Chain c draws from its own stream: chain 0 of 3 is chain 0 of 1."""
    cfg = tht.MCMCConfig(num_samples=4, num_steps_per_sample=2, step_size=0.5)
    kw = dict(integrator=tht.Integrator.SPLITTING_RAND, data=torch.as_tensor(DATA))
    three = t_split.run_split_hmc_chains(7, stacked_term(torch), M,
                                         torch.zeros(2, dtype=torch.float64), cfg, 3, **kw)
    one = t_split.run_split_hmc_chains(7, stacked_term(torch), M,
                                       torch.zeros(2, dtype=torch.float64), cfg, 1, **kw)
    torch.testing.assert_close(three.samples[0], one.samples[0], rtol=0, atol=1e-12)
    assert not torch.equal(three.samples[0], three.samples[1])


# --- the BNN layer -------------------------------------------------------------

NS = 24


def net(kind="mlp"):
    torch.manual_seed(0)
    if kind == "mlp":
        return nn.Sequential(nn.Linear(4, 6), nn.Tanh(), nn.Linear(6, 3))
    return nn.Sequential(nn.Linear(1, 8), nn.Tanh(), nn.Linear(8, 1))


def loader(kind="mlp", splits=4, ragged=False):
    rs = np.random.RandomState(2)
    if kind == "mlp":
        x = rs.randn(NS, 4).astype(np.float32)
        y = rs.randint(0, 3, NS).astype(np.float32)
    else:
        x = np.linspace(-1, 1, NS)[:, None].astype(np.float32)
        y = (np.sin(2 * x) + 0.05 * rs.randn(NS, 1)).astype(np.float32)
    batches = [(x[i::splits], y[i::splits]) for i in range(splits)]
    if ragged:
        batches.append((x[:2], y[:2]))
    return batches, x, y


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_split_factories_match_jax_and_sum_to_the_full_potential(form):
    batches, x, y = loader(ragged=True)  # the ragged tail is dropped by both
    kw = dict(tau_list=[1.0, 2.0, 0.5, 1.5], tau_out=2.0, verbose=False)
    if form == "flat":
        j_fn, j_m, j_flat, _, j_data = jbnn.define_split_model_log_prob(
            net(), "multi_class_linear_output", batches, 4, **kw)
        t_fn, t_m, t_flat, _, t_data = tbnn.define_split_model_log_prob(
            net(), "multi_class_linear_output", batches, 4, device="cpu", **kw)
        np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
        theta = np.asarray(t_flat) + 0.1 * np.random.RandomState(3).randn(t_flat.numel())
        theta = theta.astype(np.float32)
        j_theta, t_theta = jnp.asarray(theta), torch.as_tensor(theta)
    else:
        j_fn, j_m, j_tmpl, j_data = jbnn.define_split_model_tree_log_prob(
            net(), "multi_class_linear_output", batches, 4, **kw)
        t_fn, t_m, t_tmpl, t_data = tbnn.define_split_model_tree_log_prob(
            net(), "multi_class_linear_output", batches, 4, device="cpu", **kw)
        j_theta = j_tmpl
        t_theta = [torch.as_tensor(np.asarray(leaf)) for leaf in jax.tree_util.tree_leaves(j_tmpl)]
    assert j_m == t_m == 4
    assert t_data[0].shape == (4, NS // 4, 4)
    total = 0.0
    for m in range(4):
        j_val, j_grad = jax.value_and_grad(lambda t: j_fn(t, m, j_data))(j_theta)
        t_grad, t_val = torch.func.grad_and_value(lambda t: t_fn(t, m, t_data))(t_theta)
        np.testing.assert_allclose(float(t_val), float(j_val), rtol=1e-5)
        for tl, jl in zip(jax.tree_util.tree_leaves(t_grad), jax.tree_util.tree_leaves(j_grad)):
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl.reshape(tl.shape), rtol=0,
                                       atol=1e-5 * np.abs(jl).max())
        total = total + t_val
    if form == "flat":
        # the M terms sum to the full-data potential (the prior counted once)
        xs, ys = (t.reshape((-1,) + tuple(t.shape[2:])) for t in t_data)
        full, _, _ = tbnn.define_model_log_prob(net(), "multi_class_linear_output", xs, ys,
                                                tau_list=kw["tau_list"], tau_out=2.0,
                                                device="cpu")
        np.testing.assert_allclose(float(total), float(full(t_theta)), rtol=1e-5)


def replay_driver_noise(monkeypatch, noise):
    """Hand one chain's replayed (z, log_u[, perm]) to the port's driver."""
    monkeypatch.setattr(t_driver, "draw_noise",
                        lambda k, n, c, dim, dt, dev: (noise[0][n][None], noise[1][n][None]))
    monkeypatch.setattr(t_driver, "draw_aux_noise",
                        lambda k, n, c, kind, size, dt, dev: noise[2][n][None])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sample_split_model_matches_jax(scheme, monkeypatch):
    batches, _, _ = loader("reg")
    kw = dict(num_splits=4, model_loss="regression", num_samples=5, num_steps_per_sample=3,
              step_size=0.01, tau_out=20.0, verbose=False, debug=2)
    key = jax.random.key(6)
    j_s, j_acc = jht.sample_split_model(net("reg"), batches, key=key,
                                        integrator=getattr(jht.Integrator, scheme), **kw)
    dim = j_s.shape[1]
    replay_driver_noise(monkeypatch, split_noise(key, 1, 5, dim, jnp.float32, chains=False,
                                                 num_terms=4))
    t_s, t_acc = tht.sample_split_model(net("reg"), batches, key=0, device="cpu",
                                        integrator=getattr(tht.Integrator, scheme), **kw)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-5)
    assert t_acc == pytest.approx(j_acc, abs=1e-6)
    assert 0 < j_acc


@pytest.mark.parametrize("store_on_GPU", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sample_splitting_matches_jax(scheme, store_on_GPU, monkeypatch):
    kw = dict(num_samples=6, num_steps_per_sample=3, step_size=0.9, burn=1, verbose=False,
              debug=2)
    key = jax.random.key(8)
    with jax.enable_x64(True):
        j_s, j_acc = jht.sample(terms(jnp), jnp.zeros(2) + 0.3,
                                integrator=getattr(jht.Integrator, scheme), key=key, **kw)
        replay_driver_noise(monkeypatch, split_noise(key, 1, 6, 2, jnp.float64, chains=False))
    t_s, t_acc = tht.sample(terms(torch), torch.zeros(2, dtype=torch.float64) + 0.3,
                            integrator=getattr(tht.Integrator, scheme), key=0,
                            store_on_GPU=store_on_GPU, **kw)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-10)
    assert t_acc == pytest.approx(j_acc, abs=1e-12)


def test_sample_splitting_per_term_pass_grad_matches_autograd():
    grads = [torch.func.grad(f) for f in terms(torch)]
    kw = dict(num_samples=5, num_steps_per_sample=3, step_size=0.5, verbose=False, key=2,
              integrator=tht.Integrator.SPLITTING)
    auto = tht.sample(terms(torch), torch.zeros(2, dtype=torch.float64), **kw)
    user = tht.sample(terms(torch), torch.zeros(2, dtype=torch.float64), pass_grad=grads, **kw)
    torch.testing.assert_close(user, auto, rtol=0, atol=1e-12)
    with pytest.raises(RuntimeError, match="per-term"):
        t_split.run_split_hmc(0, terms(torch), torch.zeros(2), tht.MCMCConfig(num_samples=2),
                              pass_grad=grads[:1])
    with pytest.raises(ValueError, match="adapt_mass is not supported for splitting"):
        t_split.run_split_hmc(0, terms(torch), torch.zeros(2),
                              tht.MCMCConfig(num_samples=3, burn=1, adapt_mass=True))
    with pytest.raises(ValueError, match="train_loader yielded no batches"):
        tht.sample_split_model(net(), [], device="cpu")


def test_to_inference_dict_on_split_results():
    from hamiltorch_tpu import diagnostics as jdiag
    from hamiltorch_tpu_torch import diagnostics as tdiag

    cfg = dict(num_samples=3, num_steps_per_sample=2, step_size=0.5)
    j = j_split.run_split_hmc_chains(jax.random.key(0), stacked_term(jnp), M, jnp.zeros(2),
                                     jht.MCMCConfig(**cfg), 2, data=jnp.asarray(DATA))
    t = t_split.run_split_hmc_chains(0, stacked_term(torch), M, torch.zeros(2),
                                     tht.MCMCConfig(**cfg), 2,
                                     data=torch.as_tensor(DATA, dtype=torch.float32))
    got, want = tdiag.to_inference_dict(t), jdiag.to_inference_dict(j)
    for part in ("posterior", "sample_stats"):
        assert sorted(got[part]) == sorted(want[part])
        for name in want[part]:
            assert got[part][name].shape == np.asarray(want[part][name]).shape
