"""Port vs JAX package: Riemannian-manifold HMC (``ops/metrics.py``, the
implicit, explicit and midpoint integrators, ``samplers/rmhmc.py`` and the
RMHMC branch of ``sample``).

Inputs are drawn with numpy from a seed; the samplers run on the JAX
driver's own noise, replayed here (``split(fold_in(key, n))`` into a
proposal and a Metropolis key, the proposal key split into the momentum
normal and the jitter uniform; chains take ``split(key, C)[c]``).  Float64
comparisons run under ``jax.enable_x64(True)``.

Tolerances: the metric pipeline (H, dH/dtheta, dH/dp, the momentum) within
1e-10 relative in float64; softabs and its vjp within 1e-10; one trajectory
within 1e-10 with identical fixed-point iteration counts, each fixed-point
residual asserted at least 1e-6 (relative) from the threshold so that no
decision sits within rounding of it; the samplers: identical accepts and
fp_iters, samples within 1e-8 in float64 and 1e-5 in float32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu.integrators import explicit as j_explicit
from hamiltorch_tpu.integrators import implicit as j_implicit
from hamiltorch_tpu.integrators import midpoint as j_midpoint
from hamiltorch_tpu.ops import metrics as jm
from hamiltorch_tpu.samplers import rmhmc as j_rmhmc
from hamiltorch_tpu_torch.integrators import explicit as t_explicit
from hamiltorch_tpu_torch.integrators import implicit as t_implicit
from hamiltorch_tpu_torch.integrators import midpoint as t_midpoint
from hamiltorch_tpu_torch.ops import metrics as tm
from hamiltorch_tpu_torch.samplers import driver as t_driver
from hamiltorch_tpu_torch.samplers import rmhmc as t_rmhmc

PREC4 = np.array([[2.0, 0.6, 0.0, 0.1], [0.6, 1.0, 0.2, 0.0],
                  [0.0, 0.2, 1.5, -0.3], [0.1, 0.0, -0.3, 0.8]])


def banana(xp):
    def lp(t):
        x, y = t[0], t[1]
        return -0.5 * (x ** 2 / 4.0) - 0.5 * ((y - 0.1 * (x ** 2 - 4.0)) ** 2) / 0.5
    return lp


def funnel(xp):
    def lp(t):
        v, x = t[0], t[1:]
        return -0.5 * v ** 2 / 9.0 - 0.5 * xp.sum(x ** 2) * xp.exp(-v) - 0.5 * 4 * v
    return lp


def quartic(xp, dtype=None):
    prec = jnp.asarray(PREC4) if xp is jnp else torch.as_tensor(PREC4)
    if dtype is not None:
        prec = prec.astype(dtype) if xp is jnp else prec.to(dtype)

    def lp(t):
        return -0.5 * t @ prec @ t - 0.025 * xp.sum(t ** 4)
    return lp


TARGETS = {"banana": (banana, 2), "funnel": (funnel, 5), "quartic": (quartic, 4)}


def funnel_metric(xp):
    """An analytic SPD metric for the funnel (the JAX tests' form)."""
    def g(t):
        v = t[0]
        diag = xp.concatenate([xp.ones(1, dtype=t.dtype) * (1.0 / 9.0 + 2.0),
                               xp.ones(4, dtype=t.dtype) * xp.exp(-v)])
        return xp.diag(diag)
    return g


def ham_func(xp):
    return lambda t: 0.5 * xp.sum(t ** 2) * 0.1


def states(d, chains=3, seed=0, scale=0.4):
    rs = np.random.RandomState(seed)
    return (scale * rs.randn(chains, d), rs.randn(chains, d), rs.rand(chains, d),
            rs.randn(chains, d))


def options(lib, metric, jitter=None, alpha=1e2, **kw):
    m = getattr(lib.Metric, metric)
    mod = jm if lib is jht else tm
    return mod.RMOptions(metric=m, jitter=jitter, softabs_const=alpha, **kw)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# --- softabs -----------------------------------------------------------------

def test_softabs_eigenvalues_and_derivative_match_jax():
    eigs = np.array([-3.0, -0.5, -1e-9, 0.0, 1e-12, 1e-6, 0.02, 0.7, 25.0])
    with jax.enable_x64(True):
        for alpha in (1.5, 1e2, 1e6):
            for t_fn, j_fn in ((tm.softabs_eigenvalues, jm.softabs_eigenvalues),
                               (tm._softabs_derivative, jm._softabs_derivative)):
                got = t_fn(torch.as_tensor(eigs), alpha).numpy()
                want = np.asarray(j_fn(jnp.asarray(eigs), alpha))
                np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def softabs_np(a, alpha):
    eigs = np.linalg.eigvalsh(a)
    return tm.softabs_eigenvalues(torch.as_tensor(eigs), alpha).numpy()


def _rotated(eigs, seed):
    q, _ = np.linalg.qr(np.random.RandomState(seed).randn(len(eigs), len(eigs)))
    return (q * np.asarray(eigs)) @ q.T


SOFTABS_CASES = {
    "repeated": _rotated([2.0, 2.0, 2.0, -1.0, 0.5], 1),
    "random": _rotated([-1.3, 0.2, 0.9, 2.5, -0.01], 2),
    "zero_and_repeated_negative": _rotated([0.0, -0.7, -0.7, 1e-9, 3.0], 3),
    "exactly_repeated_diagonal": np.diag([2.0, 2.0, 2.0, -1.0, 0.5]),
}


@pytest.mark.parametrize("case", sorted(SOFTABS_CASES))
def test_softabs_transform_and_its_vjp_match_jax(case):
    a = SOFTABS_CASES[case]
    rs = np.random.RandomState(7)
    g_bar = rs.randn(5, 5)
    alpha = 10.0
    # an eigenvalue's own derivative is defined only up to the basis of its
    # eigenspace: where eigenvalues repeat, the cotangent of lam must be
    # equal on the repeated ones, as the log-determinant's 1/lam is
    lam_bar = rs.randn(5) if case == "random" else 1.0 / softabs_np(a, alpha)
    with jax.enable_x64(True):
        (j_g, j_lam), vjp = jax.vjp(lambda m: jm.softabs_transform(m, alpha), jnp.asarray(a))
        (j_abar,) = vjp((jnp.asarray(g_bar), jnp.asarray(lam_bar)))
    at = torch.as_tensor(a).requires_grad_()
    t_g, t_lam = tm.softabs_transform(at, alpha)
    (t_abar,) = torch.autograd.grad((t_g * torch.as_tensor(g_bar)).sum()
                                    + (t_lam * torch.as_tensor(lam_bar)).sum(), at)
    assert np.all(np.isfinite(t_abar.numpy()))
    np.testing.assert_allclose(t_g.detach().numpy(), np.asarray(j_g), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t_lam.detach().numpy(), np.asarray(j_lam), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t_abar.numpy(), np.asarray(j_abar), rtol=0, atol=1e-10)
    if case == "exactly_repeated_diagonal":
        # what the Function replaces: eigh's own backward at a repeated eigenvalue
        a2 = torch.as_tensor(a).requires_grad_()
        _, vecs = torch.linalg.eigh(a2)
        (own,) = torch.autograd.grad((vecs * torch.as_tensor(g_bar)).sum(), a2)
        assert not torch.all(torch.isfinite(own))


def test_softabs_of_a_non_finite_matrix_is_nan_as_in_jax():
    """torch.linalg.eigh raises on NaN or inf input; the Function returns NaN
    for that matrix alone (as JAX's eigh does), here under vmap in a batch,
    and a run whose trajectories blow up rejects instead of raising."""
    good = SOFTABS_CASES["random"]
    bad = np.full((5, 5), np.nan)
    huge = np.diag([1e20, 1.0, 1.0, 1.0, 1.0])
    with jax.enable_x64(True):
        want = np.asarray(jm.softabs_transform(jnp.asarray(bad), 10.0)[1])
    assert np.isnan(want).all()
    g, lam = torch.func.vmap(lambda m: tm.softabs_transform(m, 10.0))(
        torch.as_tensor(np.stack([good, bad, good])))
    assert torch.isnan(lam[1]).all() and torch.isnan(g[1]).all()
    assert torch.equal(lam[0], lam[2]) and bool(torch.isfinite(lam[0]).all())
    _, lam32 = tm.softabs_transform(torch.as_tensor(huge, dtype=torch.float32), 10.0)
    assert torch.isnan(lam32).all()
    res = tht.run_rmhmc_chains(0, funnel(torch), torch.full((5,), 0.5), tht.MCMCConfig(
        num_samples=2, num_steps_per_sample=3, step_size=50.0), 2, metric=tht.Metric.SOFTABS,
        fixed_point_max_iterations=3)
    assert bool(res.stats.divergent.all()) and not bool(res.stats.accepted.any())


def test_softabs_under_vmap_and_grad():
    """torch.func.vmap over torch.func.grad of the Function equals the plain
    autograd result matrix by matrix, repeated eigenvalues included."""
    mats = np.stack([SOFTABS_CASES[k] for k in sorted(SOFTABS_CASES)])
    w = np.random.RandomState(8).randn(5, 5)

    def loss(m):
        g, lam = tm.softabs_transform(m, 10.0)
        return (g * torch.as_tensor(w)).sum() + torch.log(lam).sum()

    got = torch.func.vmap(torch.func.grad(loss))(torch.as_tensor(mats))
    for i, m in enumerate(mats):
        mt = torch.as_tensor(m).requires_grad_()
        (want,) = torch.autograd.grad(loss(mt), mt)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert torch.all(torch.isfinite(got))


# --- the Riemannian Hamiltonian ----------------------------------------------

# (target, metric, jitter, S3 with ham_func, custom metric)
HAM_CASES = {
    "quartic-hessian": ("quartic", "HESSIAN", None, False, False),
    "quartic-hessian-jitter": ("quartic", "HESSIAN", 0.3, False, False),
    "quartic-softabs": ("quartic", "SOFTABS", None, False, False),
    "quartic-jacobian-diag-jitter": ("quartic", "JACOBIAN_DIAG", 0.5, False, False),
    "banana-softabs": ("banana", "SOFTABS", None, False, False),
    "banana-jacobian-diag-jitter": ("banana", "JACOBIAN_DIAG", 0.1, False, False),
    "funnel-softabs": ("funnel", "SOFTABS", None, False, False),
    "funnel-softabs-jitter": ("funnel", "SOFTABS", 0.2, False, False),
    "funnel-s3-ham-func": ("funnel", "SOFTABS", None, True, False),
    "funnel-custom-metric": ("funnel", "HESSIAN", None, False, True),
}


def both_hamiltonians(target, metric, jitter, semi, custom, alpha=1e2):
    make, d = TARGETS[target]
    kw_j = dict(semi_separable=semi, ham_func=ham_func(jnp) if semi else None,
                custom_metric=funnel_metric(jnp) if custom else None)
    kw_t = dict(semi_separable=semi, ham_func=ham_func(torch) if semi else None,
                custom_metric=funnel_metric(torch) if custom else None)
    j_rm = jm.make_rm_hamiltonian(make(jnp), options(jht, metric, jitter, alpha), **kw_j)
    t_rm = tm.make_rm_hamiltonian(make(torch), options(tht, metric, jitter, alpha), **kw_t)
    return j_rm, t_rm, d


@pytest.mark.parametrize("case", sorted(HAM_CASES))
def test_hamiltonian_matches_jax(case):
    target, metric, jitter, semi, custom = HAM_CASES[case]
    with jax.enable_x64(True):
        j_rm, t_rm, d = both_hamiltonians(target, metric, jitter, semi, custom)
        theta, p, ju, z = states(d)
        jj = jnp.asarray(ju) if jitter else None
        tj = torch.as_tensor(ju) if jitter else None
        t_b = tm.batched(t_rm, jitter is not None)
        targs = (torch.as_tensor(theta), torch.as_tensor(p), tj)
        for name in ("ham", "grad_theta", "grad_p"):
            j_fn = getattr(j_rm, name)
            want = jax.jit(jax.vmap(lambda a, b, c: j_fn(a, b, c),
                                    in_axes=(0, 0, 0 if jitter else None)))(
                jnp.asarray(theta), jnp.asarray(p), jj)
            got = getattr(t_b, name)(*targs)
            assert np.all(np.isfinite(np.asarray(want))), name
            assert rel(got.numpy(), want) <= 1e-10, (name, rel(got.numpy(), want))
        # the momentum: the JAX draw's normal through chol(G)
        keys = jax.random.split(jax.random.key(5), theta.shape[0])
        jz = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float64))(keys)
        want = jax.jit(jax.vmap(lambda k, a, c: j_rm.sample_momentum(k, a, c),
                                in_axes=(0, 0, 0 if jitter else None)))(keys, jnp.asarray(theta), jj)
        got = t_b.sample_momentum(torch.as_tensor(np.asarray(jz)), targs[0], tj)
        assert rel(got.numpy(), want) <= 1e-10


def test_a_metric_that_is_not_spd_gives_nan_and_a_rejection():
    """HESSIAN on the funnel away from its mode is indefinite: NaN, no
    exception (JAX's Cholesky gives NaN there too), and the driver rejects."""
    theta = np.array([-1.0, 2.0, 0.5, -1.5, 1.0])
    with jax.enable_x64(True):
        j_rm, t_rm, _ = both_hamiltonians("funnel", "HESSIAN", None, False, False)
        p = np.ones(5)
        assert np.isnan(float(j_rm.ham(jnp.asarray(theta), jnp.asarray(p), None)))
    t_val = t_rm.ham(torch.as_tensor(theta), torch.as_tensor(p), None)
    assert torch.isnan(t_val)
    g = t_rm.metric(torch.as_tensor(theta), None).g
    assert torch.linalg.eigvalsh(g).min() < 0
    res = tht.run_rmhmc(0, funnel(torch), torch.as_tensor(theta),
                        tht.MCMCConfig(num_samples=2, num_steps_per_sample=2, step_size=0.1),
                        metric=tht.Metric.HESSIAN, fixed_point_max_iterations=3)
    assert bool(res.stats.divergent.all()) and not bool(res.stats.accepted.any())
    assert torch.equal(res.samples[-1], torch.as_tensor(theta))


# --- one trajectory ----------------------------------------------------------

@pytest.fixture
def residuals(monkeypatch):
    """Every fixed-point residual the port computes, per lane."""
    seen = []
    inner = t_implicit._fixed_point

    def recording(update_fn, x0, threshold, max_iters):
        def update(x):
            x_new = update_fn(x)
            seen.append(torch.amax((x_new - x) ** 2, dim=tuple(range(1, x.ndim))))
            return x_new
        return inner(update, x0, threshold, max_iters)

    monkeypatch.setattr(t_implicit, "_fixed_point", recording)
    monkeypatch.setattr(t_midpoint, "_fixed_point", recording)
    return seen


def assert_margin(seen, threshold, margin):
    d = torch.cat(seen).numpy()
    d = d[np.isfinite(d)]
    assert d.size and np.min(np.abs(d / threshold - 1.0)) >= margin


@pytest.mark.parametrize("integrator", ["IMPLICIT", "EXPLICIT", "MIDPOINT"])
def test_one_trajectory_matches_jax(integrator, residuals):
    thr = 1e-9
    with jax.enable_x64(True):
        j_rm, t_rm, d = both_hamiltonians("quartic", "SOFTABS", None, False, False)
        theta, p, _, _ = states(d, seed=3)
        kw = dict(fixed_point_threshold=thr, fixed_point_max_iterations=20,
                  explicit_binding_const=20.0)
        j_opts, t_opts = options(jht, "SOFTABS", **kw), options(tht, "SOFTABS", **kw)
        eps, steps = 0.2, 3
        j_fn = {"IMPLICIT": j_implicit.implicit_leapfrog,
                "MIDPOINT": j_midpoint.implicit_midpoint,
                "EXPLICIT": j_explicit.explicit_leapfrog}[integrator]
        t_fn = {"IMPLICIT": t_implicit.implicit_leapfrog,
                "MIDPOINT": t_midpoint.implicit_midpoint,
                "EXPLICIT": t_explicit.explicit_leapfrog}[integrator]
        want = jax.jit(jax.vmap(lambda a, b: j_fn(j_rm, j_opts, a, b, eps, steps, None)))(
            jnp.asarray(theta), jnp.asarray(p))
        got = t_fn(tm.batched(t_rm, False), t_opts, torch.as_tensor(theta), torch.as_tensor(p),
                   torch.full((3,), eps, dtype=torch.float64), steps, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-10)
    if integrator == "EXPLICIT":
        np.testing.assert_allclose(got.p_copy.numpy(), np.asarray(want.p_copy), atol=1e-10)
        return
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.all(got[2].numpy() < 20)  # converged, not capped
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4)
    assert_margin(residuals, thr, 1e-6)


def test_fixed_point_lanes_freeze_and_nan_stops_its_lane():
    """A lane that converges keeps its value while others iterate; a NaN
    difference stops its lane with residual -inf (the JAX while_loop's)."""
    target = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)

    def update(x):
        out = 0.5 * (x + target[:, None])
        out[2] = torch.nan  # lane 2 diverges at once
        return out

    x, iters, res = t_implicit._fixed_point(update, torch.zeros(3, 1, dtype=torch.float64),
                                            1e-6, 50)
    assert iters[2] == 1 and res[2] == -math.inf and torch.isnan(x[2]).all()
    assert 0 < iters[0] < iters[1] < 50  # lane 0 converged first and kept its value
    assert bool((res[:2] <= 1e-6).all())
    np.testing.assert_allclose(x[:2, 0].numpy(), [1.0, 2.0], atol=2e-3)
    capped = t_implicit._fixed_point(lambda x: x + 1.0, torch.zeros(2, 1), 1e-6, 4)
    assert capped[1].tolist() == [4, 4] and torch.equal(capped[0], torch.full((2, 1), 4.0))


# --- the samplers --------------------------------------------------------------

def rm_noise(key, num_chains, num_samples, d, dtype, chains=True):
    """The JAX RMHMC driver's per-draw (z, log_u, jitter_u): (S, C, ...)
    for ``run_rmhmc_chains`` (chain keys ``split(key, C)``), (S, ...) for
    ``run_rmhmc`` (the key itself)."""

    def one(k, n):
        k_prop, k_mh = jax.random.split(jax.random.fold_in(k, n))
        k_mom, k_jit = jax.random.split(k_prop)
        return (jax.random.normal(k_mom, (d,), dtype),
                jnp.log(jax.random.uniform(k_mh, (), dtype)),
                jax.random.uniform(k_jit, (d,), dtype))

    def per_key(k):
        return jax.vmap(lambda n: one(k, n))(jnp.arange(num_samples))

    if not chains:
        return tuple(torch.as_tensor(np.asarray(a)) for a in per_key(key))
    out = jax.vmap(per_key)(jax.random.split(key, num_chains))
    return tuple(torch.as_tensor(np.swapaxes(np.asarray(a), 0, 1).copy()) for a in out)


def assert_runs_match(t_res, j_res, atol):
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    np.testing.assert_array_equal(t_res.stats.fp_iters.numpy(), np.asarray(j_res.stats.fp_iters))
    np.testing.assert_array_equal(t_res.stats.divergent.numpy(), np.asarray(j_res.stats.divergent))
    np.testing.assert_allclose(t_res.samples.numpy(), np.asarray(j_res.samples), rtol=0, atol=atol)


# (integrator, metric, jitter, dtype[, thin])
RUN_CASES = {
    "implicit-softabs-f64": ("IMPLICIT", "SOFTABS", None, "float64"),
    "implicit-softabs-thin2-f64": ("IMPLICIT", "SOFTABS", None, "float64", 2),
    "explicit-softabs-f64": ("EXPLICIT", "SOFTABS", None, "float64"),
    "midpoint-softabs-jitter-f64": ("MIDPOINT", "SOFTABS", 0.05, "float64"),
    "s3-jacobian-diag-jitter-f64": ("S3", "JACOBIAN_DIAG", 0.1, "float64"),
    "implicit-softabs-f32": ("IMPLICIT", "SOFTABS", None, "float32"),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_rmhmc_chains_matches_jax(case):
    integrator, metric, jitter, dtype, *thin = RUN_CASES[case]
    f64 = dtype == "float64"
    thin = thin[0] if thin else 1
    chains, draws = 2, 3 * thin
    # with thin > 1 the fixed-point stats are maxed over each window
    cfg = dict(num_samples=draws, num_steps_per_sample=2, step_size=0.3, thin=thin)
    kw = dict(metric=metric, jitter=jitter, softabs_const=1e2, fixed_point_max_iterations=6,
              fixed_point_threshold=1e-6 if f64 else 1e-5)
    key = jax.random.key(11)
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        j_res = j_rmhmc.run_rmhmc_chains(
            key, banana(jnp), jnp.zeros(2, jdt) + 0.5, jht.MCMCConfig(**cfg), chains,
            integrator=getattr(jht.Integrator, integrator),
            **dict(kw, metric=getattr(jht.Metric, metric)))
        noise = rm_noise(key, chains, draws, 2, jdt)
    t_res = tht.run_rmhmc_chains(
        0, banana(torch), torch.zeros(2, dtype=getattr(torch, dtype)) + 0.5,
        tht.MCMCConfig(**cfg), chains, integrator=getattr(tht.Integrator, integrator),
        _noise=noise if jitter else noise[:2], **dict(kw, metric=getattr(tht.Metric, metric)))
    assert 0 < np.asarray(j_res.stats.accepted).mean() or integrator == "EXPLICIT"
    assert_runs_match(t_res, j_res, 1e-8 if f64 else 1e-5)
    np.testing.assert_allclose(t_res.stats.fp_residual.numpy(), np.asarray(j_res.stats.fp_residual),
                               rtol=1e-3 if f64 else 5e-2, atol=1e-30)


def test_run_rmhmc_single_chain_and_tree_state_match_jax():
    cfg = dict(num_samples=3, num_steps_per_sample=2, step_size=0.3)
    kw = dict(metric="SOFTABS", softabs_const=1e2, fixed_point_max_iterations=5,
              fixed_point_threshold=1e-6)
    key = jax.random.key(4)
    with jax.enable_x64(True):
        j_res = j_rmhmc.run_rmhmc(key, banana(jnp), jnp.array([0.5, -0.2]), jht.MCMCConfig(**cfg),
                                  **dict(kw, metric=jht.Metric.SOFTABS))
        noise = rm_noise(key, 1, 3, 2, jnp.float64, chains=False)
    t_flat = tht.run_rmhmc(0, banana(torch), torch.tensor([0.5, -0.2], dtype=torch.float64),
                           tht.MCMCConfig(**cfg), _noise=noise[:2],
                           **dict(kw, metric=tht.Metric.SOFTABS))
    assert_runs_match(t_flat, j_res, 1e-8)

    # a tree state ravels once at the boundary: the flat run's numbers, bit for bit
    def tree_lp(t):
        return banana(torch)(torch.cat([t["a"], t["b"]]))

    t_tree = tht.run_rmhmc(0, tree_lp, {"a": torch.tensor([0.5], dtype=torch.float64),
                                        "b": torch.tensor([-0.2], dtype=torch.float64)},
                           tht.MCMCConfig(**cfg), _noise=noise[:2],
                           **dict(kw, metric=tht.Metric.SOFTABS))
    assert t_tree.samples["a"].shape == (3, 1)
    assert torch.equal(torch.cat([t_tree.samples["a"], t_tree.samples["b"]], dim=1),
                       t_flat.samples)
    chains = tht.run_rmhmc_chains(0, tree_lp, {"a": torch.zeros(4, 1), "b": torch.ones(4, 1)},
                                  tht.MCMCConfig(num_samples=2, num_steps_per_sample=1),
                                  4, metric=tht.Metric.SOFTABS, softabs_const=1e2,
                                  fixed_point_max_iterations=3)
    assert chains.samples["a"].shape == (4, 2, 1) and chains.final_state.theta["b"].shape == (4, 1)


def test_jitter_is_drawn_once_per_transition_and_chunks_reproduce():
    """The jitter uniform comes from the chain's own stream keyed on
    (seed, chain, draw): two runs of 2 + 2 draws continue a 4-draw run."""
    cfg = tht.MCMCConfig(num_samples=4, num_steps_per_sample=1, step_size=0.3)
    kw = dict(metric=tht.Metric.JACOBIAN_DIAG, jitter=0.5, fixed_point_max_iterations=4)
    lp = quartic(torch, torch.float32)
    full = t_rmhmc._run_rmhmc_batched(3, torch.full((2, 4), 0.3), lp, cfg,
                                      *t_rmhmc.resolve_rmhmc_options(kw))
    half = tht.MCMCConfig(num_samples=2, num_steps_per_sample=1, step_size=0.3)
    a = t_rmhmc._run_rmhmc_batched(3, torch.full((2, 4), 0.3), lp, half,
                                   *t_rmhmc.resolve_rmhmc_options(kw))
    b = t_rmhmc._run_rmhmc_batched(3, torch.full((2, 4), 0.3), lp, half, *t_rmhmc.resolve_rmhmc_options(kw),
                                   init_state=a.final_state, init_da=a.final_da, start_iter=2)
    assert torch.equal(torch.cat([a.samples, b.samples], dim=1), full.samples)
    assert torch.equal(torch.cat([a.stats.fp_iters, b.stats.fp_iters], dim=1), full.stats.fp_iters)


# --- sample() ------------------------------------------------------------------

def replay_sample_noise(monkeypatch, key, num_samples, d, dtype):
    """sample() runs run_rmhmc on the JAX key itself: hand its draws to the
    port's driver in place of the port's own."""
    z, log_u, ju = rm_noise(key, 1, num_samples, d, dtype, chains=False)
    monkeypatch.setattr(t_driver, "draw_noise",
                        lambda k, n, c, dim, dt, dev: (z[n][None], log_u[n][None]))
    monkeypatch.setattr(t_driver, "draw_aux_noise",
                        lambda k, n, c, kind, size, dt, dev: ju[n][None])


@pytest.mark.parametrize("store_on_GPU", [True, False])
def test_sample_rmhmc_matches_jax(store_on_GPU, monkeypatch, capsys):
    kw = dict(num_samples=4, num_steps_per_sample=2, step_size=0.3, burn=1,
              softabs_const=1e2, fixed_point_max_iterations=5, fixed_point_threshold=1e-6,
              jitter=0.01, debug=2, verbose=False)
    key = jax.random.key(9)
    with jax.enable_x64(True):
        j_s, j_acc = jht.sample(banana(jnp), jnp.array([0.3, 0.1]), sampler=jht.Sampler.RMHMC,
                                integrator=jht.Integrator.MIDPOINT, metric=jht.Metric.SOFTABS,
                                key=key, **kw)
        replay_sample_noise(monkeypatch, key, 4, 2, jnp.float64)
    t_s, t_acc = tht.sample(banana(torch), torch.tensor([0.3, 0.1], dtype=torch.float64),
                            sampler=tht.Sampler.RMHMC, integrator=tht.Integrator.MIDPOINT,
                            metric=tht.Metric.SOFTABS, key=0, store_on_GPU=store_on_GPU, **kw)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-8)
    assert t_acc == pytest.approx(j_acc, abs=1e-12)
    # debug=1 prints one line a draw, as the JAX package's
    tht.sample(banana(torch), torch.tensor([0.3, 0.1], dtype=torch.float64),
               sampler=tht.Sampler.RMHMC, metric=tht.Metric.SOFTABS, key=0,
               **dict(kw, debug=1, num_samples=2, burn=0))
    assert capsys.readouterr().out.count("Step:") == 2


def test_to_inference_dict_on_rmhmc_results():
    from hamiltorch_tpu import diagnostics as jdiag
    from hamiltorch_tpu_torch import diagnostics as tdiag

    cfg = dict(num_samples=2, num_steps_per_sample=1, step_size=0.3)
    j = j_rmhmc.run_rmhmc_chains(jax.random.key(0), banana(jnp), jnp.zeros(2),
                                 jht.MCMCConfig(**cfg), 2, metric=jht.Metric.SOFTABS,
                                 softabs_const=1e2, fixed_point_max_iterations=3)
    t = tht.run_rmhmc_chains(0, banana(torch), torch.zeros(2), tht.MCMCConfig(**cfg), 2,
                             metric=tht.Metric.SOFTABS, softabs_const=1e2,
                             fixed_point_max_iterations=3)
    got, want = tdiag.to_inference_dict(t), jdiag.to_inference_dict(j)
    for part in ("posterior", "sample_stats"):
        assert sorted(got[part]) == sorted(want[part])
        for name in want[part]:
            assert got[part][name].shape == np.asarray(want[part][name]).shape


def _lp_j(t):
    return -0.5 * jnp.sum(t ** 2)


def _lp_t(t):
    return -0.5 * torch.sum(t ** 2)


# (sample kwargs, the error both packages raise)
VALIDATION_CASES = {
    "list-log-prob-with-rmhmc": (dict(sampler="RMHMC", as_list=True), RuntimeError,
                                 "list of log_prob"),
    "pass-grad-with-rmhmc": (dict(sampler="RMHMC", pass_grad=True), RuntimeError,
                             "user-determined gradients not implemented for RMHMC"),
    "adapt-mass-with-rmhmc": (dict(sampler="RMHMC", adapt_mass=True, burn=1), RuntimeError,
                              "adapt_mass"),
    "adapt-mass-with-splitting": (dict(integrator="SPLITTING", as_list=True, adapt_mass=True,
                                       burn=1), RuntimeError, "adapt_mass"),
    "splitting-without-a-list": (dict(integrator="SPLITTING"), RuntimeError,
                                 "must be list of functions"),
    "list-log-prob-with-nuts": (dict(sampler="NUTS", as_list=True), RuntimeError,
                                "list of log_prob"),
    "scalar-pass-grad-with-splitting": (dict(integrator="SPLITTING", as_list=True,
                                             pass_grad=True), RuntimeError, "per-term"),
    "short-pass-grad-list-with-splitting": (dict(integrator="SPLITTING", as_list=True,
                                                 pass_grad="short"), RuntimeError, "per-term"),
    "single-term-symmetric-splitting": (dict(integrator="SPLITTING", as_list="one"), RuntimeError,
                                        "greater than length 1"),
    "single-term-kmid-splitting": (dict(integrator="SPLITTING_KMID", as_list="one"), RuntimeError,
                                   "greater than length 1"),
}


def _sample_call(lib, lp, grad, case, x0):
    kw = dict(VALIDATION_CASES[case][0])
    as_list = kw.pop("as_list", False)
    pass_grad = kw.pop("pass_grad", None)
    for name, enum in (("sampler", lib.Sampler), ("integrator", lib.Integrator)):
        if name in kw:
            kw[name] = getattr(enum, kw[name])
    if as_list:
        lp = [lp] * (1 if as_list == "one" else 2)
    if pass_grad is True:
        pass_grad = grad
    elif pass_grad == "short":
        pass_grad = [grad]
    return lib.sample(lp, x0, num_samples=3, num_steps_per_sample=1, verbose=False, key=lib_key(lib),
                      pass_grad=pass_grad, **kw)


def lib_key(lib):
    return jax.random.key(0) if lib is jht else 0


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_sample_validations_match_jax(case):
    _, exc, match = VALIDATION_CASES[case]
    with pytest.raises(exc, match=match):
        _sample_call(jht, _lp_j, lambda t: -t, case, jnp.zeros(2))
    with pytest.raises(exc, match=match):
        _sample_call(tht, _lp_t, lambda t: -t, case, torch.zeros(2))


def test_runner_validations_match_jax():
    cfg_j = jht.MCMCConfig(num_samples=2, adapt_mass=True, burn=1)
    cfg_t = tht.MCMCConfig(num_samples=2, adapt_mass=True, burn=1)
    with pytest.raises(ValueError, match="adapt_mass is not supported for RMHMC"):
        j_rmhmc.run_rmhmc(jax.random.key(0), _lp_j, jnp.zeros(2), cfg_j)
    with pytest.raises(ValueError, match="adapt_mass is not supported for RMHMC"):
        tht.run_rmhmc(0, _lp_t, torch.zeros(2), cfg_t)
    for mod in (j_rmhmc, t_rmhmc):
        with pytest.raises(TypeError, match="unknown RMHMC options"):
            mod.resolve_rmhmc_options({"metric_name": 1})
        with pytest.raises(NotImplementedError, match="RMHMC integrator"):
            mod.resolve_rmhmc_options({"integrator": jht.Integrator.SPLITTING
                                       if mod is j_rmhmc else tht.Integrator.SPLITTING})
