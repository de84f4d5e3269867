"""Port vs JAX package: tree-doubling NUTS.

The JAX sampler draws its decisions from a key tree: ``split`` for the
momentum, ``split(., 4)`` per depth for the direction, the subtree and the
merge, and one more ``split`` per leaf.  The port pre-draws per draw and
chain ``z``, ``u_dir``, ``u_merge`` and ``u_leaf`` and takes them through
its ``_noise`` hook; the tests fill that hook by replaying the JAX key tree
(``jax_nuts_noise``), so both packages make the same decisions:

* one transition (flat D=5 and a dict tree, several chains at once so that
  lanes finish at different depths and leaves): positions, logp and
  gradient within 1e-5 relative, tree depth, leapfrogs and divergence
  identical, energy_new within 1e-5 relative; every U-turn dot product and
  every leaf-choice / merge / direction margin is >= 1e-4, so float32
  rounding cannot flip a decision;
* ``run_nuts``, ``run_nuts_chains`` and ``run_nuts_ensemble`` for a few
  float32 draws: samples within 1e-5 relative of max |theta|, the stats in
  the JAX layouts (chain-major for chains, time-major for the ensemble);
* dual averaging with diagonal and dense windowed warmup on a short
  schedule in float64 (dual averaging grows a float32 rounding difference
  by sqrt(t)/gamma a draw while it climbs): samples within 1e-10;
* ``sample(sampler=NUTS)`` against the JAX package's, ``store_on_GPU=False``
  equal to ``True`` bit for bit, and ``to_inference_dict`` on NUTS results.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.samplers.nuts as jnuts
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu.ops.mass import make_mass as jmake_mass
from hamiltorch_tpu.ops.mass import make_mass_tree as jmake_mass_tree
from hamiltorch_tpu_torch.diagnostics import to_inference_dict
from hamiltorch_tpu_torch.ops.mass import make_mass, make_mass_tree
from hamiltorch_tpu_torch.ops.potential import value_and_grad
from hamiltorch_tpu_torch.samplers import nuts as tnuts
from hamiltorch_tpu_torch.samplers.offload import run_nuts_host_offload
from hamiltorch_tpu_torch.utils.pytree import tree_leaves

D = 5
MAX_DEPTH = 5
RTOL = 1e-5
MARGIN = 1e-4

_rng = np.random.RandomState(0)
_A = _rng.randn(D, D)
PREC = (_A @ _A.T / D + np.eye(D)).astype(np.float32)
THETA0 = _rng.randn(D).astype(np.float32)


def jax_flat_lp(prec):
    jp = jnp.asarray(prec)
    return lambda t: -0.5 * t @ jp @ t + jnp.sum(jnp.sin(t))


def torch_flat_lp(prec):
    tp = torch.as_tensor(prec)
    return lambda t: -0.5 * t @ tp @ t + torch.sum(torch.sin(t))


def jax_tree_lp(t):
    return (-0.5 * jnp.sum((t["a"] / 0.7) ** 2) - 0.5 * jnp.sum((t["b"] - 0.3) ** 2 * 2.0)
            + jnp.sum(jnp.sin(t["b"])) - 0.25 * jnp.sum(t["a"]) ** 2)


def torch_tree_lp(t):
    return (-0.5 * torch.sum((t["a"] / 0.7) ** 2) - 0.5 * torch.sum((t["b"] - 0.3) ** 2 * 2.0)
            + torch.sum(torch.sin(t["b"])) - 0.25 * torch.sum(t["a"]) ** 2)


TREE0 = {"a": THETA0[:2], "b": THETA0[2:].reshape(3)}


def jax_nuts_noise(keys, dim, max_depth, dtype=jnp.float32, pad_to=None):
    """The port's noise for JAX transitions keyed by ``keys`` (S, C): the
    momentum normal and every uniform the key tree of ``nuts_transition``
    draws, in (S, C, ...) tensors; unused leaf slots (and the levels from
    ``max_depth`` up to ``pad_to``) hold 0.5.  Checks that the replayed
    direction is ``jax.random.bernoulli``'s."""
    pad_to = max_depth if pad_to is None else pad_to
    half = 1 << (pad_to - 1)

    def one(key):
        key, k_mom = jax.random.split(key)
        z = jax.random.normal(k_mom, (dim,), dtype)
        u_dir, go_right, u_merge, u_leaf = [], [], [], []
        for depth in range(max_depth):
            key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
            u_dir.append(jax.random.uniform(k_dir, (), dtype))
            go_right.append(jax.random.bernoulli(k_dir))
            u_merge.append(jax.random.uniform(k_merge, (), dtype))
            row = []
            for _ in range(1 << depth):
                k_sub, k_sel = jax.random.split(k_sub)
                row.append(jax.random.uniform(k_sel, (), dtype))
            row += [jnp.asarray(0.5, dtype)] * (half - len(row))
            u_leaf.append(jnp.stack(row))
        pad = [jnp.asarray(0.5, dtype)] * (pad_to - max_depth)
        u_leaf += [jnp.full(half, 0.5, dtype)] * (pad_to - max_depth)
        return (z, jnp.stack(u_dir + pad), jnp.stack(go_right + [False] * len(pad)),
                jnp.stack(u_merge + pad), jnp.stack(u_leaf))

    flat = keys.reshape(-1)
    z, u_dir, go_right, u_merge, u_leaf = jax.vmap(one)(flat)
    np.testing.assert_array_equal(np.asarray(go_right), np.asarray(u_dir) < 0.5)
    lead = tuple(keys.shape)
    out = {"z": z, "u_dir": u_dir, "u_merge": u_merge, "u_leaf": u_leaf}
    return {k: torch.as_tensor(np.array(v).reshape(lead + v.shape[1:])) for k, v in out.items()}


def run_keys(key, num_samples):
    """(S, 1): run_nuts's per-draw keys fold_in(key, n)."""
    return jax.vmap(lambda n: jax.random.fold_in(key, n))(jnp.arange(num_samples))[:, None]


def chain_keys(keys, num_samples):
    """(S, C): per-chain keys folded with each draw index."""
    return jax.vmap(lambda n: jax.vmap(lambda k: jax.random.fold_in(k, n))(keys))(
        jnp.arange(num_samples))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def margin_recorder():
    margins = []

    def record(margin, live):
        margins.append(torch.where(live, margin, torch.full_like(margin, torch.inf)).min())

    return margins, record


def test_popcount():
    want = [bin(v).count("1") for v in range(1024)]
    assert [tnuts._popcount(v) for v in range(1024)] == want
    got = tnuts._popcount(torch.arange(1024, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax.vmap(jnuts._popcount)(jnp.arange(1024))), want)


SCALES = np.array([0.05, 0.3, 1.0, 1.0, 3.0], np.float32)


def jax_stiff_lp(t):
    flat = jnp.concatenate([t["a"], t["b"]]) if isinstance(t, dict) else t
    return -0.5 * jnp.sum((flat / jnp.asarray(SCALES)) ** 2) + jnp.sum(jnp.sin(flat))


def torch_stiff_lp(t):
    flat = torch.cat([t["a"], t["b"]]) if isinstance(t, dict) else t
    return -0.5 * torch.sum((flat / torch.as_tensor(SCALES)) ** 2) + torch.sum(torch.sin(flat))


@pytest.mark.parametrize("form", ["flat", "tree"])
@pytest.mark.parametrize("step", [0.02, 0.2])
def test_transition_matches_jax(form, step):
    """Sixteen chains in one batch, each from its own start on its own key,
    against the JAX transition vmapped over the keys, on a stiff target
    (scales 0.05 to 3): at step 0.02 the chains stop at depths 1 to 6, some
    inside a subtree; at 0.2 the stiff direction diverges."""
    chains, depth = 16, 6
    keys = jax.random.split(jax.random.key(11), chains)
    starts = THETA0[None] * np.linspace(0.2, 2.5, chains, dtype=np.float32)[:, None]
    if form == "flat":
        j_theta, t_theta = jnp.asarray(starts), torch.as_tensor(starts)
        j_mass, t_mass = jmake_mass(None, D), make_mass(None, D)
    else:
        j_theta = {"a": jnp.asarray(starts[:, :2]), "b": jnp.asarray(starts[:, 2:])}
        t_theta = {"a": torch.as_tensor(starts[:, :2]), "b": torch.as_tensor(starts[:, 2:])}
        inv = {"a": np.array([0.8, 1.3], np.float32), "b": np.array([1.0, 0.6, 1.4], np.float32)}
        template = {"a": np.zeros(2, np.float32), "b": np.zeros(3, np.float32)}
        j_mass = jmake_mass_tree({k: jnp.asarray(v) for k, v in inv.items()}, template)
        t_mass = make_mass_tree({k: torch.as_tensor(v) for k, v in inv.items()},
                                {k: torch.as_tensor(v) for k, v in template.items()})
    vg = jax.value_and_grad(jax_stiff_lp)
    j_out = jax.vmap(lambda k, t: jnuts.nuts_transition(vg, j_mass, depth)(
        k, t, *vg(t), jnp.float32(step)))(keys, j_theta)
    noise = {k: v[0] for k, v in jax_nuts_noise(keys[None], D, depth).items()}

    t_vg = torch.func.vmap(value_and_grad(torch_stiff_lp))
    logp, grad = t_vg(t_theta)
    bmass = tnuts.BatchedMass(lambda _: t_mass, None, per_chain=False)
    margins, record = margin_recorder()
    t_out = tnuts.nuts_transition(t_vg, bmass, depth)(
        noise, t_theta, logp, grad, torch.full((chains,), step), record)

    for got, want in zip(t_out[:3], j_out[:3]):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert rel_err(a, b) <= RTOL
    t_info, j_info = t_out[3], j_out[3]
    for f in ("tree_depth", "num_leapfrogs", "divergent"):
        np.testing.assert_array_equal(getattr(t_info, f).numpy(), np.asarray(getattr(j_info, f)))
    for f in ("energy", "energy_new", "accept_prob"):
        assert rel_err(getattr(t_info, f), getattr(j_info, f)) <= RTOL, f
    assert min(float(m) for m in margins) >= MARGIN
    depths = t_info.tree_depth.numpy()
    if step == 0.2:
        assert t_info.divergent.any()
    else:
        assert depths.min() < depths.max()
        if form == "flat":  # chains that stopped inside a subtree
            assert np.any(t_info.num_leapfrogs.numpy() != 2 ** depths - 1)


def _compare_runs(t_res, t_info, j_res, j_info, time_major=False):
    for a, b in zip(tree_leaves(t_res.samples), jax.tree_util.tree_leaves(j_res.samples)):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel_err(a, b) <= RTOL
    for f in ("tree_depth", "num_leapfrogs", "divergent"):
        np.testing.assert_array_equal(getattr(t_info, f).numpy(), np.asarray(getattr(j_info, f)))
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    for f in ("accept_prob", "energy_old", "energy_new", "step_size"):
        assert rel_err(getattr(t_res.stats, f), getattr(j_res.stats, f)) <= RTOL, f
    assert tuple(t_res.stats.accept_prob.shape) == tuple(np.shape(j_res.stats.accept_prob))
    assert rel_err(t_res.acc_rate, j_res.acc_rate) <= RTOL


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_run_nuts_matches_jax(form):
    draws = 6
    config = dict(num_samples=draws, step_size=0.5, max_tree_depth=MAX_DEPTH)
    key = jax.random.key(3)
    if form == "flat":
        j = jnuts.run_nuts(key, jax_flat_lp(PREC), jnp.asarray(THETA0), jnuts.NUTSConfig(**config))
        theta0 = torch.as_tensor(THETA0)
        lp = torch_flat_lp(PREC)
    else:
        j = jnuts.run_nuts(key, jax_tree_lp, {k: jnp.asarray(v) for k, v in TREE0.items()},
                           jnuts.NUTSConfig(**config))
        theta0 = {k: torch.as_tensor(v) for k, v in TREE0.items()}
        lp = torch_tree_lp
    noise = jax_nuts_noise(run_keys(key, draws), D, MAX_DEPTH)
    margins = []
    t = tht.run_nuts(0, lp, theta0, tht.NUTSConfig(**config), _noise=noise, _margins=margins)
    _compare_runs(*t, *j)
    assert min(float(m) for m in margins) >= MARGIN
    assert tuple(t[0].stats.accept_prob.shape) == (draws,)


@pytest.mark.parametrize("pooled", [False, True])
def test_run_nuts_chains_and_ensemble_match_jax(pooled):
    chains, draws = 3, 5
    config = dict(num_samples=draws, step_size=0.45, max_tree_depth=MAX_DEPTH)
    key = jax.random.key(5)
    theta0 = np.stack([THETA0, -THETA0, 0.5 * THETA0])
    run_j = jnuts.run_nuts_ensemble if pooled else jnuts.run_nuts_chains
    j = run_j(key, jax_flat_lp(PREC), jnp.asarray(theta0), jnuts.NUTSConfig(**config), chains)
    base = jax.random.fold_in(key, 0x5EED) if pooled else key
    noise = jax_nuts_noise(chain_keys(jax.random.split(base, chains), draws), D, MAX_DEPTH)
    run_t = tht.run_nuts_ensemble if pooled else tht.run_nuts_chains
    margins = []
    t = run_t(0, torch_flat_lp(PREC), torch.as_tensor(theta0), tht.NUTSConfig(**config), chains,
              _noise=noise, _margins=margins)
    _compare_runs(*t, *j)
    assert min(float(m) for m in margins) >= MARGIN
    layout = (draws, chains) if pooled else (chains, draws)
    assert tuple(t[1].tree_depth.shape) == layout
    assert tuple(t[0].samples.shape) == (chains, draws, D)


def _short_schedule(draws):
    collect, end = np.zeros(draws, bool), np.zeros(draws, bool)
    collect[3:15], end[[7, 14]] = True, True
    return collect, end


@pytest.mark.parametrize("mode,pooled,form", [("diag", False, "flat"), ("dense", False, "flat"),
                                              ("diag", True, "flat"), ("dense", True, "flat"),
                                              ("diag", False, "tree"), ("diag", True, "tree")])
def test_windowed_warmup_with_dual_averaging_matches_jax_in_float64(mode, pooled, form):
    """Dual averaging plus diagonal or dense windowed warmup on a short
    schedule (windows [3, 8) and [8, 15), burn 16 of 20 draws), both
    packages in float64; per-chain metrics (chains) and the pooled one
    (ensemble), on a flat state and on a dict tree (diagonal only)."""
    chains, draws, burn, depth = 3, 20, 16, 4
    collect, end = _short_schedule(draws)
    cfg = dict(num_samples=draws, step_size=0.6, burn=burn, max_tree_depth=depth,
               adapt_mass=mode)
    prec = PREC.astype(np.float64)
    theta0 = np.stack([THETA0, -THETA0, 0.5 * THETA0]).astype(np.float64)
    if form == "tree":
        j_lp, t_lp = jax_tree_lp, torch_tree_lp
        template = {"a": np.zeros(2), "b": np.zeros(3)}
        start = {"a": theta0[:, :2], "b": theta0[:, 2:]}
        t_mass = make_mass_tree(None, {k: torch.as_tensor(v) for k, v in template.items()})
    else:
        j_lp, t_lp, start = jax_flat_lp(prec), torch_flat_lp(prec), theta0
        t_mass = make_mass(None, D)
    with jax.enable_x64(True):
        key = jax.random.key(8)
        j_cfg = jnuts.NUTSConfig(**cfg)
        j_mass = jmake_mass_tree(None, template) if form == "tree" else jmake_mass(None, D)
        j_start = jax.tree_util.tree_map(jnp.asarray, start)
        flags = dict(collect_flags=jnp.asarray(collect), end_flags=jnp.asarray(end))
        if pooled:
            j = jnuts._run_nuts_ensemble_jit(key, j_start, j_lp, j_cfg, j_mass, **flags)
            base = jax.random.fold_in(key, 0x5EED)
        else:
            j = jax.vmap(lambda k, t: jnuts._run_nuts_jit(k, t, j_lp, j_cfg, j_mass, **flags))(
                jax.random.split(key, chains), j_start)
            base = key
        noise = jax_nuts_noise(chain_keys(jax.random.split(base, chains), draws), D, depth,
                               jnp.float64)
        j = jax.tree_util.tree_map(np.asarray, j)
    t = tnuts._run_nuts_batched(0, jax.tree_util.tree_map(torch.as_tensor, start), t_lp,
                                tnuts.NUTSConfig(**cfg), t_mass, pooled=pooled,
                                collect_flags=collect, end_flags=end, _noise=noise)
    if pooled:
        t = tnuts._time_major(*t)
    t_res, t_info = t
    j_res, j_info = j
    for a, b in zip(tree_leaves(t_res.samples), jax.tree_util.tree_leaves(j_res.samples)):
        assert a.dtype == torch.float64 and rel_err(a, b) <= 1e-10
    for f in ("tree_depth", "num_leapfrogs", "divergent"):
        np.testing.assert_array_equal(getattr(t_info, f).numpy(), getattr(j_info, f))
    assert rel_err(t_res.stats.step_size, j_res.stats.step_size) <= 1e-10
    for a, b in zip(tree_leaves(t_res.final_warm), jax.tree_util.tree_leaves(j_res.final_warm)):
        assert rel_err(a, b) <= 1e-10
    # the step size adapted and froze, the metric moved off the identity
    step = t_res.stats.step_size.numpy()
    step = step if pooled else step.T
    assert not np.allclose(step[0], step[burn - 1]) and np.all(step[burn + 1:] == step[-1])
    metric = t_res.final_warm[1][0] if mode == "dense" else t_res.final_warm[1]
    assert not torch.allclose(metric, torch.ones_like(metric))


def test_thin_matches_jax():
    draws, thin = 8, 2
    cfg = dict(num_samples=draws, step_size=0.5, max_tree_depth=MAX_DEPTH, thin=thin)
    key = jax.random.key(9)
    j = jnuts.run_nuts(key, jax_flat_lp(PREC), jnp.asarray(THETA0), jnuts.NUTSConfig(**cfg))
    noise = jax_nuts_noise(run_keys(key, draws), D, MAX_DEPTH)
    t = tht.run_nuts(0, torch_flat_lp(PREC), torch.as_tensor(THETA0), tht.NUTSConfig(**cfg),
                     _noise=noise)
    _compare_runs(*t, *j)
    assert tuple(t[0].samples.shape) == (draws // thin, D)


def test_bfloat16_trace():
    """The kept trace is stored in bfloat16, the chain samples in float32:
    the trace is the float32 run's rounded (round to nearest even)."""
    cfg = dict(num_samples=4, step_size=0.5, max_tree_depth=4)
    lp = torch_flat_lp(PREC)
    full = tht.run_nuts(2, lp, torch.as_tensor(THETA0), tht.NUTSConfig(**cfg))[0]
    half = tht.run_nuts(2, lp, torch.as_tensor(THETA0),
                        tht.NUTSConfig(**cfg, trace_dtype="bfloat16"))[0]
    assert half.samples.dtype == torch.bfloat16
    assert half.final_state.theta.dtype == torch.float32
    assert torch.equal(half.samples, full.samples.to(torch.bfloat16))
    assert torch.equal(half.final_state.theta, full.final_state.theta)


def test_rejections():
    tree = {k: torch.as_tensor(v) for k, v in TREE0.items()}
    with pytest.raises(ValueError, match="dense"):
        tht.run_nuts(0, torch_tree_lp, tree, tht.NUTSConfig(num_samples=2, burn=1,
                                                              adapt_mass="dense"))
    with pytest.raises(ValueError, match="diagonal"):
        tht.run_nuts(0, torch_tree_lp, tree, tht.NUTSConfig(num_samples=2),
                     inv_mass=torch.eye(D))
    with pytest.raises(ValueError, match="adapt_mass"):
        tht.run_nuts(0, torch_flat_lp(PREC), torch.as_tensor(THETA0),
                     tht.NUTSConfig(num_samples=2, burn=1, adapt_mass="full"))
    with pytest.raises(ValueError, match="divisible"):
        tht.NUTSConfig(num_samples=5, thin=2)
    for bad in ("int32", "nonsense", torch.bfloat16):
        with pytest.raises(ValueError):
            tht.NUTSConfig(num_samples=2, trace_dtype=bad)


def test_chains_do_not_depend_on_chain_count_or_chunking():
    """Chain c's draws come from its own stream keyed on the global draw
    index: the first two of four chains are the two-chain run, and two
    chunks through the warmup equal the straight run bit for bit."""
    cfg = tht.NUTSConfig(num_samples=6, step_size=0.4, max_tree_depth=4, burn=4)
    lp = torch_flat_lp(PREC)
    start = torch.as_tensor(np.stack([THETA0, -THETA0, THETA0, THETA0]))
    four = tht.run_nuts_chains(7, lp, start, cfg, 4)[0]
    two = tht.run_nuts_chains(7, lp, start[:2], cfg, 2)[0]
    assert torch.equal(four.samples[:2], two.samples)
    mass = make_mass(None, D)
    first, _ = tnuts._run_nuts_batched(7, start, lp, dataclasses.replace(cfg, num_samples=3), mass)
    second, _ = tnuts._run_nuts_batched(7, start, lp, dataclasses.replace(cfg, num_samples=3),
                                        mass, init_state=first.final_state,
                                        init_da=first.final_da, start_iter=3,
                                        init_warm=first.final_warm)
    assert torch.equal(torch.cat([first.samples, second.samples], dim=1), four.samples)
    assert torch.equal(second.final_step_size, four.final_step_size)


@pytest.mark.parametrize("burn", [0, 3])
def test_sample_nuts_matches_jax(burn, monkeypatch):
    """sample(sampler=NUTS) against the JAX façade on the façade's own draws
    (``fold_in(key, n)``, replayed into the port's per-draw noise).  Without
    burn nothing adapts (float32, debug=2 returns the acceptance rate); with
    burn the step size adapts and debug=2 returns it, compared in float64
    (dual averaging doubles a float32 rounding difference per draw while it
    climbs).  The trees stay below depth 6 here, so the replay fills the
    deeper levels with 0.5 (a tree that reached them would part the two)."""
    draws = 6
    dtype = np.float64 if burn else np.float32
    x64 = jax.enable_x64(True) if burn else contextlib.nullcontext()
    with x64:
        key = jax.random.key(12)
        j_samples, j_stat = jht.sample(
            jax_flat_lp(PREC.astype(dtype)), jnp.asarray(THETA0.astype(dtype)),
            num_samples=draws, step_size=0.5, burn=burn, sampler=jht.Sampler.NUTS, debug=2,
            verbose=False, key=key)
        j_samples = np.asarray(j_samples)
        noise = jax_nuts_noise(run_keys(key, draws), D, 6, jnp.dtype(dtype), pad_to=10)

    def replay(key, n, num_chains, dim, max_depth, dtype, device):
        return {k: v[n - tnuts.NUTS_STREAM] for k, v in noise.items()}

    monkeypatch.setattr(tnuts, "draw_nuts_noise", replay)
    t_samples, t_stat = tht.sample(
        torch_flat_lp(PREC.astype(dtype)), torch.as_tensor(THETA0.astype(dtype)),
        num_samples=draws, step_size=0.5, burn=burn, sampler=tht.Sampler.NUTS, debug=2,
        verbose=False, key=0)
    assert tuple(t_samples.shape) == j_samples.shape
    assert rel_err(t_samples, j_samples) <= (1e-10 if burn else RTOL)
    assert abs(t_stat - float(j_stat)) <= (1e-10 if burn else RTOL) * abs(float(j_stat))


def test_nuts_offload_is_the_on_card_trace():
    """store_on_GPU=False returns store_on_GPU=True's samples bit for bit,
    and run_nuts_host_offload in chunks of 2 (through the end of burn, with
    windowed warmup's carry) returns run_nuts's samples and stats."""
    kw = dict(num_samples=6, step_size=0.5, burn=3, sampler=tht.Sampler.NUTS, debug=2,
              verbose=False, key=4, adapt_mass=True)
    on_card, eps = tht.sample(torch_flat_lp(PREC), torch.as_tensor(THETA0), **kw)
    offloaded, eps_off = tht.sample(torch_flat_lp(PREC), torch.as_tensor(THETA0),
                                    store_on_GPU=False, **kw)
    assert torch.equal(offloaded, on_card) and eps == eps_off
    config = tht.NUTSConfig(num_samples=6, step_size=0.5, burn=3, adapt_mass="diag")
    chunked = run_nuts_host_offload(4, torch_flat_lp(PREC), torch.as_tensor(THETA0), config,
                                    chunk_size=2)
    direct, _ = tht.run_nuts(4, torch_flat_lp(PREC), torch.as_tensor(THETA0), config)
    assert torch.equal(chunked.samples, direct.samples)
    for a, b in zip(chunked.stats, direct.stats):
        assert torch.equal(a, b)
    assert torch.equal(chunked.final_step_size, direct.final_step_size)
    # NUTS takes adapt_mass without burn (and ignores it), as the JAX package does
    plain = tht.sample(torch_flat_lp(PREC), torch.as_tensor(THETA0), num_samples=3,
                       sampler=tht.Sampler.NUTS, adapt_mass=True, key=1, verbose=False)
    assert tuple(plain.shape) == (3, D)


@pytest.mark.parametrize("runner", ["run_nuts", "run_nuts_chains", "run_nuts_ensemble"])
def test_to_inference_dict_on_nuts_results(runner):
    """The same keys, shapes and values as the JAX package's on the same
    numbers (the JAX result's arrays handed to the port's layout)."""
    from hamiltorch_tpu.diagnostics import to_inference_dict as j_to_dict

    draws, chains = 4, 2
    cfg = dict(num_samples=draws, step_size=0.5, max_tree_depth=4)
    key = jax.random.key(1)
    args = (key, jax_flat_lp(PREC), jnp.asarray(THETA0), jnuts.NUTSConfig(**cfg))
    j = getattr(jnuts, runner)(*args, *(() if runner == "run_nuts" else (chains,)))
    j = jax.tree_util.tree_map(np.asarray, j)
    t_res = tht.MCMCResult(samples=torch.as_tensor(j[0].samples), stats=None,
                           final_step_size=None, acc_rate=None, final_state=None, final_da=None)
    t_info = tnuts.NUTSInfo(*(torch.as_tensor(f) for f in j[1]))
    want = j_to_dict(j)
    for got in (to_inference_dict((t_res, t_info)), to_inference_dict(t_res, info=t_info)):
        assert set(got) == set(want)
        for group in want:
            assert set(got[group]) == set(want[group])
            for name, arr in want[group].items():
                np.testing.assert_array_equal(got[group][name], np.asarray(arr))
    assert {"tree_depth", "n_steps"} <= set(want["sample_stats"])
