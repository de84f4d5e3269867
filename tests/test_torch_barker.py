"""Port vs JAX package: the Barker proposal (``samplers/barker.py``).

The port runs on the JAX sampler's own randomness, replayed: draw g of a
chain splits ``fold_in(key, g)`` three ways into the increment's normals,
the keep uniforms and the Metropolis uniform (float32); the chains runner
gives chain c the key ``split(key, C)[c]``.  They go into the port's
``_noise={"z", "u_keep", "u_mh"}``.

The JAX sampler runs in float32 only: under ``jax.enable_x64`` a float64
state promotes the acceptance probability to float64 while the scan's
carry holds float32, and tracing fails.  So every case here is float32:
positions, step sizes, scales and adaptation states within 1e-5 relative,
identical accepts, keep and divergence flags, and every decision (keep and
Metropolis) at least 1e-4 from its other outcome (the ``_margins`` hook).
Dual averaging feeds each draw's acceptance back into the step size, so
XLA's and torch's last-bit differences in float32 ``pow`` grow draw after
draw while it adapts (over a 30-draw burn positions part by 2e-5, over 60
by 1e-3, and a Metropolis decision then flips): the adaptive cases run
burns of 12-20 draws, or target an acceptance of 0.95 where the feedback
is weaker, and scale adaptation is also held with the step size fixed.
The card against the CPU in float64 is ``tests/test_torch_gpu.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hamiltorch_tpu.samplers import barker as jb
from hamiltorch_tpu_torch.samplers import barker as tb

MARGIN = 1e-4
REL = 1e-5


def lp_pair(stds):
    """(JAX, port) anisotropic Gaussian log-densities with a cosine ripple."""
    s_np = np.asarray(stds, np.float32)

    def lp_j(t):
        return -0.5 * jnp.sum((t / s_np) ** 2) + 0.2 * jnp.sum(jnp.cos(t))

    def lp_t(t):
        return -0.5 * torch.sum((t / torch.as_tensor(s_np)) ** 2) + 0.2 * torch.sum(torch.cos(t))
    return lp_j, lp_t


def tree_pair():
    def lp_j(t):
        return -0.5 * jnp.sum((t["w"] / 0.5) ** 2) - 0.5 * jnp.sum((t["b"] / 2.0) ** 2)

    def lp_t(t):
        return -0.5 * torch.sum((t["w"] / 0.5) ** 2) - 0.5 * torch.sum((t["b"] / 2.0) ** 2)
    return lp_j, lp_t


def jax_noise(key, draws, d, chains=None, start=0):
    """The JAX runner's draws in the port's ``_noise`` layout."""
    def one(k):
        def draw(g):
            k_z, k_b, k_mh = jax.random.split(jax.random.fold_in(k, g), 3)
            return (jax.random.normal(k_z, (d,), jnp.float32),
                    jax.random.uniform(k_b, (d,), jnp.float32),
                    jax.random.uniform(k_mh, (), jnp.float32))
        return jax.vmap(draw)(jnp.arange(start, start + draws))

    if chains is None:
        out = one(key)
    else:
        out = [jnp.swapaxes(a, 0, 1) for a in jax.vmap(one)(jax.random.split(key, chains))]
    return dict(zip(("z", "u_keep", "u_mh"), (torch.as_tensor(np.asarray(a)) for a in out)))


def leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def assert_close(port, ref, rel=REL, unit=1e-30):
    """Within ``rel`` of the reference's largest magnitude, or of ``unit``
    for a quantity near 0 on a known scale (probabilities and the dual
    averaging's running mean of target - acceptance)."""
    for a, b in zip(leaves(port), leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(np.abs(b).max()), unit)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


def assert_barker_match(port, ref, margins):
    assert min(float(m) for m in margins) >= MARGIN
    np.testing.assert_array_equal(port.stats.accepted.numpy(), np.asarray(ref.stats.accepted))
    np.testing.assert_array_equal(port.stats.divergent.numpy(), np.asarray(ref.stats.divergent))
    assert_close(port.samples, ref.samples)
    assert_close(port.final_theta, ref.final_theta)
    assert_close(port.stats.accept_prob, ref.stats.accept_prob, unit=1.0)
    assert_close(port.stats.step_size, ref.stats.step_size)
    assert_close(port.acc_rate, ref.acc_rate, unit=1.0)
    for f in ("step_size", "scale"):
        assert_close(getattr(port, f), getattr(ref, f))
    assert_close(port.final_da.step_size, ref.final_da.step_size)
    for f in ("log_eps_bar", "h_t", "mu"):  # logs and a running mean near 0
        assert_close(getattr(port.final_da, f), getattr(ref.final_da, f), unit=1.0)
    # the Welford mean is on the positions' scale
    width = max(float(np.abs(np.asarray(x)).max()) for x in leaves(ref.samples))
    assert_close(port.final_welford.mean, ref.final_welford.mean, unit=width)
    for f in ("count", "m2"):
        assert_close(getattr(port.final_welford, f), getattr(ref.final_welford, f))
    np.testing.assert_array_equal(port.final_step.numpy(), np.asarray(ref.final_step))


# (name, config kwargs, seed)
FLAT_CASES = [
    ("fixed-step", dict(num_samples=50, burn=0, adapt_step_size=False, step_size=0.8), 1),
    ("dual-averaging", dict(num_samples=40, burn=12), 2),
    ("scale-adaptation", dict(num_samples=80, burn=40, adapt_scale=True, adapt_step_size=False,
                              step_size=0.9), 3),
    ("both-adaptations", dict(num_samples=48, burn=16, adapt_scale=True,
                              desired_accept_rate=0.95), 3),
    ("thin", dict(num_samples=60, burn=20, adapt_scale=True, thin=3), 4),
    ("wild-step", dict(num_samples=40, burn=12, step_size=50.0), 5),
]


@pytest.mark.parametrize("name,cfg_kw,seed", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_run_barker_matches_jax(name, cfg_kw, seed):
    d = 6
    lp_j, lp_t = lp_pair(np.linspace(0.5, 2.0, d))
    t0 = np.full(d, 0.3, np.float32)
    cfg_j, cfg_t = jb.BarkerConfig(**cfg_kw), tb.BarkerConfig(**cfg_kw)
    key = jax.random.key(seed)
    ref = jb.run_barker(key, lp_j, jnp.asarray(t0), cfg_j)
    margins = []
    port = tb.run_barker(0, lp_t, torch.as_tensor(t0), cfg_t,
                         _noise=jax_noise(key, cfg_kw["num_samples"], d), _margins=margins)
    assert_barker_match(port, ref, margins)
    if name == "wild-step":
        assert float(port.step_size) < 10.0  # dual averaging walked eps down


@pytest.mark.parametrize("chains_form", ["flat", "tree"])
def test_run_barker_chains_matches_jax(chains_form):
    c, seed = 4, 7
    cfg_kw = dict(num_samples=48, burn=16, adapt_scale=True, desired_accept_rate=0.95)
    key = jax.random.key(seed)
    if chains_form == "flat":
        d = 5
        lp_j, lp_t = lp_pair(np.linspace(0.4, 3.0, d))
        t0 = np.random.RandomState(seed).randn(c, d).astype(np.float32)
        ref = jb.run_barker_chains(key, lp_j, jnp.asarray(t0), jb.BarkerConfig(**cfg_kw), c)
        start = torch.as_tensor(t0)
    else:
        d = 7
        lp_j, lp_t = tree_pair()
        t0 = {"b": np.zeros(3, np.float32), "w": np.full((2, 2), 0.3, np.float32)}
        ref = jb.run_barker_chains(key, lp_j, {k: jnp.asarray(v) for k, v in t0.items()},
                                   jb.BarkerConfig(**cfg_kw), c, scale={"b": 2.0, "w": 0.5})
        start = {k: torch.as_tensor(v) for k, v in t0.items()}
    margins = []
    port = tb.run_barker_chains(0, lp_t, start, tb.BarkerConfig(**cfg_kw), c,
                                scale={"b": 2.0, "w": 0.5} if chains_form == "tree" else None,
                                _noise=jax_noise(key, cfg_kw["num_samples"], d, chains=c),
                                _margins=margins)
    assert_barker_match(port, ref, margins)
    assert tuple(port.acc_rate.shape) == (c,) and tuple(port.scale.shape) == (c, d)


def test_tree_state_with_per_leaf_scale_matches_jax():
    lp_j, lp_t = tree_pair()
    t0 = {"b": np.zeros(3, np.float32), "w": np.full((2, 2), 0.3, np.float32)}
    cfg_kw = dict(num_samples=50, burn=10)
    key = jax.random.key(12)
    scale = {"b": 2.0, "w": 0.5}
    ref = jb.run_barker(key, lp_j, {k: jnp.asarray(v) for k, v in t0.items()},
                        jb.BarkerConfig(**cfg_kw), scale=scale)
    margins = []
    port = tb.run_barker(0, lp_t, {k: torch.as_tensor(v) for k, v in t0.items()},
                         tb.BarkerConfig(**cfg_kw), scale=scale,
                         _noise=jax_noise(key, 50, 7), _margins=margins)
    assert port.samples["w"].shape == (50, 2, 2)
    assert_barker_match(port, ref, margins)
    # the per-leaf scale ravels as the explicit (D,) one
    flat = tb.run_barker(0, lambda v: lp_t({"b": v[:3], "w": v[3:].reshape(2, 2)}),
                         torch.as_tensor(np.concatenate([t0["b"], t0["w"].ravel()])),
                         tb.BarkerConfig(**cfg_kw), scale=torch.tensor([2.0] * 3 + [0.5] * 4),
                         _noise=jax_noise(key, 50, 7))
    assert torch.equal(flat.samples, torch.cat([port.samples["b"],
                                                port.samples["w"].reshape(50, 4)], dim=1))


def test_resume_from_final_states_matches_the_straight_jax_run():
    d = 6
    lp_j, lp_t = lp_pair(np.linspace(0.5, 2.0, d))
    t0 = np.full(d, 0.5, np.float32)
    # the Welford window [10, 30) and the scale switch land in the first
    # chunk (a fresh run needs burn < num_samples): the second chunk must
    # reproduce the switched scale from the carried state alone
    cfg_kw = dict(num_samples=60, burn=40, adapt_scale=True, adapt_step_size=False,
                  step_size=0.9)
    key = jax.random.key(13)
    ref = jb.run_barker(key, lp_j, jnp.asarray(t0), jb.BarkerConfig(**cfg_kw))
    noise = jax_noise(key, 60, d)
    first, second = ({k: v[:45] for k, v in noise.items()}, {k: v[45:] for k, v in noise.items()})
    m1, m2 = [], []
    c1 = tb.run_barker(0, lp_t, torch.as_tensor(t0),
                       tb.BarkerConfig(**dict(cfg_kw, num_samples=45)), _noise=first, _margins=m1)
    c2 = tb.run_barker(0, lp_t, c1.final_theta, tb.BarkerConfig(**dict(cfg_kw, num_samples=15)),
                       init_da=c1.final_da,
                       init_welford=c1.final_welford, start_step=c1.final_step, _noise=second,
                       _margins=m2)
    assert min(float(m) for m in m1 + m2) >= MARGIN
    assert_close(torch.cat([c1.samples, c2.samples]), ref.samples)
    assert_close(c2.scale, ref.scale)
    assert_close(c2.step_size, ref.step_size)
    # the port's own chunks equal its straight run bit for bit
    full = tb.run_barker(0, lp_t, torch.as_tensor(t0), tb.BarkerConfig(**cfg_kw), _noise=noise)
    assert torch.equal(torch.cat([c1.samples, c2.samples]), full.samples)
    assert torch.equal(c2.scale, full.scale)


def test_hard_support_and_nan_cliff_match_jax():
    # -inf outside the support: a clean rejection, never divergent
    def hard_j(t):
        return -0.5 * jnp.sum(t ** 2) + jnp.log(jnp.where(t[0] < 1.0, 1.0, 0.0))

    def hard_t(t):
        return -0.5 * torch.sum(t ** 2) + torch.log(torch.where(t[0] < 1.0, 1.0, 0.0))

    key = jax.random.key(17)
    cfg_kw = dict(num_samples=80, burn=12, step_size=2.0)
    ref = jb.run_barker(key, hard_j, jnp.full(3, 0.8), jb.BarkerConfig(**cfg_kw))
    margins = []
    port = tb.run_barker(0, hard_t, torch.full((3,), 0.8), tb.BarkerConfig(**cfg_kw),
                         _noise=jax_noise(key, 80, 3), _margins=margins)
    assert_barker_match(port, ref, margins)
    assert bool((port.samples[:, 0] < 1.0).all()) and not bool(port.stats.divergent.any())
    assert not bool(port.stats.accepted.all())

    # NaN beyond a cliff: divergent, state finite
    def cliff_j(t):
        return jnp.where(t[0] < 2.0, -0.5 * jnp.sum(t ** 2), jnp.nan)

    def cliff_t(t):
        return torch.where(t[0] < 2.0, -0.5 * torch.sum(t ** 2), torch.nan)

    key = jax.random.key(19)
    cfg_kw = dict(num_samples=80, burn=0, adapt_step_size=False, step_size=3.0)
    ref = jb.run_barker(key, cliff_j, jnp.full(2, 1.5), jb.BarkerConfig(**cfg_kw))
    margins = []
    port = tb.run_barker(0, cliff_t, torch.full((2,), 1.5), tb.BarkerConfig(**cfg_kw),
                         _noise=jax_noise(key, 80, 2), _margins=margins)
    assert_barker_match(port, ref, margins)
    assert bool(torch.isfinite(port.samples).all()) and bool(port.stats.divergent.any())


def test_data_argument_matches_jax():
    x = np.random.RandomState(3).randn(20, 3).astype(np.float32)
    y = (x @ np.array([1.0, -0.5, 0.25], np.float32)).astype(np.float32)

    def lp_j(t, data):
        xs, ys = data
        return -0.5 * jnp.sum((xs @ t - ys) ** 2) - 0.5 * jnp.sum(t ** 2)

    def lp_t(t, data):
        xs, ys = data
        return -0.5 * torch.sum((xs @ t - ys) ** 2) - 0.5 * torch.sum(t ** 2)

    key = jax.random.key(23)
    cfg_kw = dict(num_samples=40, burn=10, desired_accept_rate=0.95)
    ref = jb.run_barker(key, lp_j, jnp.zeros(3), jb.BarkerConfig(**cfg_kw),
                        data=(jnp.asarray(x), jnp.asarray(y)))
    margins = []
    port = tb.run_barker(0, lp_t, torch.zeros(3), tb.BarkerConfig(**cfg_kw),
                         data=(torch.as_tensor(x), torch.as_tensor(y)),
                         _noise=jax_noise(key, 40, 3), _margins=margins)
    assert_barker_match(port, ref, margins)


def test_default_noise_is_chunk_reproducible_and_keyed():
    _, lp_t = lp_pair(np.ones(4))
    cfg = tb.BarkerConfig(num_samples=40, burn=12, adapt_scale=True, thin=2)
    t0 = torch.full((4,), 0.2)
    full = tb.run_barker(5, lp_t, t0, cfg)
    c1 = tb.run_barker(5, lp_t, t0, dataclasses.replace(cfg, num_samples=14))
    c2 = tb.run_barker(5, lp_t, c1.final_theta, dataclasses.replace(cfg, num_samples=26),
                       init_da=c1.final_da, init_welford=c1.final_welford,
                       start_step=c1.final_step)
    assert torch.equal(torch.cat([c1.samples, c2.samples]), full.samples)
    assert torch.equal(c2.scale, full.scale)
    assert not torch.equal(tb.run_barker(6, lp_t, t0, cfg).samples, full.samples)
    chains = tb.run_barker_chains(5, lp_t, t0, cfg, 3)
    assert not torch.equal(chains.samples[0], chains.samples[1])


@pytest.mark.parametrize("kw,err,match", [
    (dict(num_samples=10, burn=4, adapt_scale=True), ValueError, "adapt_scale"),
    (dict(num_samples=10, burn=0), ValueError, "adapt_step_size"),
    (dict(num_samples=10, burn=2, thin=3), ValueError, "divisible"),
    (dict(num_samples=10, burn=2, step_size=0.0), ValueError, "step_size"),
    (dict(num_samples=10, burn=2, desired_accept_rate=1.0), ValueError, "desired_accept_rate"),
    (dict(num_samples=0, burn=2), ValueError, "num_samples"),
    (dict(num_samples=10, burn=-1, adapt_step_size=False), ValueError, "burn"),
])
def test_config_validation_matches_jax(kw, err, match):
    for mod in (jb, tb):
        with pytest.raises(err, match=match):
            mod.BarkerConfig(**kw)


def test_entry_point_validation():
    _, lp_t = lp_pair(np.ones(2))
    cfg = tb.BarkerConfig(num_samples=10, burn=10)
    for call in (lambda: tb.run_barker(0, lp_t, torch.zeros(2), cfg),
                 lambda: tb.run_barker_chains(0, lp_t, torch.zeros(2), cfg, 2)):
        with pytest.raises(RuntimeError, match="burn"):
            call()
    with pytest.raises(ValueError, match="1-d"):
        tb.run_barker(0, lp_t, torch.zeros((2, 2)), tb.BarkerConfig(num_samples=4, burn=2))
