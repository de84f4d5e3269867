"""Port vs JAX package: the block-diagonal mass operator (``BlockDiagMass``).

Blocks of sizes 3, 1 and 2 (padded to K = 3 with identity tails):

* the padded inverse blocks, the Cholesky factors, the lane mask and the
  lane indices equal the JAX operator's (factors within 1e-6);
* ``sample``, ``velocity`` and ``kinetic`` agree within 1e-6 when the port's
  flat (D,) normal holds the JAX operator's own (B, K) draw at the real
  lanes (the JAX operator masks the padding lanes to zero);
* ``run_hmc_chains`` with a list of blocks reproduces the JAX sampler draw
  for draw (identical accepts, samples within 1e-5), flat and on a tree;
* ``make_mass`` refuses blocks that do not cover the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.ops.mass as jmass
import hamiltorch_tpu_torch as tht
import hamiltorch_tpu_torch.ops.mass as tmass

RNG = np.random.default_rng(11)


def spd(k):
    a = RNG.standard_normal((k, k))
    return (a @ a.T / k + 0.5 * np.eye(k)).astype(np.float32)


BLOCKS = [spd(3), np.array([[0.7]], np.float32), spd(2)]
DIM = 6
PREC = np.linalg.inv(spd(DIM).astype(np.float64) + 0.5 * np.eye(DIM)).astype(np.float32)


def ops():
    return (jmass.make_mass([jnp.asarray(b) for b in BLOCKS], DIM),
            tmass.make_mass([torch.as_tensor(b) for b in BLOCKS], DIM))


def real_lanes(j_op, z_blocked):
    """The port's flat normal: the JAX (B, K) draw at the real lanes."""
    return torch.as_tensor(np.asarray(z_blocked).reshape(-1)[np.asarray(j_op.lane_idx)])


def test_padded_layout_matches_jax():
    j_op, t_op = ops()
    assert isinstance(t_op, tmass.BlockDiagMass) and t_op.dim == j_op.dim == DIM
    np.testing.assert_array_equal(t_op.inv_blocks.numpy(), np.asarray(j_op.inv_blocks))
    np.testing.assert_allclose(t_op.chol_blocks.numpy(), np.asarray(j_op.chol_blocks), atol=1e-6)
    np.testing.assert_array_equal(t_op.mask.numpy(), np.asarray(j_op.mask))
    np.testing.assert_array_equal(t_op.lane_idx.numpy(), np.asarray(j_op.lane_idx))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_velocity_kinetic_match_jax(seed):
    j_op, t_op = ops()
    key = jax.random.key(seed)
    j_p = j_op.sample(key)
    b, k = j_op.mask.shape
    z = real_lanes(j_op, jax.random.normal(key, (b, k), jnp.float32))
    t_p = t_op.sample(z)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), atol=1e-6)
    p = RNG.standard_normal(DIM).astype(np.float32)
    np.testing.assert_allclose(t_op.velocity(torch.as_tensor(p)).numpy(),
                               np.asarray(j_op.velocity(jnp.asarray(p))), atol=1e-6)
    np.testing.assert_allclose(float(t_op.kinetic(torch.as_tensor(p))),
                               float(j_op.kinetic(jnp.asarray(p))), rtol=1e-6)
    # the blocks act as the dense block-diagonal matrix would
    dense = np.zeros((DIM, DIM), np.float32)
    off = 0
    for blk in BLOCKS:
        n = blk.shape[0]
        dense[off:off + n, off:off + n] = blk
        off += n
    np.testing.assert_allclose(t_op.velocity(torch.as_tensor(p)).numpy(), dense @ p, atol=1e-6)


def jax_block_noise(key, j_op, num_chains, num_samples):
    """The JAX driver's noise under a block mass, on the real lanes: (z (S, C, D), log_u)."""
    b, k = j_op.mask.shape

    def one(kc, n):
        k_prop, k_mh = jax.random.split(jax.random.fold_in(kc, n))
        return (jax.random.normal(k_prop, (b, k), jnp.float32).reshape(-1)[j_op.lane_idx],
                jnp.log(jax.random.uniform(k_mh, (), jnp.float32)))

    keys = jax.random.split(key, num_chains)
    z, log_u = jax.vmap(lambda kc: jax.vmap(lambda n: one(kc, n))(jnp.arange(num_samples)))(keys)
    return (torch.as_tensor(np.asarray(z).transpose(1, 0, 2).copy()),
            torch.as_tensor(np.asarray(log_u).T.copy()))


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_run_hmc_chains_with_blocks_matches_jax(form):
    j_op, _ = ops()
    jp, tp = jnp.asarray(PREC), torch.as_tensor(PREC)
    if form == "flat":
        j_lp = lambda t: -0.5 * t @ jp @ t  # noqa: E731
        t_lp = lambda t: -0.5 * t @ tp @ t  # noqa: E731
        j_theta0, t_theta0 = jnp.full(DIM, 0.3), torch.full((DIM,), 0.3)
    else:  # leaves "a" (4,) and "b" (2,): the blocks span the raveled tree
        j_lp = lambda t: -0.5 * (f := jnp.concatenate([t["a"], t["b"]])) @ jp @ f  # noqa: E731
        t_lp = lambda t: -0.5 * (f := torch.cat([t["a"], t["b"]])) @ tp @ f  # noqa: E731
        j_theta0 = {"a": jnp.full(4, 0.3), "b": jnp.full(2, 0.3)}
        t_theta0 = {"a": torch.full((4,), 0.3), "b": torch.full((2,), 0.3)}
    cfg = dict(num_samples=30, num_steps_per_sample=4, step_size=0.45)
    key = jax.random.key(3)
    j_res = jht.run_hmc_chains(key, j_lp, j_theta0, jht.MCMCConfig(**cfg), 3,
                               inv_mass=[jnp.asarray(b) for b in BLOCKS])
    t_res = tht.run_hmc_chains(0, t_lp, t_theta0, tht.MCMCConfig(**cfg), 3,
                               inv_mass=[torch.as_tensor(b) for b in BLOCKS],
                               _noise=jax_block_noise(key, j_op, 3, 30))
    acc = np.asarray(j_res.stats.accepted)
    assert 0 < acc.mean() < 1
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), acc)
    j_leaves = jax.tree_util.tree_leaves(j_res.samples)
    t_leaves = [t_res.samples] if form == "flat" else [t_res.samples[k] for k in ("a", "b")]
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_blocks_must_cover_the_parameters():
    with pytest.raises(ValueError, match="cover"):
        tmass.make_mass([torch.eye(2), torch.eye(3)], 6)
    with pytest.raises(ValueError, match="cover"):
        jmass.make_mass([jnp.eye(2), jnp.eye(3)], 6)


def test_tree_mass_of_blocks_drifts_through_the_ravel():
    template = {"a": torch.zeros(4), "b": torch.zeros(2)}
    op = tmass.make_mass_tree([torch.as_tensor(b) for b in BLOCKS], template)
    assert isinstance(op.inner, tmass.BlockDiagMass) and op.inv_diag_tree is None
    p = {"a": torch.arange(4.0), "b": torch.tensor([1.0, -1.0])}
    flat = torch.cat([p["a"], p["b"]])
    v = op.velocity(p)
    np.testing.assert_allclose(torch.cat([v["a"], v["b"]]).numpy(),
                               op.inner.velocity(flat).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="diagonal metrics only"):
        tmass.make_diag_mass_tree([torch.as_tensor(b) for b in BLOCKS], template, "test")
