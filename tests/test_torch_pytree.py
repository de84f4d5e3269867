"""Port vs JAX package: parameter trees of dicts, lists, tuples and mixes
(``utils/pytree.py``).

* Leaf order equals ``jax.tree_util.tree_leaves`` (sequences in order,
  dicts by sorted key, None empty), and rebuilt trees keep each
  container's type, as ``jax.tree_util.tree_map`` does.
* ``ravel_pytree_fn`` / ``unravel_last_axis_fn`` equal the JAX package's
  (``jax.flatten_util.ravel_pytree``) on the same trees.
* ``is_param_tree`` reads the same inputs as trees as the JAX package.
* ``run_hmc`` and ``run_hmc_chains`` run on a list-of-tensors state and
  on a tuple-in-dict state, and reproduce the JAX sampler draw for draw.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu.utils.pytree as jtree
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu_torch.utils import pytree as ttree
from test_torch_hmc import jax_driver_noise


class Pair(NamedTuple):
    first: object
    second: object


def shaped(*shape, seed=0):
    return np.random.default_rng(seed + len(shape)).standard_normal(shape).astype(np.float32) \
        + np.float32(seed)


TREES = {
    "list": lambda: [shaped(3, seed=1), shaped(2, 2, seed=2)],
    "tuple": lambda: (shaped(4, seed=3), shaped(seed=4), shaped(1, 3, seed=5)),
    "dict_of_mixed": lambda: {"z": [shaped(2, seed=6), (shaped(3, seed=7),)],
                              "a": {"k": shaped(2, 1, seed=8), "b": shaped(1, seed=9)}},
    "list_of_dicts": lambda: [{"w": shaped(2, 3, seed=10), "b": shaped(3, seed=11)},
                              {"w": shaped(3, 1, seed=12), "b": shaped(1, seed=13)}],
    "namedtuple_with_none": lambda: Pair(first=[shaped(2, seed=14), None],
                                         second={"x": shaped(5, seed=15)}),
}


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def as_torch(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_leaf_order_and_structure_match_jax(name):
    tree = TREES[name]()
    j_leaves = jax.tree_util.tree_leaves(tree)
    t_leaves = ttree.tree_leaves(as_torch(tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    # tree_map keeps the container types (a tuple stays a tuple)
    doubled = ttree.tree_map(lambda x: 2 * x, as_torch(tree))
    want = jax.tree_util.tree_map(lambda x: 2 * x, tree)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: x.numpy(), doubled)) == \
        jax.tree_util.tree_structure(want)
    rebuilt = ttree.tree_unflatten_like(tree, [torch.as_tensor(x) for x in j_leaves])
    assert ttree.tree_structure(rebuilt) == ttree.tree_structure(as_torch(tree))
    assert ttree.tree_structure(rebuilt) != ttree.tree_structure([rebuilt])


@pytest.mark.parametrize("name", sorted(TREES))
def test_ravel_and_unravel_match_jax(name):
    tree = TREES[name]()
    j_flat, j_unravel = jtree.ravel_pytree_fn(as_jax(tree))
    t_flat, t_unravel = ttree.ravel_pytree_fn(as_torch(tree))
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    back = t_unravel(t_flat)
    for a, b in zip(ttree.tree_leaves(back), jax.tree_util.tree_leaves(j_unravel(j_flat))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stacked = np.stack([np.asarray(j_flat), 2 * np.asarray(j_flat)])[None]  # (1, 2, D)
    j_split = jtree.unravel_last_axis_fn(as_jax(tree))(jnp.asarray(stacked))
    t_split = ttree.unravel_last_axis_fn(as_torch(tree))(torch.as_tensor(stacked))
    for a, b in zip(ttree.tree_leaves(t_split), jax.tree_util.tree_leaves(j_split)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["tensor", "float_list", "tensor_list", "tuple_of_tensor",
                                  "dict_scalar", "dict_of_floats", "nested_empty"])
def test_is_param_tree_matches_jax(case):
    value = {
        "tensor": lambda m: m.asarray(np.ones(3, np.float32)),
        "float_list": lambda m: [1.0, 2.0],
        "tensor_list": lambda m: [m.asarray(np.ones(2, np.float32)), m.asarray(np.ones(1, np.float32))],
        "tuple_of_tensor": lambda m: (m.asarray(np.ones(2, np.float32)),),
        "dict_scalar": lambda m: {"mu": m.asarray(np.float32(0.5))},
        "dict_of_floats": lambda m: {"mu": 0.5},
        "nested_empty": lambda m: {"a": [], "b": None},
    }[case]
    torch_mod = type("m", (), {"asarray": staticmethod(torch.as_tensor)})
    assert ttree.is_param_tree(value(torch_mod)) == jtree.is_param_tree(value(jnp))


def test_stack_param_tree_on_a_list():
    template, stacked = ttree.stack_param_tree([torch.zeros(3), torch.ones(2, 2)], 4)
    assert isinstance(stacked, list) and [tuple(x.shape) for x in stacked] == [(4, 3), (4, 2, 2)]
    again, same = ttree.stack_param_tree(stacked, 4)
    assert [tuple(x.shape) for x in again] == [(3,), (2, 2)]
    assert all(torch.equal(a, b) for a, b in zip(same, stacked))


@pytest.mark.parametrize("name", sorted(TREES))
def test_stack_param_tree_spread_matches_jax(name):
    """``stack_param_tree(key=, noise=)``: the JAX package's template,
    structure, shapes and dtypes; each copy spread by ``noise * N(0, 1)``
    leaf by leaf in leaf order from a generator seeded by the key (an int
    or the generator itself: the same draws), on the CPU whatever the
    leaves' device; ``noise=0`` copies, a stacked start is taken as it is,
    and a spread without a key raises."""
    tree = TREES[name]()
    n, noise = 64, 0.5
    j_tmpl, j_st = jtree.stack_param_tree(jax.tree_util.tree_map(jnp.asarray, tree), n,
                                          key=jax.random.key(1), noise=noise, stacked=False)
    t_in = ttree.tree_map(torch.as_tensor, tree)
    t_tmpl, t_st = ttree.stack_param_tree(t_in, n, key=7, noise=noise, stacked=False)
    assert ttree.tree_structure(t_st) == ttree.tree_structure(t_in)
    for jl, tl, base in zip(jax.tree_util.tree_leaves(j_st), ttree.tree_leaves(t_st),
                            ttree.tree_leaves(t_in)):
        assert tuple(jl.shape) == tuple(tl.shape) and str(tl.dtype).endswith(str(jl.dtype))
        assert not torch.equal(tl[0], tl[1])
    gen = torch.Generator().manual_seed(7)
    want = [base.unsqueeze(0) + noise * torch.randn((n,) + tuple(base.shape), generator=gen,
                                                    dtype=base.dtype)
            for base in ttree.tree_leaves(t_in)]
    assert all(torch.equal(a, b) for a, b in zip(ttree.tree_leaves(t_st), want))
    _, from_gen = ttree.stack_param_tree(t_in, n, key=torch.Generator().manual_seed(7),
                                         noise=noise, stacked=False)
    assert all(torch.equal(a, b) for a, b in zip(ttree.tree_leaves(from_gen), want))
    spread = torch.cat([(s - b).reshape(-1) for s, b in zip(ttree.tree_leaves(t_st),
                                                            ttree.tree_leaves(t_in))])
    j_spread = np.concatenate([np.asarray(s - np.asarray(b)).reshape(-1) for s, b in
                               zip(jax.tree_util.tree_leaves(j_st), ttree.tree_leaves(t_in))])
    assert abs(float(spread.std()) - noise) < 0.15 and abs(float(j_spread.std()) - noise) < 0.15
    _, copies = ttree.stack_param_tree(t_in, n, key=7, noise=0.0, stacked=False)
    assert all(torch.equal(c[3], b) for c, b in zip(ttree.tree_leaves(copies),
                                                     ttree.tree_leaves(t_in)))
    _, same = ttree.stack_param_tree(t_st, n, key=7, noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(ttree.tree_leaves(same),
                                                 ttree.tree_leaves(t_st)))
    with pytest.raises(ValueError, match="key"):
        ttree.stack_param_tree(t_in, n, noise=noise, stacked=False)


def list_target():
    scale = [np.array([0.5, 1.5], np.float32), np.array([[2.0], [0.8]], np.float32)]

    def j_lp(t):
        return -0.5 * sum(jnp.sum((x / s) ** 2) for x, s in zip(t, scale))

    def t_lp(t):
        return -0.5 * sum(torch.sum((x / torch.as_tensor(s)) ** 2) for x, s in zip(t, scale))

    theta0 = [np.full(2, 0.4, np.float32), np.full((2, 1), -0.3, np.float32)]
    return j_lp, t_lp, theta0


def test_run_hmc_chains_on_a_list_state_matches_jax():
    j_lp, t_lp, theta0 = list_target()
    cfg = dict(num_samples=25, num_steps_per_sample=4, step_size=0.5)
    key = jax.random.key(2)
    j_res = jht.run_hmc_chains(key, j_lp, as_jax(theta0), jht.MCMCConfig(**cfg), 3)
    t_res = tht.run_hmc_chains(0, t_lp, as_torch(theta0), tht.MCMCConfig(**cfg), 3,
                               _noise=jax_driver_noise(key, 3, 25, 4))
    assert isinstance(t_res.samples, list) and len(t_res.samples) == 2
    np.testing.assert_array_equal(t_res.stats.accepted.numpy(), np.asarray(j_res.stats.accepted))
    for a, b in zip(t_res.samples, j_res.samples):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_run_hmc_on_list_and_tuple_states():
    """Single chains on a list state and a dict-of-tuple state: shapes and
    containers kept; an inv_mass tree with the state's structure is a
    per-leaf diagonal."""
    _, t_lp, theta0 = list_target()
    cfg = tht.MCMCConfig(num_samples=20, num_steps_per_sample=3, step_size=0.3)
    res = tht.run_hmc(1, t_lp, as_torch(theta0), cfg)
    assert [tuple(x.shape) for x in res.samples] == [(20, 2), (20, 2, 1)]
    assert bool(res.stats.accepted.any())

    def lp(t):
        return -0.5 * (torch.sum(t["pair"][0] ** 2) + torch.sum(t["pair"][1] ** 2))

    res = tht.run_hmc(1, lp, {"pair": (torch.zeros(2), torch.zeros(3))}, cfg)
    assert isinstance(res.samples["pair"], tuple)
    assert [tuple(x.shape) for x in res.samples["pair"]] == [(20, 2), (20, 3)]
    # a dict inv_mass with the state's structure is per-leaf diagonal
    per_leaf = {"pair": (torch.full((2,), 0.5), torch.full((3,), 2.0))}
    res = tht.run_hmc(1, lp, {"pair": (torch.zeros(2), torch.zeros(3))}, cfg, inv_mass=per_leaf)
    assert bool(torch.all(torch.isfinite(res.samples["pair"][1])))
