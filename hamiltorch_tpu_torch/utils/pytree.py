"""Parameter trees: dicts of tensors.

Counterpart of ``hamiltorch_tpu/utils/pytree.py``.  A parameter tree here
is a dict whose values are tensors or nested dicts of the same kind.  Leaf
order follows JAX's order for dicts, which is sorted keys: the flagship's
``{w1, b1, w2, b2}`` ravels as ``b1, b2, w1, w2``.  Mass operators draw one
flat normal and split it in this order, so a tree chain and the JAX
package's tree chain see the same momentum for the same flat draw.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Callable, Tuple

import torch


def tree_leaves(tree) -> list:
    """Leaves of ``tree`` in sorted-key order (a bare tensor is one leaf)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves) -> Any:
    """Build a tree shaped like ``template`` from leaves in its leaf order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def ravel_pytree_fn(params) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Ravel ``params`` to a flat vector; returns (flat, unravel_fn).

    Leaves are flattened row-major and concatenated in sorted-key order,
    the order of the JAX package's ``ravel_pytree`` for dicts.
    """
    flat = torch.cat([torch.as_tensor(leaf).reshape(-1) for leaf in tree_leaves(params)])
    return flat, unravel_last_axis_fn(params)


def unravel_last_axis_fn(template) -> Callable[[torch.Tensor], Any]:
    """Split the LAST axis of a flat-stacked tensor back into ``template``'s
    leaves: the returned fn maps (..., D) to a tree of (..., *leaf.shape)
    in ``ravel_pytree_fn``'s leaf order."""
    shapes = [tuple(leaf.shape) for leaf in tree_leaves(template)]
    sizes = [math.prod(shape) for shape in shapes]

    def unravel_last(mat):
        mat = torch.as_tensor(mat)
        lead = tuple(mat.shape[:-1])
        parts = torch.split(mat, sizes, dim=-1)
        return tree_unflatten_like(
            template, [part.reshape(lead + shape) for part, shape in zip(parts, shapes)]
        )

    return unravel_last


def is_param_tree(theta: Any) -> bool:
    """True when ``theta`` is a parameter tree, not a flat vector."""
    return isinstance(theta, Mapping) and any(
        isinstance(leaf, torch.Tensor) for leaf in tree_leaves(theta)
    )


def stack_param_tree(theta0, n: int, stacked: bool | None = None):
    """(template, stacked_tree) for a tree chain entry.

    Leaves that already carry a leading ``n`` axis are taken as per-chain
    states (``stacked`` overrides the detection when a single-chain leaf's
    first dim happens to equal ``n``); otherwise the single state is copied
    to ``n`` chains.
    """
    theta0 = tree_map(torch.as_tensor, theta0)
    leaves = tree_leaves(theta0)
    if stacked is None:
        stacked = all(leaf.shape[:1] == (n,) for leaf in leaves)
    if stacked:
        return tree_map(lambda leaf: leaf[0], theta0), theta0
    return theta0, tree_map(
        lambda leaf: leaf.unsqueeze(0).expand((n,) + tuple(leaf.shape)).clone(),
        theta0,
    )
