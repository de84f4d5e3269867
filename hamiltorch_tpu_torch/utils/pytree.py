"""Parameter trees: nested dicts, lists and tuples of tensors.

Counterpart of ``hamiltorch_tpu/utils/pytree.py``.  A parameter tree here
is what JAX calls a pytree: dicts, lists and tuples (named tuples
included), nested in any mix, whose leaves are tensors; ``None`` is an
empty subtree.  Leaf order is JAX's: sequences in order, dicts by sorted
key, so the flagship's ``{w1, b1, w2, b2}`` ravels as ``b1, b2, w1, w2``.
Mass operators draw one flat normal and split it in this order, so a tree
chain and the JAX package's tree chain see the same momentum for the same
flat draw.  Rebuilt trees keep each container's type (a tuple stays a
tuple); dicts come back with their keys in sorted order, as in JAX.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Callable, Tuple

import torch


def _children(node):
    """(kind, keys or None, children) of a container node, or None for a leaf."""
    if isinstance(node, Mapping):
        keys = sorted(node)
        return dict, keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node), None, list(node)
    return None


def _rebuild(kind, keys, children):
    if keys is not None:
        return dict(zip(keys, children))
    if hasattr(kind, "_fields"):  # a named tuple takes its fields as arguments
        return kind(*children)
    return kind(children)


def tree_leaves(tree) -> list:
    """Leaves of ``tree`` in JAX's order (a bare tensor is one leaf; None has none)."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[2] for leaf in tree_leaves(child)]


def tree_structure(tree):
    """A hashable description of ``tree``'s containers (leaves as ``"*"``):
    two trees have equal structures exactly when JAX's treedefs are equal."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return "*"
    kind, keys, children = node
    return (kind, None if keys is None else tuple(keys), tuple(tree_structure(c) for c in children))


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure; containers
    keep their type."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    kind, keys, children = node
    if keys is not None:
        others = [[r[k] for k in keys] for r in rest]
    else:
        others = [list(r) for r in rest]
    return _rebuild(kind, keys, [
        tree_map(fn, child, *(o[i] for o in others)) for i, child in enumerate(children)
    ])


def tree_unflatten_like(template, leaves) -> Any:
    """Build a tree shaped like ``template`` from leaves in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def ravel_pytree_fn(params) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Ravel ``params`` to a flat vector; returns (flat, unravel_fn).

    Leaves are flattened row-major and concatenated in leaf order, the
    order of the JAX package's ``ravel_pytree``.
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
    """True when ``theta`` is a parameter tree, not a flat vector.

    As in the JAX package: tensors, arrays and plain sequences of Python
    scalars are flat (``torch.as_tensor`` takes them); a container holding
    an array leaf, 0-d included, is a tree.
    """
    if isinstance(theta, torch.Tensor) or hasattr(theta, "__array_interface__"):
        return False
    leaves = tree_leaves(theta)
    if len(leaves) == 1 and leaves[0] is theta:
        return False
    return any(hasattr(leaf, "ndim") for leaf in leaves)


def stack_param_tree(theta0, n: int, key=None, noise: float = 0.0,
                     stacked: bool | None = None):
    """(template, stacked_tree) for a tree chain entry.

    Leaves that already carry a leading ``n`` axis are taken as per-chain
    states (``stacked`` overrides the detection when a single-chain leaf's
    first dim happens to equal ``n``); otherwise the single state is copied
    to ``n`` chains.  With ``noise > 0`` each copy is spread by
    ``noise * N(0, 1)``, leaf by leaf in leaf order (ChEES's cross-chain
    criterion needs distinct starting points).  ``key`` is an integer seed
    or a ``torch.Generator``; the normals are drawn on the generator's
    device (the CPU for a seed), so a seed gives the same spread on every
    device.
    """
    theta0 = tree_map(torch.as_tensor, theta0)
    leaves = tree_leaves(theta0)
    if stacked is None:
        stacked = all(leaf.shape[:1] == (n,) for leaf in leaves)
    if stacked:
        return tree_map(lambda leaf: leaf[0], theta0), theta0
    if noise > 0.0:
        if key is None:
            raise ValueError("stack_param_tree: noise > 0 needs a key")
        gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))

        def spread(leaf):
            z = torch.randn((n,) + tuple(leaf.shape), generator=gen, dtype=leaf.dtype,
                            device=gen.device)
            return leaf.unsqueeze(0) + noise * z.to(leaf.device)

        return theta0, tree_map(spread, theta0)
    return theta0, tree_map(
        lambda leaf: leaf.unsqueeze(0).expand((n,) + tuple(leaf.shape)).clone(),
        theta0,
    )


def param_sizes(params) -> list[int]:
    """Number of elements per leaf, in leaf order."""
    return [leaf.numel() for leaf in tree_leaves(params)]


def param_shapes(params) -> list[tuple]:
    """Shape of each leaf, in leaf order."""
    return [tuple(leaf.shape) for leaf in tree_leaves(params)]


def reject_param_tree(theta, entry_point: str, why: str, alternative: str) -> None:
    """Raise a uniform TypeError when a flat-layout-only entry point
    receives a parameter tree."""
    if is_param_tree(theta):
        raise TypeError(
            f"{entry_point} takes a flat (D,) theta0 — {why}.  Ravel the "
            f"tree (utils.pytree.ravel_pytree_fn) or {alternative}."
        )
