"""Mass-matrix operators.

Counterpart of ``hamiltorch_tpu/ops/mass.py``.  Each operator has three
methods on ONE chain's momentum (the samplers ``torch.func.vmap`` them over
chains):

* ``sample(z)``   -> momentum ~ N(0, M), from a flat standard normal ``z``
* ``velocity(p)`` -> M^{-1} p           (the leapfrog drift direction)
* ``kinetic(p)``  -> 0.5 p^T M^{-1} p

``sample`` takes the standard normal instead of a key: the driver draws
``z`` for every chain from that chain's own generator (``utils/rng.py``)
outside any ``vmap``, and the tests hand in the JAX package's own draw.
Dense factors (the Cholesky of M) are computed once at construction.

``BlockDiagMass`` is not ported yet (see ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.pytree import tree_leaves, tree_map, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class IdentityMass:
    """M = I."""

    dim: int

    def sample(self, z):
        return z

    def velocity(self, p):
        return p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, p)


@dataclasses.dataclass(frozen=True)
class DiagMass:
    """Diagonal mass given by its *inverse* diagonal (covariance scale)."""

    inv_diag: torch.Tensor

    def sample(self, z):
        return z * torch.rsqrt(self.inv_diag.to(z.dtype))

    def velocity(self, p):
        return self.inv_diag * p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, self.inv_diag * p)


@dataclasses.dataclass(frozen=True)
class DenseMass:
    """Dense mass: ``inv_mass`` plus the Cholesky factor of M = inv_mass^-1."""

    inv_mass: torch.Tensor
    chol_mass: torch.Tensor

    @staticmethod
    def from_inv_mass(inv_mass: torch.Tensor) -> "DenseMass":
        mass = torch.linalg.inv(inv_mass)
        # symmetrize before factoring to absorb inversion round-off
        mass = 0.5 * (mass + mass.T)
        return DenseMass(inv_mass=inv_mass, chol_mass=torch.linalg.cholesky(mass))

    def sample(self, z):
        return self.chol_mass.to(z.dtype) @ z

    def velocity(self, p):
        return self.inv_mass @ p

    def kinetic(self, p):
        return 0.5 * torch.dot(p, self.inv_mass @ p)


MassOperator = IdentityMass | DiagMass | DenseMass


def tree_ravel(tree) -> torch.Tensor:
    """Concatenate a tree's leaves into one flat vector (sorted-key order)."""
    leaves = tree_leaves(tree)
    if len(leaves) == 1 and leaves[0].ndim == 1:
        return leaves[0]
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


@dataclasses.dataclass(frozen=True)
class TreeMass:
    """Mass operator over a parameter tree.

    Momentum is drawn as ONE flat normal and split into the leaves in
    sorted-key order, and kinetic energies reduce over the concatenated
    flat vector, as in the JAX package.  ``inv_diag_tree`` holds the
    per-leaf inverse-mass diagonal for a diagonal inner operator (leafwise
    drift); a dense inner operator drifts through a ravel round trip.
    """

    inner: MassOperator
    inv_diag_tree: object  # tree of per-leaf inverse diagonals, or None
    template: object  # the single-chain parameter tree (shapes only)

    def _unravel(self, flat: torch.Tensor):
        parts, off = [], 0
        for leaf in tree_leaves(self.template):
            n = leaf.numel()
            parts.append(flat[off : off + n].reshape(leaf.shape))
            off += n
        return tree_unflatten_like(self.template, parts)

    def sample(self, z):
        return self._unravel(self.inner.sample(z))

    def velocity(self, p):
        if self.inv_diag_tree is not None:
            return tree_map(lambda d, x: d * x, self.inv_diag_tree, p)
        if isinstance(self.inner, IdentityMass):
            return p
        return self._unravel(self.inner.velocity(tree_ravel(p)))

    def kinetic(self, p):
        return self.inner.kinetic(tree_ravel(p))


def make_mass_tree(inv_mass, params_template) -> TreeMass:
    """Build a TreeMass for a parameter tree.

    ``inv_mass`` may be None (identity), a flat (D,) diagonal, a tree of
    per-leaf diagonals matching ``params_template``, or a dense (D, D)
    matrix.
    """
    leaves = tree_leaves(params_template)
    dim = sum(leaf.numel() for leaf in leaves)
    if isinstance(inv_mass, dict):
        if sorted(inv_mass) != sorted(params_template):
            raise ValueError("a tree inv_mass must have the parameters' keys")
        inner = make_mass(tree_ravel(inv_mass), dim)
        return TreeMass(inner=inner, inv_diag_tree=inv_mass, template=params_template)
    inner = make_mass(inv_mass, dim)
    inv_diag_tree = None
    if isinstance(inner, DiagMass):
        parts, off = [], 0
        for leaf in leaves:
            parts.append(inner.inv_diag[off : off + leaf.numel()].reshape(leaf.shape))
            off += leaf.numel()
        inv_diag_tree = tree_unflatten_like(params_template, parts)
    return TreeMass(inner=inner, inv_diag_tree=inv_diag_tree, template=params_template)


def make_mass(inv_mass, dim: int) -> MassOperator:
    """Build an operator from the reference's ``inv_mass`` convention.

    None -> identity; (D,) -> diagonal; (D, D) -> dense.  A list of blocks
    (block-diagonal) is not ported yet and raises.
    """
    if inv_mass is None:
        return IdentityMass(dim=dim)
    if isinstance(inv_mass, (list, tuple)):
        raise NotImplementedError(
            "block-diagonal inv_mass (BlockDiagMass) is not ported yet; "
            "see ROADMAP.md, queue 1"
        )
    inv_mass = torch.as_tensor(inv_mass)
    if inv_mass.shape[0] != dim:
        raise ValueError(f"inv_mass has dim {inv_mass.shape[0]}, params have {dim}")
    if inv_mass.ndim == 1:
        return DiagMass(inv_diag=inv_mass)
    if inv_mass.ndim == 2:
        return DenseMass.from_inv_mass(inv_mass)
    raise ValueError(
        f"inv_mass must be None, 1-d or 2-d; got ndim={inv_mass.ndim}"
    )
